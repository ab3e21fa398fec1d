"""Global-alignment CIGAR + NM/MD generation.

Contract: bwa_gen_cigar2 (bwalib/bwa.c:147-233).  For reverse-strand hits
both query and reference window are reversed before the DP so indels are
left-aligned in SAM orientation; the MD tag uses the complement base table.
"""

from __future__ import annotations

import numpy as np

from compseed_tpu_torch.cpu import ksw
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.options import MemOptions


def gen_cigar(opt: MemOptions, fm: FMIndex, w_: int, query: np.ndarray,
              rb: int, re: int, want_cigar: bool = True):
    """Returns (score, cigar [(op,len)], NM, MD) or None when rejected.

    `query` is the nt4-encoded query segment (qb..qe of the read).
    """
    l_query = len(query)
    l_pac = fm.l_pac
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = fm.get_seq(rb, re)
    if re - rb != len(rseq):
        return None
    if rb >= l_pac:  # reverse both so indels left-align in SAM orientation
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    mat = np.array(opt.mat)
    if l_query == re - rb and w_ == 0:  # no-gap shortcut (bwa.c:167-175)
        cigar = [(0, l_query)] if want_cigar else []
        mat5 = mat.reshape(5, 5)
        score = int(mat5[rseq.astype(np.int64), query.astype(np.int64)].sum())
    else:
        rlen = int(re - rb)
        max_ins = int((((l_query + 1) >> 1) * opt.mat[0] - opt.o_ins)
                      / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * opt.mat[0] - opt.o_del)
                      / opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        w = (max_gap + abs(rlen - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs(rlen - l_query) + 3
        w = max(w, min_w)
        score, cigar = ksw.global_align(l_query, query, rlen, rseq, mat,
                                        opt.o_del, opt.e_del, opt.o_ins,
                                        opt.e_ins, w, want_cigar)
    NM = -1
    MD = ""
    if want_cigar:
        n_mm = n_gap = 0
        int2base = "ACGTN" if rb < l_pac else "TGCAN"
        x = y = u = 0
        md_parts: list[str] = []
        n_cigar = len(cigar)
        for k_i, (op, ln) in enumerate(cigar):
            if op == 0:  # match run
                for i in range(ln):
                    if query[x + i] != rseq[y + i]:
                        md_parts.append(str(u))
                        md_parts.append(int2base[int(rseq[y + i])])
                        n_mm += 1
                        u = 0
                    else:
                        u += 1
                x += ln
                y += ln
            elif op == 2:  # deletion
                if 0 < k_i < n_cigar - 1:
                    md_parts.append(str(u))
                    md_parts.append("^")
                    md_parts.extend(int2base[int(rseq[y + i])]
                                    for i in range(ln))
                    u = 0
                    n_gap += ln
                y += ln
            elif op == 1:  # insertion
                x += ln
                n_gap += ln
        md_parts.append(str(u))
        MD = "".join(md_parts)
        NM = n_mm + n_gap
    return score, cigar, NM, MD
