"""Alignment finalization: dedup/patch, mapQ, primary marking, SAM records.

Contracts (mapping/comp_seed.cpp): mem_patch_reg :599, mem_sort_dedup_patch
:629, mem_approx_mapq_se :686, mem_mark_primary_se(_core) :711/:738,
mem_reorder_primary5 :776, infer_bw/mem_reg2aln :803/:811, mem_aln2sam
:904, mem_gen_alt :1034, mem_reg2sam :1079.
"""

from __future__ import annotations

import math

import numpy as np

from compseed_tpu_torch.cpu.sort import ks_introsort
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.options import (
    MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI, MEM_F_REF_HDR,
    MEM_F_SOFTCLIP, MemOptions,
)
from compseed_tpu_torch.pipeline.cigar import gen_cigar
from compseed_tpu_torch.pipeline.types import Aln, AlnReg
from compseed_tpu_torch.utils import NT4_TO_ASCII, NT4_TO_ASCII_COMP, hash_64

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90
INT_MAX = 2**31 - 1
CIGAR_OPS = "MIDSH"
CIGAR_OPS_N = "MIDSHN"


def mem_patch_reg(opt: MemOptions, fm: FMIndex, query: np.ndarray,
                  a: AlnReg, b: AlnReg):
    """Try to merge colinear split hits; returns (score, w) or None.
    Contract: comp_seed.cpp:599-627."""
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < fm.l_pac <= b.rb:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None  # not colinear
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap
        if w > opt.w * 2 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.w * 4 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += a.w + b.w
    w = min(w, opt.w * 4)
    res = gen_cigar(opt, fm, w, query[a.qb: b.qe], a.rb, b.re,
                    want_cigar=False)
    if res is None:
        return None
    score = res[0]
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return score, w


def mem_sort_dedup_patch(opt: MemOptions, fm: FMIndex, query: np.ndarray,
                         regs: list[AlnReg]) -> list[AlnReg]:
    """comp_seed.cpp:629-680."""
    n = len(regs)
    if n <= 1:
        return regs
    a = regs
    ks_introsort(a, lambda x, y: x.re < y.re)  # sort by END position
    for r in a:
        r.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and \
                p.rb < a[j].re + opt.max_chain_gap:
            q = a[j]
            j -= 1
            if q.qe == q.qb:
                continue  # excluded
            o_r = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if o_r > opt.mask_level_redun * mr and \
                    oq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                q.qe = q.qb
            elif q.rb < p.rb:
                patched = mem_patch_reg(opt, fm, query, q, p)
                if patched is not None and patched[0] > 0:
                    score, w = patched
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [r for r in a if r.qe > r.qb]
    ks_introsort(a, _alnreg_slt)
    for i in range(1, len(a)):
        if a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb and \
                a[i].qb == a[i - 1].qb:
            a[i].qe = a[i].qb
    out = a[:1] + [r for r in a[1:] if r.qe > r.qb]
    return out


def _alnreg_slt(x: AlnReg, y: AlnReg) -> bool:
    """alnreg_slt (comp_seed.cpp:587)."""
    return x.score > y.score or (x.score == y.score and (
        x.rb < y.rb or (x.rb == y.rb and x.qb < y.qb)))


def mem_approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    """comp_seed.cpp:686-709."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    ln = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (ln * opt.a - a.score) / (opt.a + opt.b) / ln
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if ln < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(ln)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(30.0 * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        mapq = int(mapq * identity * identity + 0.499) if identity < 0.95 else mapq
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


def _mark_primary_core(opt: MemOptions, a: list[AlnReg], n: int) -> None:
    """comp_seed.cpp:711-736 (operates on a[:n])."""
    tmp = opt.a + opt.b
    tmp = max(tmp, opt.o_del + opt.e_del)
    tmp = max(tmp, opt.o_ins + opt.e_ins)
    z: list[int] = [0]
    for i in range(1, n):
        placed = False
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if a[k].score - a[i].score <= tmp and \
                            (a[k].is_alt or not a[i].is_alt):
                        a[k].sub_n += 1
                    a[i].secondary = k
                    placed = True
                    break
        if not placed:
            z.append(i)


def mem_mark_primary_se(opt: MemOptions, regs: list[AlnReg],
                        read_id: int) -> int:
    """comp_seed.cpp:738-774."""
    n = len(regs)
    if n == 0:
        return 0
    n_pri = 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(read_id + i)
        if not r.is_alt:
            n_pri += 1
    ks_introsort(regs, lambda x, y: x.score > y.score or (
        x.score == y.score and (x.is_alt < y.is_alt or (
            x.is_alt == y.is_alt and x.hash < y.hash))))
    _mark_primary_core(opt, regs, n)
    for i, p in enumerate(regs):
        p.secondary_all = i  # rank in the first round
        if not p.is_alt and p.secondary >= 0 and regs[p.secondary].is_alt:
            p.alt_sc = regs[p.secondary].score
    if n_pri < n:
        z = [0] * n
        if n_pri > 0:
            ks_introsort(regs, lambda x, y: x.is_alt < y.is_alt or (
                x.is_alt == y.is_alt and (x.score > y.score or (
                    x.score == y.score and x.hash < y.hash))))
        for i, r in enumerate(regs):
            z[r.secondary_all] = i
        for r in regs:
            if r.secondary >= 0:
                r.secondary_all = z[r.secondary]
                if r.is_alt:
                    r.secondary = INT_MAX
            else:
                r.secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs, n_pri)
    else:
        for r in regs:
            r.secondary_all = r.secondary
    return n_pri


def mem_reorder_primary5(T: int, regs: list[AlnReg]) -> None:
    """comp_seed.cpp:776-797."""
    n_pri = sum(1 for r in regs
                if r.secondary < 0 and not r.is_alt and r.score >= T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(regs):
        if p.secondary >= 0 or p.is_alt or p.score < T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    assert regs[0].secondary < 0
    if left_k == 0:
        return
    regs[0], regs[left_k] = regs[left_k], regs[0]
    for k in range(1, len(regs)):
        p = regs[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """comp_seed.cpp:803-809."""
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def mem_reg2aln(opt: MemOptions, fm: FMIndex, l_query: int,
                query: np.ndarray, ar: AlnReg | None) -> Aln:
    """comp_seed.cpp:811-880."""
    a = Aln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        # memset-zero record + unmapped flag (comp_seed.cpp:817-821)
        a.rid, a.pos, a.flag = -1, -1, 0x4
        a.NM = 0
        a.sub = 0
        a.score = 0
        a.alt_sc = 0
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = mem_approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    i = 0
    last_sc = -(1 << 30)
    while True:
        w2 = min(w2, opt.w * 4)
        res = gen_cigar(opt, fm, w2, query[qb:qe], rb, re)
        score, cigar, NM, MD = res
        if score == last_sc or w2 == opt.w * 4:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.cigar = list(cigar)
    a.NM = NM
    a.MD = MD
    pos, is_rev = fm.depos(rb if rb < fm.l_pac else re - 1)
    a.is_rev = int(is_rev)
    if a.cigar:  # squeeze out leading or trailing deletions (bwa.c-style)
        if a.cigar[0][0] == 2:
            pos += a.cigar[0][1]
            a.cigar = a.cigar[1:]
        elif a.cigar[-1][0] == 2:
            a.cigar = a.cigar[:-1]
    if qb != 0 or qe != l_query:  # add clipping
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            a.cigar = [(3, clip5)] + a.cigar
        if clip3:
            a.cigar = a.cigar + [(3, clip3)]
    a.rid = fm.pos2rid(pos)
    assert a.rid == ar.rid
    a.pos = pos - fm.bns.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


def _get_rlen(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


def _cigar_str(opt: MemOptions, p: Aln, which: int) -> str:
    """add_cigar (comp_seed.cpp:892-902)."""
    if not p.cigar:
        return "*"
    out = []
    for op, ln in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{CIGAR_OPS[c]}")
    return "".join(out)


def mem_aln2sam(opt: MemOptions, fm: FMIndex, name: str, seq: np.ndarray,
                qual: str | None, comment: str | None, n: int,
                alns: list[Aln], which: int, m: Aln | None = None,
                rg_id: str = "") -> str:
    """One SAM record; contract: mem_aln2sam (comp_seed.cpp:904-1024)."""
    p = alns[which]
    flag = p.flag
    flag |= 0x1 if m else 0
    flag |= 0x4 if p.rid < 0 else 0
    flag |= 0x8 if (m and m.rid < 0) else 0
    # (mate copy logic applies to PE only; SE passes m=None)
    flag |= 0x10 if p.is_rev else 0
    flag |= 0x20 if (m and m.is_rev) else 0
    out = [name, "\t", str((flag & 0xFFFF) | (0x100 if flag & 0x10000 else 0))]
    if p.rid >= 0:
        out += ["\t", fm.bns.anns[p.rid].name, "\t", str(p.pos + 1),
                "\t", str(p.mapq), "\t", _cigar_str(opt, p, which)]
    else:
        out += ["\t*\t0\t0\t*"]
    if m and m.rid >= 0:
        rn = "=" if p.rid == m.rid else fm.bns.anns[m.rid].name
        out += ["\t", rn, "\t", str(m.pos + 1), "\t"]
        if p.rid == m.rid:
            p0 = p.pos + (_get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (_get_rlen(m.cigar) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                out.append("0")
            else:
                out.append(str(-(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))))
        else:
            out.append("0")
    else:
        out += ["\t*\t0\t0"]
    out.append("\t")
    l_seq = len(seq)
    if flag & 0x100:
        out.append("*\t*")
    else:
        qb, qe = 0, l_seq
        if p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt:
            if not p.is_rev:
                if p.cigar[0][0] in (3, 4):
                    qb += p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qe -= p.cigar[-1][1]
            else:
                if p.cigar[0][0] in (3, 4):
                    qe -= p.cigar[0][1]
                if p.cigar[-1][0] in (3, 4):
                    qb += p.cigar[-1][1]
        if not p.is_rev:
            out.append(bytes(NT4_TO_ASCII[seq[qb:qe]]).decode())
            out.append("\t")
            out.append(qual[qb:qe] if qual else "*")
        else:
            out.append(bytes(NT4_TO_ASCII_COMP[seq[qb:qe][::-1]]).decode())
            out.append("\t")
            out.append(qual[qb:qe][::-1] if qual else "*")
    if p.cigar:
        out += ["\tNM:i:", str(p.NM), "\tMD:Z:", p.MD]
    if m and m.cigar:
        out += ["\tMC:Z:", _cigar_str(opt, m, which)]
    if p.score >= 0:
        out += ["\tAS:i:", str(p.score)]
    if p.sub >= 0:
        out += ["\tXS:i:", str(p.sub)]
    if rg_id:
        out += ["\tRG:Z:", rg_id]
    if not (flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            out.append("\tSA:Z:")
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{CIGAR_OPS[op]}" for op, ln in r.cigar)
                out.append(f"{fm.bns.anns[r.rid].name},{r.pos + 1},"
                           f"{'-' if r.is_rev else '+'},{cig},{r.mapq},{r.NM};")
        if p.alt_sc > 0:
            out.append(f"\tpa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        out += ["\tXA:Z:", p.XA]
    if comment:
        out += ["\t", comment]
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and \
            fm.bns.anns[p.rid].anno and fm.bns.anns[p.rid].anno != "(null)":
        out += ["\tXR:Z:", fm.bns.anns[p.rid].anno.replace("\t", " ")]
    out.append("\n")
    return "".join(out)


def _get_pri_idx(xa_drop: float, a: list[AlnReg], i: int) -> int:
    k = a[i].secondary_all
    if k >= 0 and a[i].score >= a[k].score * xa_drop:
        return k
    return -1


def mem_gen_alt(opt: MemOptions, fm: FMIndex, regs: list[AlnReg],
                l_query: int, query: np.ndarray) -> list[str | None]:
    """XA strings per region (comp_seed.cpp:1034-1076)."""
    n = len(regs)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    XA: list[str | None] = [None] * n
    if tot == 0:
        return XA
    aln_strs: list[list[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or \
                (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        t = mem_reg2aln(opt, fm, l_query, query, regs[i])
        cig = "".join(f"{ln}{CIGAR_OPS_N[op]}" for op, ln in t.cigar)
        aln_strs[r].append(
            f"{fm.bns.anns[t.rid].name},{'-' if t.is_rev else '+'}"
            f"{t.pos + 1},{cig},{t.NM};")
    for k in range(n):
        if aln_strs[k]:
            XA[k] = "".join(aln_strs[k])
    return XA


def mem_reg2sam(opt: MemOptions, fm: FMIndex, name: str, seq: np.ndarray,
                qual: str | None, comment: str | None, regs: list[AlnReg],
                extra_flag: int = 0, m: Aln | None = None,
                rg_id: str = "") -> str:
    """comp_seed.cpp:1079-1123."""
    l_seq = len(seq)
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = mem_gen_alt(opt, fm, regs, l_seq, seq)
    aa: list[Aln] = []
    keep_k: list[int] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if 0 <= p.secondary < INT_MAX and \
                p.score < regs[p.secondary].score * opt.drop_ratio:
            continue
        q = mem_reg2aln(opt, fm, l_seq, seq, p)
        assert q.rid >= 0
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output sub-optimal score
        if aa and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and aa and not p.is_alt \
                and q.mapq > aa[0].mapq:
            q.mapq = aa[0].mapq
        aa.append(q)
        keep_k.append(k)
    if not aa:
        t = mem_reg2aln(opt, fm, l_seq, seq, None)
        t.flag |= extra_flag
        return mem_aln2sam(opt, fm, name, seq, qual, comment, 1, [t], 0, m,
                           rg_id)
    return "".join(
        mem_aln2sam(opt, fm, name, seq, qual, comment, len(aa), aa, k, m,
                    rg_id)
        for k in range(len(aa)))
