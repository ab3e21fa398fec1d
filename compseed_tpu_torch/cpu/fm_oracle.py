"""Scalar FMD-index query oracle.

Direct, unoptimized implementations of the reference BWT query semantics
(FM_index/bwt.c), used as the ground truth for the batched device kernels in
``compseed_tpu_torch.ops`` and by the oracle aligner in tests.  Every function
documents its contract with file:line of the reference.
"""

from __future__ import annotations

import numpy as np

from compseed_tpu_torch.index.fmindex import FMIndex

NEG1 = (1 << 64) - 1  # bwtint_t(-1)


def bwt_b0(fm: FMIndex, k: int) -> int:
    """Base at position k of the $-removed BWT (bwt_B0, bwt.h:80)."""
    word = int(fm.bwt_words[k >> 7, (k & 0x7F) >> 4])
    return (word >> ((~k & 0xF) << 1)) & 3


def occ4(fm: FMIndex, k: int) -> np.ndarray:
    """Counts of each base in BWT[0..k] inclusive (adjusted for $).

    Contract: bwt_occ4 (FM_index/bwt.c:169-186); k may be -1 (NEG1).
    """
    cnt = np.zeros(4, dtype=np.int64)
    if k == NEG1 or k == -1:
        return cnt
    k = k - 1 if k >= fm.primary else k  # $ is not in the BWT
    cnt += fm.cp_occ[k >> 7].astype(np.int64)
    block = fm.bwt_words[k >> 7]
    w_end = (k & 0x7F) >> 4  # number of full words before the partial word
    for w in range(w_end):
        cnt += _count_word(int(block[w]), 16)
    cnt += _count_word(int(block[w_end]), (k & 0xF) + 1)
    return cnt


def _count_word(word: int, n_bases: int) -> np.ndarray:
    """Count bases among the first n_bases 2-bit fields of a packed word."""
    out = np.zeros(4, dtype=np.int64)
    for i in range(n_bases):
        out[(word >> ((15 - i) << 1)) & 3] += 1
    return out


def occ(fm: FMIndex, k: int, c: int) -> int:
    """Occ(k, c) — count of c in BWT[0..k] (bwt_occ, FM_index/bwt.c:107-129)."""
    if k == fm.seq_len:
        return int(fm.L2[c + 1] - fm.L2[c])
    if k == NEG1 or k == -1:
        return 0
    return int(occ4(fm, k)[c])


def invPsi(fm: FMIndex, k: int) -> int:
    """One LF step (bwt_invPsi, FM_index/bwt.c:53-59)."""
    x = k - (1 if k > fm.primary else 0)
    c = bwt_b0(fm, x)
    x = int(fm.L2[c]) + occ(fm, k, c)
    return 0 if k == fm.primary else x


def sa_lookup(fm: FMIndex, k: int) -> int:
    """SA[k] via inverse-Psi walk to a sampled slot (bwt_sa, bwt.c:86-96).

    sa_sampled[0] stores -1 so plain addition is exact even when the walk
    wraps through row 0 (bwt_cal_sa, bwt.c:83).
    """
    sa = 0
    mask = fm.sa_intv - 1
    while k & mask:
        sa += 1
        k = invPsi(fm, k)
    return sa + int(fm.sa_sampled[k // fm.sa_intv].astype(np.int64))


def set_intv(fm: FMIndex, c: int) -> np.ndarray:
    """Initial bi-interval of a single base (bwt_set_intv, bwt.h:82)."""
    return np.array([int(fm.L2[c]) + 1,
                     int(fm.L2[3 - c]) + 1,
                     int(fm.L2[c + 1] - fm.L2[c])], dtype=np.int64)


def extend(fm: FMIndex, ik: np.ndarray, is_back: int) -> np.ndarray:
    """Bidirectional extension: 4 child bi-intervals.

    ik = [k, l, s] (bwtintv_t.x); returns (4, 3) array indexed by base.
    Contract: bwt_extend (FM_index/bwt.c:262-275).
    """
    fwd = 0 if is_back else 1  # the coordinate being searched (x[!is_back])
    bwd = 1 - fwd
    tk = occ4(fm, int(ik[fwd]) - 1)
    tl = occ4(fm, int(ik[fwd]) - 1 + int(ik[2]))
    ok = np.zeros((4, 3), dtype=np.int64)
    for i in range(4):
        ok[i, fwd] = int(fm.L2[i]) + 1 + tk[i]
        ok[i, 2] = tl[i] - tk[i]
    contains_primary = int(ik[fwd] <= fm.primary <= ik[fwd] + ik[2] - 1)
    ok[3, bwd] = ik[bwd] + contains_primary
    ok[2, bwd] = ok[3, bwd] + ok[3, 2]
    ok[1, bwd] = ok[2, bwd] + ok[2, 2]
    ok[0, bwd] = ok[1, bwd] + ok[1, 2]
    return ok


def collect_mem(fm: FMIndex, q: np.ndarray, pivot: int, min_hits: int):
    """SMEMs covering `pivot`; returns (mems, ret_pivot).

    mems entries: (k, l, s, beg, end), sorted by start coordinate.
    Contract: collect_mem_with_sst (mapping/comp_seed.cpp:67-139), which is
    bwt_smem1a (FM_index/bwt.c:289-351 with max_intv=0) plus memoization and
    a fast path for pivot==0; results are identical by construction.
    """
    length = len(q)
    mems: list[tuple[int, int, int, int, int]] = []
    if q[pivot] > 3:
        return mems, pivot + 1
    min_hits = max(min_hits, 1)

    # --- forward sweep collecting LEP intervals (comp_seed.cpp:76-97)
    prev: list[tuple[np.ndarray, int]] = []  # (ik, end)
    ik = set_intv(fm, int(q[pivot]))
    end = pivot + 1
    ret_pivot = length
    i = pivot + 1
    while i < length:
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = extend(fm, ik, 0)
            if ok[c, 2] != ik[2]:
                prev.append((ik.copy(), end))
                if ok[c, 2] < min_hits:
                    ret_pivot = i
                    break
            ik = ok[c].copy()
            end = i + 1
        else:
            prev.append((ik.copy(), end))
            ret_pivot = i + 1
            break
        i += 1
    if ret_pivot == length:
        prev.append((ik.copy(), end))

    if pivot == 0:  # full-prefix match: only the longest match is an SMEM
        k_, l_, s_ = prev[-1][0]
        mems.append((int(k_), int(l_), int(s_), 0, prev[-1][1]))
        return mems, ret_pivot

    prev.reverse()  # longest match (smallest interval) first

    # --- backward shrink (comp_seed.cpp:114-137)
    i = pivot - 1
    while i >= -1:
        c = int(q[i]) if (i >= 0 and q[i] < 4) else -1
        curr: list[tuple[np.ndarray, int]] = []
        for p_ik, p_end in prev:
            okc = extend(fm, p_ik, 1)[c] if c >= 0 else None
            if c < 0 or okc[2] < min_hits:
                if not curr:
                    if not mems or i + 1 < mems[-1][3]:
                        mems.append((int(p_ik[0]), int(p_ik[1]), int(p_ik[2]),
                                     i + 1, p_end))
            elif not curr or okc[2] != curr[-1][0][2]:
                curr.append((okc.copy(), p_end))
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()
    return mems, ret_pivot


def seed_strategy1(fm: FMIndex, q: np.ndarray, x: int, min_len: int,
                   max_intv: int):
    """3rd-round greedy seeding (bwt_seed_strategy1, FM_index/bwt.c:358-379
    == tem_forward_sst, mapping/comp_seed.cpp:141-160).

    Returns (mem or None, next_x); mem = (k, l, s, beg, end)."""
    length = len(q)
    if q[x] > 3:
        return None, x + 1
    ik = set_intv(fm, int(q[x]))
    for i in range(x + 1, length):
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = extend(fm, ik, 0)
            if ok[c, 2] < max_intv and i - x >= min_len:
                return (int(ok[c, 0]), int(ok[c, 1]), int(ok[c, 2]), x, i + 1), i + 1
            ik = ok[c].copy()
        else:
            return None, i + 1
    return None, length


def smem1a(fm: FMIndex, q: np.ndarray, x: int, min_intv: int,
           max_intv: int):
    """Full bwt_smem1a (FM_index/bwt.c:289-351): SMEMs covering x with the
    min_intv / max_intv knobs of the iterator API.

    Returns (mems, ret) where mems entries are (k, l, s, beg, end) sorted
    by start coordinate.  Reproduces the reference's quirk of testing the
    loop-carried ``ik`` interval size against max_intv during the
    backward pass.
    """
    length = len(q)
    if q[x] > 3:
        return [], x + 1
    min_intv = max(min_intv, 1)
    ik = set_intv(fm, int(q[x]))
    ik_info = x + 1
    curr: list[tuple[np.ndarray, int]] = []
    i = x + 1
    while i < length:
        if max_intv and ik[2] < max_intv:
            curr.append((ik.copy(), ik_info))
            break
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = extend(fm, ik, 0)
            if ok[c, 2] != ik[2]:
                curr.append((ik.copy(), ik_info))
                if ok[c, 2] < min_intv:
                    break
            ik = ok[c].copy()
            ik_info = i + 1
        else:
            curr.append((ik.copy(), ik_info))
            break
        i += 1
    if i == length:
        curr.append((ik.copy(), ik_info))
    curr.reverse()
    ret = curr[0][1]
    prev = curr
    mems: list[tuple[int, int, int, int, int]] = []
    i = x - 1
    while i >= -1:
        c = -1 if (i < 0 or q[i] > 3) else int(q[i])
        curr = []
        for p_ik, p_end in prev:
            okc = None
            if c >= 0 and ik[2] >= max_intv:
                okc = extend(fm, p_ik, 1)[c]
            if c < 0 or (max_intv and ik[2] < max_intv) or \
                    (okc is not None and okc[2] < min_intv) or okc is None:
                if not curr:
                    if not mems or i + 1 < mems[-1][3]:
                        ik = p_ik.copy()
                        mems.append((int(p_ik[0]), int(p_ik[1]),
                                     int(p_ik[2]), i + 1, p_end))
            elif not curr or okc[2] != curr[-1][0][2]:
                curr.append((okc.copy(), p_end))
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()
    return mems, ret
