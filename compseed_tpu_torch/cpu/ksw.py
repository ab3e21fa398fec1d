"""Smith-Waterman oracle kernels (host, numpy).

Exact reimplementations of the reference DP semantics:

  * ``extend``  — ksw_extend2 (bwalib/ksw.c:380-479), which is also exactly
    scalarBandedSWA (mapping/bandedSWA.cpp:116-237): seeded local extension
    with band, z-drop, to-end score (gscore) and max off-diagonal tracking.
  * ``global_align`` — ksw_global2 (bwalib/ksw.c:504-607): banded global NW
    with CIGAR traceback.
  * ``local_score`` — the score a striped SW (ksw_align2/ksw_i16,
    bwalib/ksw.c:232-334) returns; used by mem_seed_sw.

Rows loop in Python; columns are numpy-vectorized.  The F (gap-in-query)
recurrence is a max-plus prefix scan computed with cumulative maxima.
"""

from __future__ import annotations

import numpy as np

MINUS_INF = -0x40000000


def _row_f_scan(t: np.ndarray, e_ins: int, f0: int) -> np.ndarray:
    """F values entering each column: f[0]=f0, f[j+1]=max(t[j], f[j]-e_ins).

    Solved as f[j] = max(f0 - j*e, max_{j'<j}(t[j'] + j'*e) - (j-1)*e ... )
    via cumulative max of (t + idx*e).
    """
    n = len(t)
    f = np.empty(n, dtype=np.int64)
    f[0] = f0
    if n > 1:
        idx = np.arange(n - 1, dtype=np.int64)
        v = np.maximum.accumulate(t[:-1] + idx * e_ins)
        decay = f0 - (idx + 1) * e_ins
        f[1:] = np.maximum(v - idx * e_ins, decay)
    return f


def extend(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
           mat: np.ndarray, o_del: int, e_del: int, o_ins: int, e_ins: int,
           w: int, end_bonus: int, zdrop: int, h0: int):
    """Seeded extension alignment.

    Returns (score, qle, tle, gtle, gscore, max_off).
    Contract: ksw_extend2 (bwalib/ksw.c:380-479).
    """
    m = 5
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, query.astype(np.int64)]  # (m, qlen) query profile

    h = np.zeros(qlen + 1, dtype=np.int64)  # eh[].h
    e = np.zeros(qlen + 1, dtype=np.int64)  # eh[].e
    h[0] = h0
    if qlen >= 1:
        h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and h[j - 1] > e_ins:
            h[j] = h[j - 1] - e_ins
            j += 1

    # clamp the band (ksw.c:398-407)
    max_sc = int(mat.max())
    max_ins = max(int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0), 1)
    w = min(w, max_ins)
    max_del = max(int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0), 1)
    w = min(w, max_del)

    best = h0
    max_i = max_j = -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        h_first = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        if end <= beg:  # band emptied: C's inner loop runs zero times,
            # m stays 0 and the row loop breaks (ksw.c:454)
            h[end] = h_first
            e[end] = 0
            if end == qlen:
                h1 = h_first
                if gscore <= h1:
                    max_ie = i
                    gscore = max(gscore, h1)
            break
        # previous-row H(i-1, j-1) for j in [beg, end): diag values
        Hdiag = h[beg:end].copy()
        Eprev = e[beg:end].copy()
        q = qp[int(target[i]), beg:end]
        M = np.where(Hdiag != 0, Hdiag + q, 0)
        t_del = np.maximum(M - oe_del, 0)
        e_new = np.maximum(Eprev - e_del, t_del)
        t_ins = np.maximum(M - oe_ins, 0)
        f = _row_f_scan(t_ins, e_ins, 0)
        h_new = np.maximum(np.maximum(M, Eprev), f)
        # shift: eh[j].h becomes H(i, j-1); eh[end] gets {h1, 0}
        h[beg] = h_first
        h[beg + 1: end + 1] = h_new
        if end == beg:
            h[end] = h_first
        e[beg:end] = e_new
        e[end] = 0
        if end == qlen:
            h1 = int(h_new[-1]) if end > beg else h_first
            if gscore <= h1:
                max_ie = i
                gscore = max(gscore, h1)
        if end > beg:
            mrev = h_new[::-1]
            mmax = int(h_new.max())
            mj = beg + (end - beg - 1 - int(np.argmax(mrev)))
        else:
            mmax, mj = 0, -1
        if mmax == 0:
            break
        if mmax > best:
            best, max_i, max_j = mmax, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if best - mmax - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if best - mmax - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the band to the non-zero span (ksw.c:465-469):
        # forward scan over [beg, end), backward scan over [beg, end]
        nz = (h[beg:end] != 0) | (e[beg:end] != 0)
        beg = beg + int(np.argmax(nz)) if nz.any() else end
        nz2 = (h[beg:end + 1] != 0) | (e[beg:end + 1] != 0)
        if nz2.any():
            j = beg + (len(nz2) - 1 - int(np.argmax(nz2[::-1])))
        else:
            j = beg - 1
        end = min(j + 2, qlen)
    return best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def global_align(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
                 mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                 e_ins: int, w: int, want_cigar: bool = True):
    """Banded global alignment; returns (score, cigar list of (op, len)).

    op encoding: 0=M, 1=I (query), 2=D (ref) — BAM convention.
    Contract: ksw_global2 (bwalib/ksw.c:504-607).
    """
    m = 5
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, query.astype(np.int64)]

    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None

    h = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    e = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    h[0] = 0
    for j in range(1, min(qlen, w) + 1):
        h[j] = -(o_ins + e_ins * j)

    for i in range(tlen):
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h_first = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        Hdiag = h[beg:end].copy()
        Eprev = e[beg:end].copy()
        q = qp[int(target[i]), beg:end]
        M = Hdiag + q
        t_del = M - oe_del
        e_dec = Eprev - e_del
        e_new = np.maximum(e_dec, t_del)
        t_ins = M - oe_ins
        f = _row_f_scan(t_ins, e_ins, MINUS_INF)
        hm = np.where(M >= Eprev, M, Eprev)
        h_new = np.where(hm >= f, hm, f)
        if want_cigar:
            d = np.where(M >= Eprev, 0, 1).astype(np.uint8)
            d = np.where(hm >= f, d, 2).astype(np.uint8)
            d |= np.where(e_dec > t_del, 1 << 2, 0).astype(np.uint8)
            # direction bit for F of the NEXT cell: f_{j+1} from extension?
            f_next_ext = (f - e_ins) > t_ins  # f value leaving this cell
            d |= np.where(f_next_ext, 2 << 4, 0).astype(np.uint8)
            z[i, : end - beg] = d
        h[beg] = h_first
        h[beg + 1: end + 1] = h_new
        e[beg:end] = e_new
        e[end] = MINUS_INF

    score = int(h[qlen])
    cigar: list[tuple[int, int]] = []
    if want_cigar:
        which = 0
        i = tlen - 1
        k = min(i + w + 1, qlen) - 1
        ops: list[int] = []
        while i >= 0 and k >= 0:
            which = (int(z[i, k - max(i - w, 0)]) >> (which << 1)) & 3
            if which == 0:
                ops.append(0); i -= 1; k -= 1
            elif which == 1:
                ops.append(2); i -= 1
            else:
                ops.append(1); k -= 1
        if i >= 0:
            ops.extend([2] * (i + 1))
        if k >= 0:
            ops.extend([1] * (k + 1))
        ops.reverse()
        for op in ops:
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + 1)
            else:
                cigar.append((op, 1))
    return score, cigar


def local_score(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
                mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                e_ins: int) -> int:
    """Best local alignment score (what ksw_align2's .score reports for the
    16-bit path; bwalib/ksw.c:232-334)."""
    m = 5
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat[:, query.astype(np.int64)]
    h = np.zeros(qlen + 1, dtype=np.int64)
    e = np.zeros(qlen, dtype=np.int64)
    best = 0
    for i in range(tlen):
        Hdiag = h[:qlen].copy()
        M = np.maximum(Hdiag + qp[int(target[i])], 0)
        h_me = np.maximum(M, e)
        f = _row_f_scan(np.maximum(h_me - oe_ins, 0), e_ins, 0)
        # NB: striped SW computes F from H(i,j) after max with E; the lazy-F
        # loop iterates to fixpoint, equivalent to the scan over max(H-oe,0).
        h_new = np.maximum(h_me, f)
        e = np.maximum(e - e_del, h_new - oe_del)
        e = np.maximum(e, 0)
        h[1: qlen + 1] = h_new
        best = max(best, int(h_new.max()))
    return best
