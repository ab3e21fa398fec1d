"""Suffix-array construction (host side, fully numpy-vectorized).

The reference builds the BWT with SA-IS / BWT-SW / rope (FM_index/is.c,
bwt_gen.c, rope.c).  Those are pointer-chasing C algorithms; here we use a
vectorized prefix-doubling (Manber-Myers) construction instead, which is
O(n log n) in numpy primitives and produces the identical suffix array —
only the construction *algorithm* differs, the resulting index bytes match.

A virtual sentinel smaller than every character terminates the string, i.e.
we compute the suffix array of S + '$' including the sentinel suffix, so
``sa[0] == len(S)`` always.
"""

from __future__ import annotations

import numpy as np


def suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array of s + sentinel; returns int array of length len(s)+1.

    ``s`` must be an unsigned integer array with small alphabet (values >= 0).
    The sentinel sorts before every character.
    """
    n = len(s) + 1
    dtype = np.int32 if n < (1 << 31) else np.int64
    # rank 0 = sentinel; characters shifted by +1
    rank = np.zeros(n, dtype=dtype)
    rank[: n - 1] = s.astype(dtype) + 1

    sa = np.argsort(rank, kind="stable").astype(dtype)
    # compress ranks after 1-char sort
    r_sorted = rank[sa]
    new = np.empty(n, dtype=dtype)
    head = np.empty(n, dtype=bool)
    head[0] = True
    np.not_equal(r_sorted[1:], r_sorted[:-1], out=head[1:])
    new[sa] = np.cumsum(head) - 1
    rank = new

    k = 1
    while rank[sa[-1]] != n - 1:
        # sort by (rank[i], rank[i+k]) using stable counting-style argsorts
        rank2 = np.zeros(n, dtype=dtype)
        rank2[: n - k] = rank[k:]
        # secondary key first, then primary (stable)
        order = np.argsort(rank2, kind="stable")
        order = order[np.argsort(rank[order], kind="stable")]
        sa = order.astype(dtype)
        # recompute ranks
        r1 = rank[sa]
        r2 = rank2[sa]
        head[0] = True
        np.logical_or(r1[1:] != r1[:-1], r2[1:] != r2[:-1], out=head[1:])
        new[sa] = np.cumsum(head) - 1
        rank = new.copy()
        k <<= 1
        if k >= n:
            break
    return sa


def bwt_from_sa(s: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT string (sentinel row removed) and primary index.

    BWA convention (FM_index/bwt.c): the BWT of S$ has n+1 rows; the row
    whose suffix is the whole string (sa == 0) holds the sentinel in the
    last column; ``primary`` is that row's index, and the stored BWT skips
    it (bwt_B0 indexes the $-removed string).
    """
    n = len(s)
    primary = int(np.nonzero(sa == 0)[0][0])
    prev = sa - 1  # character index preceding each suffix
    keep = sa != 0
    bwt = s[prev[keep]]
    return bwt.astype(np.uint8), primary
