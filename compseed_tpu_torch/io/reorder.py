"""Reference-free read reordering (the compressor preprocessing step).

CompSeed's input contract is a read stream reordered by a reference-free
NGS compressor (SPRING / Minicom / PgRC, main.cpp:36-58): overlapping
reads land next to each other, which is what makes the SST caches hit.
This module provides that preprocessing natively so the framework is
usable end-to-end without an external compressor: reads are clustered
by their canonical minimizer and ordered by the minimizer's
strand-canonical offset, which recovers layout order locally from read
CONTENT only — the same signal SPRING's reorder stage uses (it buckets
reads by hashed substrings and greedily chains overlaps).

Only the ORDER changes; read content/orientation is untouched (the
reference consumes compressor output verbatim and emits SAM for the
reads as given).

Algorithm per read (vectorized over the batch):
  * scan all k-mers (k=KMER); ambiguous-base k-mers are excluded;
  * hash each k-mer and its reverse complement (64-bit mix), take the
    elementwise min (canonical);
  * the read's anchor = (min hash over positions, offset, strand of
    the canonical k-mer at that offset);
  * sort reads by (anchor hash, strand-canonical offset DESCENDING,
    read id).  Reads sharing an anchor k-mer overlap the same locus;
    descending canonical offset == ascending genome start.

Reads shorter than k or all-ambiguous sort to the back (hash max).
"""

from __future__ import annotations

import numpy as np

KMER = 21

_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64-style avalanche (vectorized, uint64)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(33))) * _MIX1
        x = (x ^ (x >> np.uint64(33))) * _MIX2
        return x ^ (x >> np.uint64(33))


def _kmer_codes(mat: np.ndarray, k: int):
    """(R, L) nt4 matrix -> (R, L-k+1) uint64 packed k-mers + validity.

    Forward pack: base i is the most significant 2 bits; reverse
    complement packed in the same orientation convention.
    """
    R, L = mat.shape
    n = L - k + 1
    valid_base = mat < 4
    codes = np.where(valid_base, mat, 0).astype(np.uint64)
    fwd = np.zeros((R, n), np.uint64)
    rev = np.zeros((R, n), np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd = (fwd << np.uint64(2)) | codes[:, j: j + n]
            # rc: complement bases consumed right-to-left
            rev = (rev << np.uint64(2)) | \
                (np.uint64(3) - codes[:, k - 1 - j: L - j])
    ok = np.ones((R, n), bool)
    for j in range(k):
        ok &= valid_base[:, j: j + n]
    return fwd, rev, ok


def reorder_indices(reads_nt4: np.ndarray, lens: np.ndarray | None = None,
                    k: int = KMER) -> np.ndarray:
    """Return the permutation that layout-orders the read batch.

    reads_nt4: (R, L) uint8 nt4 codes, rows padded with 4; lens
    optional per-read lengths (default: full rows).
    """
    R, L = reads_nt4.shape
    if lens is None:
        lens = np.full(R, L, np.int64)
    if L < k or R == 0:
        return np.arange(R)
    fwd, rev, ok = _kmer_codes(reads_nt4, k)
    n = fwd.shape[1]
    pos_ok = np.arange(n)[None, :] < (lens[:, None] - k + 1)
    ok &= pos_ok
    hf = _mix64(fwd)
    hr = _mix64(rev)
    use_f = hf <= hr
    h = np.where(use_f, hf, hr)
    h = np.where(ok, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    off = np.argmin(h, axis=1)
    rows = np.arange(R)
    anchor = h[rows, off]
    is_f = use_f[rows, off]
    # strand-canonical offset: ascending genome start within a cluster
    canon_off = np.where(is_f, off, lens - k - off)
    order = np.lexsort((rows, -canon_off, anchor))
    return order


def reorder_reads(seqs: list[str], k: int = KMER) -> list[int]:
    """Permutation for a list of ASCII reads (convenience wrapper)."""
    from compseed_tpu_torch.utils import NT4_TABLE
    R = len(seqs)
    if R == 0:
        return []
    L = max(len(s) for s in seqs)
    mat = np.full((R, L), 4, np.uint8)
    lens = np.zeros(R, np.int64)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = NT4_TABLE[np.frombuffer(s.encode(), np.uint8)]
        lens[i] = len(s)
    return reorder_indices(mat, lens, k).tolist()
