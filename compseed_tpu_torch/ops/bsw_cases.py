"""Seeded pair tables for checking the fused DP kernel against its plain
version (used by chip_smoke.py and tests/test_torch_cuda.py; numpy only).

``dual_meta_case`` makes reads from a reference, then extension pairs on
them in the (P, 12) layout ``BswRunner.run_meta_dual`` packs: left
(reverse) and right (forward) extensions of a seed, on both strands of
the doubled reference, some reads placed across the strand mirror at
l_pac, some with an insertion or a burst of substitutions (so the narrow
band or the z-drop rejects them at round 0), a tlen=0 lane, an empty
query, and pad lanes at the end.
"""

from __future__ import annotations

import numpy as np

from compseed_tpu_torch.ops.bsw_cuda import clamp_band


def dual_meta_case(rng, ref: np.ndarray, *, n: int, P: int, Q: int, T: int,
                   w0: int, opt, R: int = 64, read_len: int = 101,
                   wide_r0: bool = False):
    """ref: (l_pac,) uint8 codes 0..3.  Returns (qarr (R, L) uint8,
    meta (P, 12) int32) with n real pairs (n <= P), query lengths <= Q
    and target lengths <= T.  prev_score is -1 (never equal) except on
    every fifth lane, where the caller may put a round-0 score."""
    l_pac = len(ref)
    both = np.concatenate([ref, 3 - ref[::-1]])       # doubled reference
    read_len = min(read_len, Q)
    L = (read_len + 1 + 31) // 32 * 32
    qarr = np.full((R, L), 4, np.uint8)
    gpos = np.zeros(R, np.int64)
    for r in range(R):
        if r % 4 == 0:                                # across the mirror
            g = l_pac - int(rng.integers(1, read_len))
        else:
            g = int(rng.integers(0, 2 * l_pac - read_len))
        seq = both[g:g + read_len].copy()
        sub = rng.random(read_len) < rng.choice([0.0, 0.02, 0.1])
        seq[sub] = rng.integers(0, 4, int(sub.sum()))
        if r % 3 == 0:                                # insertion: off-diagonal
            j = int(rng.integers(10, read_len - 10))
            seq = np.concatenate([seq[:j], rng.integers(0, 4, 5),
                                  seq[j:]])[:read_len]
        if r % 11 == 0:
            seq[int(rng.integers(0, read_len))] = 4   # an N
        qarr[r, :read_len] = seq
        gpos[r] = g
    meta = np.zeros((P, 12), np.int32)
    meta[:, 7] = 1
    meta[:, 8] = -2                                   # pad lanes
    qlens = np.zeros(n, np.int32)
    for p in range(n):
        r = int(rng.integers(0, R))
        s_beg = int(rng.integers(0, read_len - 19))   # a 19-base seed
        s_end = s_beg + 19
        if p % 2:                                     # right extension
            qlen = read_len - s_end
            q0, rev, r0 = s_end, 0, gpos[r] + s_end
        else:                                         # left extension
            qlen = s_beg
            q0, rev, r0 = s_beg - 1, 1, gpos[r] + s_beg - 1
        tlen = min(qlen + int(rng.integers(0, 40)), T) if qlen else 0
        if rev:
            tlen = min(tlen, int(r0) + 1)
        else:
            tlen = min(tlen, 2 * l_pac - int(r0))
        if p == 7:
            tlen = 0
        qlens[p] = qlen
        meta[p, 0:4] = (r, q0, qlen, rev)
        meta[p, 4] = np.int64(r0 & 0xFFFFFFFF).astype(np.uint32) \
            .view(np.int32)
        meta[p, 5] = (int(r0) >> 32) if wide_r0 else 0
        meta[p, 6] = tlen
        meta[p, 7] = int(rng.integers(19, 120))
        meta[p, 8] = -1
    gaps = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    meta[:n, 9] = clamp_band(qlens, w0, 1, opt.pen_clip5, *gaps)
    meta[:n, 10] = clamp_band(qlens, 2 * w0, 1, opt.pen_clip5, *gaps)
    return qarr, meta
