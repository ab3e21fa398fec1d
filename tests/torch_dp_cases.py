"""Seeded DP test cases shared by the port's CPU tests and its card tests.
Imports no JAX, so the card tests can run where JAX is not installed."""

import numpy as np

from compseed_tpu_torch.options import MemOptions, fill_scmat
from compseed_tpu_torch.ops import bsw_cuda

OPT = MemOptions()
GAP = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
           e_ins=OPT.e_ins, zdrop=OPT.zdrop)
MAT = np.array(fill_scmat(1, 4), dtype=np.int32).reshape(5, 5)


def dp_tiles(seed: int, P: int = 512, Q: int = 128, T: int = 256):
    """Random extension pairs with z-drop breaks, band shrink, h0 near
    the bound, empty queries and tlen=0 lanes (tiles in the kernel's
    (P, Q)/(P, T) int8 + (P, 1) int32 layout)."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(0, Q + 1, P).astype(np.int32)
    tlens = rng.integers(0, T + 1, P).astype(np.int32)
    queries = np.full((P, Q), 4, np.int8)
    targets = np.full((P, T), 4, np.int8)
    for i in range(P):
        queries[i, :qlens[i]] = rng.integers(0, 4, qlens[i])
        tl = int(tlens[i])
        if tl and qlens[i]:
            src = np.resize(queries[i, :qlens[i]], tl).copy()
            err = rng.random(tl) < rng.choice([0.01, 0.08, 0.3])
            src[err] = rng.integers(0, 4, err.sum())
            targets[i, :tl] = src
    queries[rng.random((P, Q)) < 0.01] = 4
    qlens[::53] = 0
    tlens[::41] = 0
    h0 = rng.integers(1, 102, P).astype(np.int32)
    h0[::17] = rng.integers(300, 1 << 14, len(h0[::17]))
    ws = bsw_cuda.clamp_band(qlens, int(rng.choice([5, 100])), 1,
                             OPT.pen_clip5, OPT.o_del, OPT.e_del,
                             OPT.o_ins, OPT.e_ins)
    ws[::7] = rng.integers(1, 10, len(ws[::7]))
    return (queries, qlens[:, None], targets, tlens[:, None], h0[:, None],
            ws[:, None].astype(np.int32))
