"""Seeded lanes for checking the FM kernels (csrc/fm_walk.cu) against
their plain versions (used by chip_smoke.py, tests/test_torch_cuda.py
and tests/test_torch_fm_kernels.py).  Lanes that need the index are made
on its own device by the plain versions."""

from __future__ import annotations

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops import seedscan as tss


def garbage(dfi, n=None):
    """Out-of-range positions: blocks that wrap and blocks past the table
    (the members of an overflowed dedup group carry such intervals),
    int64 numpy, clipped to int32 for an int32 index; repeated to n."""
    span = dfi.occ_rows.shape[0] * 128
    ks = np.array([-3 * span, -span - 200, -span + 5, -300, -1, 0,
                   dfi.seq_len, span - 1, span, span + 4000, 7 * span],
                  np.int64)
    if dfi.dtype == torch.int32:
        ks = ks.clip(-2**31, 2**31 - 1)
    return ks if n is None else np.resize(ks, n)


def intervals(dfi, rng, n, depth=8):
    """n - 8 bi-intervals of random patterns of up to ``depth`` bases by
    backward search (the last non-empty one), then the root, intervals
    that hold ``primary`` or start at 0, and lanes whose searched
    coordinate is 0 (an occ query at -1)."""
    dev, dt = dfi.device, dfi.dtype
    m = n - 8

    def rand_c():
        return torch.from_numpy(rng.integers(0, 4, m)).to(dev)

    ik = tss._set_intv(dfi, rand_c()).T.contiguous()
    live = torch.ones(m, dtype=torch.bool, device=dev)
    for _ in range(int(rng.integers(1, depth))):
        nxt = tfm._extend_sel_plain(dfi, ik, rand_c(), True)
        live = live & (nxt[:, 2] > 0)
        ik = torch.where(live[:, None], nxt, ik)
    pr, sl = dfi.primary, dfi.seq_len
    extra = torch.tensor([[0, 0, sl + 1], [pr - 2, pr - 1, 5], [pr, pr, 1],
                          [pr - 1, 3, 2], [0, 7, 4], [9, 0, 3], [0, 0, 0],
                          [sl, sl, 1]], dtype=dt, device=dev)
    return torch.cat([ik.to(dt), extra])


def windows(rng, U, W):
    """Random 3-bit window codes (U, W): bases 0-3 with ambiguous codes
    (4-7) sprinkled in, and lane i < U / 2 ambiguous at column i % W, so
    that a walk stops at every column."""
    bases = rng.integers(0, 4, (U, W))
    amb = rng.random((U, W)) < 0.05
    bases[amb] = rng.integers(4, 8, int(amb.sum()))
    h = np.arange(U // 2)
    bases[h, h % W] = 4 + h % 4
    return bases


def pack(bases):
    """(U, W) codes -> (U,) int64 window words, code j at bits 3j."""
    W = bases.shape[1]
    return (bases.astype(np.int64) << (3 * np.arange(W))).sum(1)


def sa_lanes(dfi, rng, n):
    """n positions for the inverse-Psi walk: random rows, sampled rows
    (dead from the start), primary and its neighbours, 0 and seq_len;
    with carried step counts and an alive mask (every 17th lane dead
    whatever its row)."""
    dt = np.int64 if dfi.dtype == torch.int64 else np.int32
    kk = np.concatenate([
        rng.integers(0, dfi.seq_len + 1, n - 45),
        np.arange(0, dfi.seq_len + 1, dfi.sa_intv)[:40],
        [dfi.primary, dfi.primary - 1, dfi.primary + 1, 0, dfi.seq_len]])
    kk = kk.astype(dt)
    steps = rng.integers(0, 5, len(kk)).astype(dt)
    alive = (kk & (dfi.sa_intv - 1)) != 0
    alive[::17] = False
    return kk, steps, alive
