"""Seeded lanes for checking the FM kernels (csrc/fm_walk.cu) against
their plain versions (used by chip_smoke.py, tests/test_torch_cuda.py
and tests/test_torch_fm_kernels.py).  Lanes that need the index are made
on its own device by the plain versions.  ``random_index`` makes an index
over a random BWT of any size on the card, for tables larger than its L2
cache, with lanes for it from ``random_extend_lanes``,
``random_chain_lanes`` and ``random_sa_lanes``."""

from __future__ import annotations

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.bits import MASK32, popcount32
from compseed_tpu_torch.ops.device_index import (DeviceFMIndex,
                                                 build_occ_rows,
                                                 unpack_occ_rows)


def garbage(dfi, n=None):
    """Out-of-range positions: blocks that wrap and blocks past the table
    (the members of an overflowed dedup group carry such intervals),
    int64 numpy, clipped to int32 for an int32 index; repeated to n."""
    span = dfi.n_rows * 128
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


# ---------------------------------------------------------------------------
RANDOM_INDEX_SLAB = 1 << 18     # rows whose counts random_index sums at once


def random_index(n_bases: int, seed: int, device,
                 sa_intv: int = 8) -> DeviceFMIndex:
    """An index over a random BWT of ``n_bases`` bases (a multiple of 128),
    made on ``device`` from a seeded ``torch.Generator`` straight into the
    packed table: random hi / lo bit-plane words, the checkpoint counts
    by popcount and a running sum (the last row holds the totals and no
    planes), L2 from the totals and a seeded primary.  Made
    ``RANDOM_INDEX_SLAB`` rows at a time, so no temporary is wider than a
    slab.  int32 positions (n_bases < 2^31 - 1); no suffix-array
    sample and no reference, which the walks do not read."""
    if n_bases % 128 or not 0 < n_bases < 2**31 - 1:
        raise ValueError(f"random_index: {n_bases} bases")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = n_bases // 128
    rows = torch.zeros((nb + 1, 16), dtype=torch.int32, device=dev)
    total = torch.zeros(4, dtype=torch.int64, device=dev)
    for r0 in range(0, nb, RANDOM_INDEX_SLAB):
        planes = rows[r0:min(r0 + RANDOM_INDEX_SLAB, nb), 4:12]
        planes.copy_(torch.randint(-2**31, 2**31, planes.shape, generator=gen,
                                   device=dev, dtype=torch.int32))
        w = planes.to(torch.int64) & MASK32
        hi, lo = w[:, 0::2], w[:, 1::2]
        nh, nl = hi ^ MASK32, lo ^ MASK32
        for b, (h, l_) in enumerate(((nh, nl), (nh, lo), (hi, nl), (hi, lo))):
            run = torch.cumsum(popcount32(h & l_).sum(1), 0) + total[b]
            rows[r0 + 1:r0 + 1 + w.shape[0], b] = run.to(torch.int32)
            total[b] = run[-1]
    L2 = torch.cat([total.new_zeros(1), torch.cumsum(total, 0)])
    primary = int(torch.randint(1, n_bases, (1,), generator=gen, device=dev))
    return DeviceFMIndex(
        occ_packed=rows,
        sa_sampled=torch.zeros(0, dtype=torch.int32, device=dev),
        L2=L2.to(torch.int32), pac_words=torch.zeros(0, dtype=torch.int64,
                                                     device=dev),
        primary=primary, seq_len=n_bases, sa_intv=sa_intv,
        l_pac=n_bases // 2, idx_dtype=np.int32)


def random_index_rows_match_build(dfi, n_bases: int) -> bool:
    """Whether ``random_index``'s rows over its first ``n_bases`` bases (a
    multiple of 128), unpacked (``unpack_occ_rows``), equal what
    ``build_occ_rows`` makes of the same bases: the BWT codes decoded from
    the planes, packed 16 to a word, and checkpoint counts summed from the
    codes on the host."""
    nb = n_bases // 128
    rows = unpack_occ_rows(dfi.occ_packed[:nb + 1].cpu().numpy())
    bit = np.arange(128) & 31
    hi = (rows[:nb, 4 + (np.arange(128) >> 5)] >> bit) & 1
    lo = (rows[:nb, 8 + (np.arange(128) >> 5)] >> bit) & 1
    codes = (hi << 1 | lo).astype(np.uint32)             # (nb, 128)
    words = (codes.reshape(nb, 8, 16) << (30 - 2 * np.arange(16, dtype=np.uint32))
             ).sum(2, dtype=np.uint32)
    per = np.stack([(codes == b).sum(1) for b in range(4)], 1)
    cp = np.zeros((nb + 1, 4), np.uint64)
    cp[1:] = np.cumsum(per, 0)
    want = build_occ_rows(cp, words)
    return bool(np.array_equal(want[:nb], rows[:nb])
                and np.array_equal(want[nb, :4], rows[nb, :4]))


def random_chain_lanes(dfi, gen, U: int, W: int, is_back: bool,
                       stop: bool = False, clean: bool = False) -> tuple:
    """Chain-walk arguments (fm, wv, W, k, l, s, valid) and kwargs for U
    lanes over a ``random_index`` (or any index: only its size is read),
    from ``gen`` (on the index's device): sizes log-uniform in [1, 2^20)
    (at most the table's size), the searched coordinate x uniform with
    x - 1 + s inside the table, the other one uniform; window codes with
    about 1 % ambiguous; 95 % of the lanes valid; with ``stop``, stop_s
    uniform in [1, 64).  With ``clean`` every lane is valid and no code
    ambiguous, so that every lane takes W steps."""
    dev, dt, n = dfi.device, dfi.dtype, dfi.seq_len

    def unif(shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    s = torch.exp2(unif(U) * min(20, n.bit_length() - 1)).floor().to(
        torch.int64)
    x = (unif(U) * (n + 2 - s)).floor().to(torch.int64)
    y = (unif(U) * (n + 1)).floor().to(torch.int64)
    k, l = (x, y) if is_back else (y, x)
    bases = torch.randint(0, 4, (U, W), generator=gen, device=dev)
    amb = unif((U, W)) < (0 if clean else 0.01)
    bases = torch.where(amb, torch.randint(4, 8, (U, W), generator=gen,
                                           device=dev), bases)
    wv = (bases << (3 * torch.arange(W, device=dev))).sum(1)
    valid = unif(U) < (1 if clean else 0.95)
    kw = dict(is_back=is_back, stop_s=torch.randint(
        1, 64, (U,), generator=gen, device=dev).to(dt) if stop else None)
    return (dfi, wv, W, k.to(dt), l.to(dt), s.to(dt), valid), kw


def random_extend_lanes(dfi, gen, n: int, is_back: bool) -> tuple:
    """One-child extension arguments (fm, ik (n, 3), c (n,) int32, is_back)
    and no kwargs for n lanes over a ``random_index`` (or any index), from
    ``gen``: the intervals of ``random_chain_lanes``, children uniform in
    [0, 3]."""
    (_, _, _, k, l, s, _), _ = random_chain_lanes(dfi, gen, n, 1, is_back)
    c = torch.randint(0, 4, (n,), generator=gen, device=dfi.device,
                      dtype=torch.int32)
    return (dfi, torch.stack([k, l, s], 1), c, is_back), {}


def random_sa_lanes(dfi, gen, N: int, n_steps: int) -> tuple:
    """Inverse-Psi walk arguments (fm, kk, steps, alive, n_steps) and no
    kwargs for N lanes over a ``random_index`` (or any index): positions
    uniform in [0, seq_len], no steps yet, alive unless on a sampled
    row."""
    kk = torch.randint(0, dfi.seq_len + 1, (N,), generator=gen,
                       device=dfi.device).to(dfi.dtype)
    alive = (kk & (dfi.sa_intv - 1)) != 0
    return (dfi, kk, torch.zeros_like(kk), alive, n_steps), {}
