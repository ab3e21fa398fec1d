"""Batched FMD-index queries (port of compseed_tpu/ops/fm.py).

Contracts (exact integer semantics, validated against cpu.fm_oracle):
  occ4_batch    — bwt_occ4 (FM_index/bwt.c:169-186)
  extend_batch  — bwt_extend (FM_index/bwt.c:262-275)
  sa_batch      — bwt_sa via inverse-Psi walk (FM_index/bwt.c:53-96)

One occ query gathers ONE fused row (checkpoint counts + 2-bit BWT
bitplanes, see ops.device_index) and ranks in-block bases with masked
popcounts.  Invalid lanes are masked with k == -1, which the reference
also treats as "count zero".  The JAX package's device while loops are
Python loops here; each checks its exit condition exactly as often as
the JAX loop does, so the number of executed (masked) steps is equal.
"""

from __future__ import annotations

import torch

from compseed_tpu_torch.ops.bits import MASK32, popcount32
from compseed_tpu_torch.ops.device_index import DeviceFMIndex

_WORD_SHIFT = (0, 32, 64, 96)


def _row_fetch(fm: DeviceFMIndex, k: torch.Tensor):
    """Gather fused rows for positions k; returns (cnt4, hi4, lo4, off).

    k must already be $-adjusted; a real lane's k is in [0, seq_len).
    With ``fm.fill_oob`` a lane carrying garbage (a member of an
    overflowed dedup group, whose chunk is rerun) reads what the JAX
    package's ``jnp.take`` reads, so the overflowed chunk's counters
    match too: a block in [-n, 0) wraps, one outside [-n, n) reads a row
    of all-ones words."""
    k = k.to(torch.int64)
    blk = k >> 7
    if fm.fill_oob:
        n = fm.occ_rows.shape[0]
        rows = torch.where(((blk >= -n) & (blk < n))[..., None],
                           fm.occ_rows[blk.remainder(n)], MASK32)
    else:
        rows = fm.occ_rows[blk]                  # (..., 12)
    return rows[..., 0:4], rows[..., 4:8], rows[..., 8:12], k & 0x7F


def _sa_sample(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """sa_sampled[k // sa_intv] with the JAX package's index rule (a
    negative index wraps once, then the index is clamped), which only a
    garbage lane of an overflowed chunk can need."""
    n = fm.sa_sampled.shape[0]
    i = (k // fm.sa_intv).to(torch.int64)
    return fm.sa_sampled[torch.where(i < 0, i + n, i).clamp(0, n - 1)]


def _rank4(cnt, hi, lo, off, dt):
    """Counts of each base among block positions 0..off inclusive."""
    word = torch.tensor(_WORD_SHIFT, dtype=torch.int64, device=off.device)
    nbits = (off[..., None] - word + 1).clamp(0, 32)
    mask = (torch.ones_like(nbits) << nbits) - 1          # 2**32-1 at 32
    hm = hi & mask
    lm = lo & mask
    nh = (hm ^ MASK32) & mask
    nl = (lm ^ MASK32) & mask
    c3 = popcount32(hm & lm).sum(-1)
    c2 = popcount32(hm & nl).sum(-1)
    c1 = popcount32(nh & lm).sum(-1)
    c0 = popcount32(nh & nl).sum(-1)
    return cnt.to(dt) + torch.stack([c0, c1, c2, c3], dim=-1).to(dt)


def occ4_batch(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Counts of each base in BWT[0..k] inclusive. k: (...,) -> (..., 4).

    k == -1 lanes return zeros (bwt.c:173-175)."""
    dt = fm.dtype
    k = k.to(dt)
    valid = k != -1
    kk = torch.where(valid, k - (k >= fm.primary).to(dt), 0)
    out = _rank4(*_row_fetch(fm, kk), dt)
    return torch.where(valid[..., None], out, 0)


def _occ4_pair(fm: DeviceFMIndex, ka: torch.Tensor, kb: torch.Tensor):
    """occ4 at two positions with one fused gather batch."""
    dt = fm.dtype
    both = torch.stack([ka.to(dt), kb.to(dt)], dim=-1)   # (..., 2)
    valid = both != -1
    kk = torch.where(valid, both - (both >= fm.primary).to(dt), 0)
    out = _rank4(*_row_fetch(fm, kk), dt)
    out = torch.where(valid[..., None], out, 0)
    return out[..., 0, :], out[..., 1, :]


def extend_batch(fm: DeviceFMIndex, ik: torch.Tensor,
                 is_back: bool) -> torch.Tensor:
    """Bidirectional extension. ik: (..., 3) -> ok: (..., 4, 3).

    ok[..., c, :] is the child bi-interval for base c."""
    dt = fm.dtype
    ik = ik.to(dt)
    fwd = 1 - int(bool(is_back))
    bwd = 1 - fwd
    x = ik[..., fwd]
    s = ik[..., 2]
    tk, tl = _occ4_pair(fm, x - 1, x - 1 + s)
    sizes = tl - tk                                      # (..., 4)
    coord_f = fm.L2[:4] + 1 + tk
    contains_primary = ((x <= fm.primary) &
                        (x + s - 1 >= fm.primary)).to(dt)
    b3 = ik[..., bwd] + contains_primary
    b2 = b3 + sizes[..., 3]
    b1 = b2 + sizes[..., 2]
    b0 = b1 + sizes[..., 1]
    coord_b = torch.stack([b0, b1, b2, b3], dim=-1)
    cols = [None, None, sizes]
    cols[fwd] = coord_f
    cols[bwd] = coord_b
    return torch.stack(cols, dim=-1)


def _sel4(arr4: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """arr4[..., c] for per-lane c in [0, 3] (a 4-way masked sum, like
    the JAX package's gather-free select)."""
    out = torch.zeros(arr4.shape[:-1], dtype=arr4.dtype, device=arr4.device)
    for b in range(4):
        out = out + torch.where(c == b, arr4[..., b], 0)
    return out


def extend_sel_batch(fm: DeviceFMIndex, ik: torch.Tensor, c: torch.Tensor,
                     is_back: bool) -> torch.Tensor:
    """One-child bidirectional extension: extend_batch followed by
    selecting child ``c`` per lane, fused.  ik: (..., 3), c: (...,) base
    codes in [0, 3] -> (..., 3).  Bit-exact vs
    extend_batch(fm, ik, is_back)[..., c, :]."""
    dt = fm.dtype
    ik = ik.to(dt)
    fwd = 1 - int(bool(is_back))
    bwd = 1 - fwd
    x = ik[..., fwd]
    s = ik[..., 2]
    tk, tl = _occ4_pair(fm, x - 1, x - 1 + s)
    sizes = tl - tk
    size_c = _sel4(sizes, c)
    coord_f = fm.L2[c.to(torch.int64)] + 1 + _sel4(tk, c)
    contains_primary = ((x <= fm.primary) &
                        (x + s - 1 >= fm.primary)).to(dt)
    above = torch.zeros(c.shape, dtype=dt, device=c.device)
    for b in range(1, 4):
        above = above + torch.where(c < b, sizes[..., b], 0)
    coord_b = ik[..., bwd] + contains_primary + above
    cols = [None, None, size_c]
    cols[fwd] = coord_f
    cols[bwd] = coord_b
    return torch.stack(cols, dim=-1)


def _bwt_code(hi, lo, off):
    """The 2-bit BWT code at in-block offset ``off`` of a fetched row."""
    w = (off >> 5)[..., None]
    b = off & 31
    hw = torch.gather(hi, -1, w)[..., 0]
    lw = torch.gather(lo, -1, w)[..., 0]
    return (((hw >> b) & 1) << 1) | ((lw >> b) & 1)


def inv_psi_batch(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """One LF step per lane (bwt_invPsi, bwt.c:53-59).  Requires k >= 0.

    ONE row gather serves both the BWT base and its rank: the base lives
    at x = k - (k > primary), the rank is taken at kk = k - (k >= primary);
    x == kk everywhere except k == primary, whose result is 0."""
    dt = fm.dtype
    k = k.to(dt)
    x = k - (k > fm.primary).to(dt)
    cnt_x, hi_x, lo_x, off_x = _row_fetch(fm, x)
    c = _bwt_code(hi_x, lo_x, off_x)
    occ4 = _rank4(cnt_x, hi_x, lo_x, off_x, dt)
    occ = torch.gather(occ4, -1, c[..., None])[..., 0]
    res = fm.L2[c] + occ
    return torch.where(k == fm.primary, 0, res)


def bwt_b0_batch(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Base at position k of the $-removed BWT (bwt_B0, bwt.h:80)."""
    _, hi, lo, off = _row_fetch(fm, k.to(fm.dtype))
    return _bwt_code(hi, lo, off).to(torch.int32)


def sa_batch(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """SA[k] per lane via masked inverse-Psi walk (bwt_sa, bwt.c:86-96).

    Like the JAX loop, the all-done condition is tested once per
    2*sa_intv fully-masked steps."""
    dt = fm.dtype
    k = k.to(dt)
    mask = fm.sa_intv - 1
    steps = torch.zeros_like(k)
    while bool(((k & mask) != 0).any()):
        for _ in range(2 * fm.sa_intv):
            active = (k & mask) != 0
            k = torch.where(active, inv_psi_batch(fm, k), k)
            steps = steps + active.to(dt)
    return steps + _sa_sample(fm, k)


def _walk(fm, kk, steps, alive, n_steps: int):
    mask = fm.sa_intv - 1
    for _ in range(n_steps):
        kk = torch.where(alive, inv_psi_batch(fm, kk), kk)
        steps = steps + alive.to(steps.dtype)
        alive = alive & ((kk & mask) != 0)
    return kk, steps, alive


def sa_batch_compact(fm: DeviceFMIndex, k: torch.Tensor):
    """sa_batch with staged compaction: walk a few steps full-width,
    then stably compact the unfinished minority and continue narrow.

    Returns (sa (N,), ovf) — ovf set if stragglers exceeded a stage cap
    (the stage caps and their order are the JAX package's exactly)."""
    dt = fm.dtype
    dev = k.device
    N = k.shape[0]
    mask = fm.sa_intv - 1

    kk = k.to(dt)
    steps = torch.zeros(N, dtype=dt, device=dev)
    slot = torch.arange(N, dtype=torch.int64, device=dev)
    alive = (kk & mask) != 0

    out_steps = torch.zeros(N + 1, dtype=dt, device=dev)   # [N]: drop slot
    out_k = torch.cat([kk, kk.new_zeros(1)])
    ovf = torch.zeros((), dtype=torch.bool, device=dev)

    stages = ((1, fm.sa_intv), (4, 2 * fm.sa_intv), (16, 4 * fm.sa_intv),
              (64, 0))
    for div, n_steps in stages:
        cap = max(N // div, 1)
        if div > 1:
            order = torch.argsort((~alive).to(torch.int8), stable=True)
            ovf = ovf | (alive.sum() > cap)
            take = order[:cap]
            kk, steps, alive, slot = kk[take], steps[take], alive[take], \
                slot[take]
        if n_steps == 0:
            while bool(alive.any()):
                kk, steps, alive = _walk(fm, kk, steps, alive,
                                         2 * fm.sa_intv)
        else:
            kk, steps, alive = _walk(fm, kk, steps, alive, n_steps)
        done = ~alive & (slot >= 0)
        sl = torch.where(done, slot, N)
        out_steps[sl] = torch.where(done, steps, 0)
        out_k[sl] = torch.where(done, kk, 0)
        slot = torch.where(done, -1, slot)

    out_steps, out_k = out_steps[:N], out_k[:N]
    sa = out_steps + _sa_sample(fm, out_k)
    return sa, ovf
