"""Batched FMD-index queries (port of compseed_tpu/ops/fm.py).

Contracts (exact integer semantics, validated against cpu.fm_oracle):
  occ4_batch    — bwt_occ4 (FM_index/bwt.c:169-186)
  extend_batch  — bwt_extend (FM_index/bwt.c:262-275)
  sa_batch      — bwt_sa via inverse-Psi walk (FM_index/bwt.c:53-96)

``extend_sel_batch`` and the inverse-Psi walk ``_walk`` (behind
``sa_batch``) run their plain versions, ``_extend_sel_plain`` and
``_walk_plain``, for CPU tensors; for any other they call the launchers
of ``ops/fm_cuda.py``, which launch the hand-written kernels on CUDA
tensors or raise.  ``sa_batch_compact`` runs its plain version,
``_sa_batch_compact_plain``, for CPU tensors and its kernels otherwise
(``_sa_batch_compact_kernels``: every stage's walk and every boundary
between two stages one kernel, the last stage's while loop one CUDA graph
loop whose test the card sets, as the JAX package's runs on the TPU).

One occ query gathers ONE fused row (checkpoint counts + 2-bit BWT
bitplanes, see ops.device_index) and ranks in-block bases with masked
popcounts.  Invalid lanes are masked with k == -1, which the reference
also treats as "count zero".  The JAX package's device while loops are
Python loops here; each checks its exit condition exactly as often as
the JAX loop does, so the number of executed (masked) steps is equal.
"""

from __future__ import annotations

import torch

from compseed_tpu_torch.ops import cuda_lib, fm_cuda
from compseed_tpu_torch.ops.bits import MASK32, popcount32
from compseed_tpu_torch.ops.device_index import DeviceFMIndex

_WORD_SHIFT = (0, 32, 64, 96)


def _row_fetch(fm: DeviceFMIndex, k: torch.Tensor):
    """Gather packed rows for positions k; returns (cnt4, hi4, lo4, off),
    the words as int64 tensors of uint32 values (hi from words 4, 6, 8,
    10, lo from 5, 7, 9, 11 of ``occ_packed``).

    k must already be $-adjusted; a real lane's k is in [0, seq_len).
    With ``fm.fill_oob`` a lane carrying garbage (a member of an
    overflowed dedup group, whose chunk is rerun) reads what the JAX
    package's ``jnp.take`` reads, so the overflowed chunk's counters
    match too: a block in [-n, 0) wraps, one outside [-n, n) reads a row
    of all-ones words."""
    k = k.to(torch.int64)
    blk = k >> 7
    if fm.fill_oob:
        n = fm.n_rows
        rows = torch.where(((blk >= -n) & (blk < n))[..., None],
                           fm.occ_packed[blk.remainder(n)], -1)
    else:
        rows = fm.occ_packed[blk]                # (..., 16)
    # a count of 2^31 or more is a negative int32: widen, then mask
    rows = rows[..., :12].to(torch.int64) & MASK32
    return rows[..., 0:4], rows[..., 4:12:2], rows[..., 5:12:2], k & 0x7F


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
    extend_batch(fm, ik, is_back)[..., c, :].  ``fm_extend_sel_kernel``
    for CUDA tensors, ``_extend_sel_plain`` for CPU tensors."""
    if ik.device.type == "cpu":
        return _extend_sel_plain(fm, ik, c, is_back)
    return fm_cuda.extend_sel_batch(fm, ik, c, is_back)


def _extend_sel_plain(fm: DeviceFMIndex, ik: torch.Tensor, c: torch.Tensor,
                      is_back: bool) -> torch.Tensor:
    """extend_sel_batch's plain version."""
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
    2*sa_intv fully-masked steps: ``_sa_loop_plain`` for CPU tensors, the
    loop on the card for any other (``_sa_loop_kernels``)."""
    k = k.to(fm.dtype)
    steps = torch.zeros_like(k)
    # a lane is active while its row is unsampled; a sampled row stays put
    alive = (k & (fm.sa_intv - 1)) != 0
    k, steps, _ = _sa_loop(k.device)(fm, k, steps, alive)
    return steps + _sa_sample(fm, k)


def _sa_loop(dev: torch.device):
    """sa_batch's loop for tensors on ``dev``: the plain version for CPU
    tensors, the kernels for any other."""
    if dev.type == "cpu":
        return _sa_loop_plain
    return _sa_loop_kernels


def _walk(fm, kk, steps, alive, n_steps: int, out=None):
    """``n_steps`` masked inverse-Psi steps: on live lanes kk = invPsi(kk)
    and steps += 1, then a lane dies on a sampled row.  Returns (kk,
    steps, alive), written into ``out`` when given (the inputs
    themselves allowed).  ``fm_inv_psi_walk_kernel`` for CUDA tensors,
    ``_walk_plain`` for CPU tensors."""
    if kk.device.type == "cpu":
        walk = _walk_plain(fm, kk, steps, alive, n_steps)
        if out is None:
            return walk
        for o, x in zip(out, walk):
            o.copy_(x)
        return out
    if out is None:
        return fm_cuda.inv_psi_walk(fm, kk, steps, alive, n_steps)
    return fm_cuda.inv_psi_walk(fm, kk, steps, alive, n_steps, out=out)


def _walk_plain(fm, kk, steps, alive, n_steps: int):
    """_walk's plain version."""
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
    (the stage caps and their order are the JAX package's exactly).
    ``_sa_batch_compact_plain`` for CPU tensors, the kernels
    (``_sa_batch_compact_kernels``) for any other."""
    return _sa_compact(k.device)(fm, k)


def _sa_compact(dev: torch.device):
    """sa_batch_compact for tensors on ``dev``: the plain version for CPU
    tensors, the kernels for any other."""
    if dev.type == "cpu":
        return _sa_batch_compact_plain
    return _sa_batch_compact_kernels


def _sa_batch_compact_plain(fm: DeviceFMIndex, k: torch.Tensor):
    """sa_batch_compact's plain version: the JAX package's stages in
    PyTorch operations, each stage's walk, then the boundary after it
    (_sa_boundary_plain)."""
    dt = fm.dtype
    dev = k.device
    N = k.shape[0]
    mask = fm.sa_intv - 1

    kk = k.to(dt)
    st = dict(kk=kk, steps=torch.zeros(N, dtype=dt, device=dev),
              slot=torch.arange(N, dtype=torch.int64, device=dev),
              alive=(kk & mask) != 0,
              out_steps=torch.zeros(N + 1, dtype=dt, device=dev),  # [N]:
              out_k=torch.cat([kk, kk.new_zeros(1)]),              # drop
              ovf=torch.zeros((), dtype=torch.bool, device=dev))   # slot
    stages = ((1, fm.sa_intv), (4, 2 * fm.sa_intv), (16, 4 * fm.sa_intv),
              (64, 0))
    for i, (div, n_steps) in enumerate(stages):
        lanes = st["kk"], st["steps"], st["alive"]
        if n_steps == 0:
            lanes = _sa_loop_plain(fm, *lanes)
        else:
            lanes = _walk(fm, *lanes, n_steps)
        st.update(zip(("kk", "steps", "alive"), lanes))
        nxt = stages[i + 1][0] if i + 1 < len(stages) else None
        _sa_boundary_plain(st, N, None if nxt is None else max(N // nxt, 1))

    out_steps, out_k = st["out_steps"][:N], st["out_k"][:N]
    sa = out_steps + _sa_sample(fm, out_k)
    return sa, st["ovf"]


def _sa_boundary_plain(st: dict, N: int, cap):
    """The boundary after a stage of the plain version, on its state
    ``st`` (kk, steps, alive, slot, out_steps, out_k, ovf; updated): the
    lanes that died in the stage write out their steps and position
    (JAX fm.py:286-291), then, before another stage (``cap`` its lanes;
    None after the last), the live ones are stably compacted into the
    first ``cap`` lanes (JAX fm.py:268-279).  sa_stage_entry_kernel's
    plain version."""
    done = ~st["alive"] & (st["slot"] >= 0)
    sl = torch.where(done, st["slot"], N)
    st["out_steps"][sl] = torch.where(done, st["steps"], 0)
    st["out_k"][sl] = torch.where(done, st["kk"], 0)
    st["slot"] = torch.where(done, -1, st["slot"])
    if cap is None:
        return
    order = torch.argsort((~st["alive"]).to(torch.int8), stable=True)
    st["ovf"] = st["ovf"] | (st["alive"].sum() > cap)
    take = order[:cap]
    for n in ("kk", "steps", "alive", "slot"):
        st[n] = st[n][take]


def _sa_loop_plain(fm: DeviceFMIndex, kk, steps, alive):
    """The loop of sa_batch and of sa_batch_compact's last stage in
    PyTorch operations: 2 * sa_intv steps a round while any lane lives
    (the JAX package's while_loop, its test a host read here).  Returns
    (kk, steps, alive)."""
    while bool(alive.any()):
        kk, steps, alive = _walk(fm, kk, steps, alive, 2 * fm.sa_intv)
    return kk, steps, alive


# sa_batch's loops kept per (thread, device, index, lane count): the exact
# rerun pads its merged SAL's positions to a power of two lanes and
# densify_sa walks chunks of one width, so the shapes repeat, and a loop
# graph's capture and instantiation cost more than the host tests they
# save (measured on the H100: PERF.md, the lockstep loops)
SA_KEPT = 8
_SA_KEPT = cuda_lib.Kept(SA_KEPT)


class _SaKept:
    """sa_batch's loop for one (device, index, lane count), kept: its
    lanes (``lanes``: positions, steps, alive bytes; each call copies its
    own in) and its ``fm_cuda.SaLoop`` of two stages, the call's lanes and
    one as wide, whose loop graph the first call captures and every later
    one launches again."""

    def __init__(self, fm: DeviceFMIndex, N: int, dev: torch.device):
        dt = fm.dtype
        self.lanes = (torch.empty(N, dtype=dt, device=dev),
                      torch.empty(N, dtype=dt, device=dev),
                      torch.empty(N, dtype=torch.bool, device=dev))
        self.lp = fm_cuda.SaLoop(fm, *self.lanes,
                                 stages=((N, 0), (N, 2 * fm.sa_intv)))

    def close(self) -> None:
        self.lp.close()


def _sa_loop_kernels(fm: DeviceFMIndex, kk, steps, alive):
    """sa_batch's loop on the kernels (``fm_cuda.SaLoop`` of two stages,
    the call's lanes and one as wide): sa_stage_entry_kernel writes the
    lanes already done out and compacts the live ones, and runs the
    loop's first test; then ``cuda_lib.run_loop``'s WHILE node walks them
    2 * sa_intv steps a round, fm_inv_psi_walk_kernel's last block to
    retire testing the next round; a last stage entry writes them out.
    Outside a capture the loop is kept (``_SaKept``: on a card its graph
    is captured by a shape's first call and launched by the later ones);
    inside a call's capture it joins that capture.  The host waits on
    nothing.  Returns (kk, steps, alive) as _sa_loop_plain, every lane
    dead."""
    dt = fm.dtype
    dev = kk.device
    N = kk.shape[0]
    if N == 0:
        return kk.to(dt), steps.to(dt), alive
    stages = ((N, 0), (N, 2 * fm.sa_intv))
    if cuda_lib.capturing(dev):
        h = None
        lp = fm_cuda.SaLoop(fm, kk.to(dt).contiguous(),
                            steps.to(dt).contiguous(), alive.contiguous(),
                            stages=stages)
    else:
        h = _SA_KEPT.get((dev, id(fm), N), lambda: _SaKept(fm, N, dev))
        for mine, x in zip(h.lanes, (kk, steps, alive)):
            mine.copy_(x)
        lp = h.lp
    cuda_lib.run_loop(lp, fm_cuda.LIB, "fm", lambda lp: lp.boundary(0),
                      lambda lp: lp.walk(1, loop=True))
    lp.boundary(1)
    if h is None:
        return lp.out_k, lp.out_steps, torch.zeros_like(alive)
    # the kept outputs, which the shape's next call overwrites
    return lp.out_k.clone(), lp.out_steps.clone(), torch.zeros_like(alive)


def _sa_batch_compact_kernels(fm: DeviceFMIndex, k: torch.Tensor):
    """sa_batch_compact on the kernels (``fm_cuda.SaLoop``), for CUDA
    tensors: each stage's fm_inv_psi_walk_kernel and after it one
    sa_stage_entry_kernel (the done lanes written out, the live ones
    compacted into the next stage's lanes, ovf); the last stage's loop by
    ``cuda_lib.run_loop``, on a card one graph: the stage entry before it,
    which runs the loop's first test, then a WHILE node whose body walks
    the lanes 2 * sa_intv steps in place, the walk's last block to retire
    testing the next round (inside a call's capture the loop joins it;
    outside, its graph is captured, launched and freed here: the host
    waits on nothing); then the call's last stage entry.  For CPU tensors
    (the CPU tests put the kernels' host twins in place of the launches)
    the same launches in turn.  Returns (sa (N,), ovf)."""
    dt = fm.dtype
    kk = k.to(dt).contiguous()
    N = kk.shape[0]
    if N == 0:
        return kk.clone(), torch.zeros((), dtype=torch.bool, device=k.device)
    lp = fm_cuda.SaLoop(fm, kk, torch.zeros_like(kk),
                        (kk & (fm.sa_intv - 1)) != 0)
    for s in (0, 1):
        lp.walk(s)
        lp.boundary(s)
    lp.walk(2)
    cuda_lib.run_loop(lp, fm_cuda.LIB, "fm", lambda lp: lp.boundary(2),
                      lambda lp: lp.walk(3, loop=True))
    lp.boundary(3)
    lp.close()
    return lp.out_steps + _sa_sample(fm, lp.out_k), lp.ovf
