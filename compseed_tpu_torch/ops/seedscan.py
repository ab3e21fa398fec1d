"""Compressive seeding scans — compseed_tpu/ops/seedscan.py in PyTorch.

Forward (LEP collection; round-2 re-seed tasks; round-3 greedy seeding
with ``mode="r3"``):
  * ``chain_scan`` — the cross-round extension-chain memo (the forward
    SST trie, mapping/SST.h:60-92), the default;
  * ``forward_scan_dedup`` — the staged sweep worklist with one
    representative walk per (interval, content-window) group per stage;
  * ``make_scan`` + ``build_pool`` — the lockstep scan, no sharing.
Backward:
  * ``walk_pool_chain`` — W-char chained rounds with exact per-round
    content grouping (the backward trie's sharing, SST.h:72-92), the
    default;
  * ``walk_pool_dedup`` — a content-window probe, then the whole-walk
    path for the survivors;
  * ``dedup_pool`` + ``walk_pool`` — whole-walk keying; ``walk_pool``
    alone — the plain staged walks.
And ``reconstruct`` — SMEM emission from walked pool rows.

Every step is the JAX package's, operation for operation, so pools,
death positions, memo trajectories and every counter are bit-equal.  Where
JAX runs a device while loop, this runs a Python loop that tests the same
condition at the same points (the segment widths and stage budgets set
the shapes, and so the rounds, that the counters count); a vmapped
per-read loop becomes one batched program over lanes with a per-lane
``done`` mask.  JAX's drop-mode scatters become ``_drop_set``: indices
past the end land in a dump row that is cut off, so the real rows are
written once each and deterministically.  Packed windows and hashes are
int64 tensors holding uint32 / uint64 words (``ops/bits.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops.bits import (add64, as_i32, lsr64, mul32,
                                         mul64, sub64, u32)
from compseed_tpu_torch.ops.device_index import DeviceFMIndex

CAPL = 96       # LEP rows per read (round 1, all pivots)
CAPL2 = 32      # LEP rows per round-2 task
REV_W = 8       # chars per packed reverse window
CHAIN_W = 8     # extension-chain chunk width (see chain_scan)

_I32_MAX = int(np.iinfo(np.int32).max)
_I64 = torch.int64
_I32 = torch.int32


def _drop_set(dst: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(val, mode="drop")`` for idx >= 0, as a new
    tensor: indices >= len(dst) are written into a dump row that is cut
    off, so sentinel rows never land and every real row is written by at
    most one index (no device-side sync, unlike a boolean mask)."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    buf[idx.to(_I64).clamp(max=n)] = val.to(dst.dtype)
    return buf[:n]


def _inverse_perm(order: torch.Tensor) -> torch.Tensor:
    """zeros(w).at[order].set(arange(w))."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype,
                              device=order.device)
    return inv


def _group_heads(sorted_keys, vs):
    """Group heads over keys in sorted order: a valid row whose key
    differs from its predecessor's."""
    diff = torch.zeros_like(vs)
    diff[0] = True
    for x in sorted_keys:
        diff[1:] |= x[1:] != x[:-1]
    return vs & diff


def _set_intv(fm: DeviceFMIndex, c: torch.Tensor) -> torch.Tensor:
    """(3, ...) bi-interval of the single base c."""
    L2 = fm.L2
    c = c.to(_I64)
    return torch.stack([L2[c] + 1, L2[3 - c] + 1,
                        L2[c + 1] - L2[c]]).to(fm.dtype)


def packed_rev_windows(qarr: torch.Tensor) -> torch.Tensor:
    """rw[r, p] = 3-bit-packed codes q[p], q[p-1], ..., q[p-REV_W+1]
    (positions below 0 read as 4), flattened (int64 words)."""
    R, L = qarr.shape
    ext = torch.cat([torch.full((R, REV_W - 1), 4, dtype=qarr.dtype,
                                device=qarr.device), qarr],
                    dim=1).to(_I64)
    rw = torch.zeros((R, L), dtype=_I64, device=qarr.device)
    for j in range(REV_W):
        rw |= ext[:, (REV_W - 1 - j):(REV_W - 1 - j) + L] << (3 * j)
    return rw.reshape(-1)


def packed_windows(qarr: torch.Tensor, W: int) -> torch.Tensor:
    """win[r, p] = 3-bit-packed codes of row r's chars [p, p+W), the row
    extended with 4s; p in [0, L+2).  Flattened (int64 words)."""
    R, L = qarr.shape
    ext = torch.cat([qarr, torch.full((R, W + 2), 4, dtype=qarr.dtype,
                                      device=qarr.device)], dim=1).to(_I64)
    win = torch.zeros((R, L + 2), dtype=_I64, device=qarr.device)
    for j in range(W):
        win |= ext[:, j:j + L + 2] << (3 * j)
    return win.reshape(-1)


def next_nonamb(qarr: torch.Tensor) -> torch.Tensor:
    """nxt[r, p] = smallest p' >= p with q[r, p'] < 4, else L (int32)."""
    R, L = qarr.shape
    pos = torch.where(qarr < 4,
                      torch.arange(L, dtype=_I32, device=qarr.device)[None],
                      L)
    return torch.flip(torch.cummin(torch.flip(pos, (1,)), dim=1).values,
                      (1,)).to(_I32)


def _rank_order(keep: torch.Tensor) -> torch.Tensor:
    """Stable compaction order: indices of the ``keep`` rows, then of the
    others, each in index order (a rank scatter, no sort)."""
    n = keep.sum()
    rank_k = torch.cumsum(keep, 0) - 1
    rank_o = torch.cumsum(~keep, 0) - 1 + n
    return _inverse_perm(torch.where(keep, rank_k, rank_o))


# ----------------------------------------------------------------------
# lockstep LEP scan (the engine under dedup=False / COMPSEED_FWD_DEDUP=0)
# ----------------------------------------------------------------------

def _scan_lanes(fm: DeviceFMIndex, L: int, capl: int, advance: bool,
                q, rlen, pivot0, min_hits, active):
    """Every lane's forward pass at once: returns (lep (R, capl, 5), cnt,
    ovf), cnt and ovf in the index dtype.

    lep rows: k, l, s, end, pivot, in push order (descending interval
    size within each pivot group).  With ``advance`` a lane continues to
    its next pivot after each stop (round 1); otherwise it finishes after
    its first collect (a round-2 task).  Each update is gated by the
    lane's own ``done``, so the steps a lane takes after it is done
    change nothing and the result equals the per-read program lane for
    lane.  Like the JAX loop, the all-done test runs every 8 steps."""
    dt = fm.dtype
    dev = q.device
    R = q.shape[0]
    lanes = torch.arange(R, device=dev)
    rlen = rlen.to(_I32)
    min_hits = min_hits.to(dt).clamp(min=1)
    pivot = pivot0.to(_I32)
    i = torch.zeros(R, dtype=_I32, device=dev)
    phase = torch.zeros(R, dtype=_I32, device=dev)      # 0 = start, 1 = sweep
    ik = torch.zeros((R, 3), dtype=dt, device=dev)
    end = torch.zeros(R, dtype=_I32, device=dev)
    lep = torch.zeros((R, capl + 1, 5), dtype=dt, device=dev)   # + dump
    cnt = torch.zeros(R, dtype=_I32, device=dev)
    ovf = torch.zeros(R, dtype=torch.bool, device=dev)
    done = ~active

    def char(p):
        return q[lanes, p.clamp(0, L - 1).to(_I64)].to(_I32)

    while bool((~done).any()):
        for _ in range(8):
            # ---- phase 0: start a new pivot
            start = (phase == 0) & ~done
            done = done | (start & (pivot >= rlen))
            do_start = start & (pivot < rlen)
            base0 = char(pivot)
            started = do_start & (base0 <= 3)
            ik = torch.where(started[:, None],
                             _set_intv(fm, base0.clamp(0, 3)).T, ik)
            end = torch.where(started, pivot + 1, end)
            i = torch.where(started, pivot + 1, i)
            pivot = torch.where(do_start & (base0 > 3), pivot + 1, pivot)
            phase = torch.where(started, 1, phase)

            # ---- phase 1: one forward step (comp_seed.cpp:76-97); past
            # the read end behaves as an ambiguous base
            sweep = (phase == 1) & ~done
            base = torch.where(i < rlen, char(i), 4)
            amb = base > 3
            okc = dfm.extend_sel_batch(fm, ik, 3 - base.clamp(0, 3),
                                       is_back=False)
            changed = okc[:, 2] != ik[:, 2]
            push = sweep & (amb | changed)
            stop = sweep & (amb | (changed & (okc[:, 2] < min_hits)))
            cont = sweep & ~stop & ~amb
            row = torch.cat([ik, end[:, None].to(dt), pivot[:, None].to(dt)],
                            dim=1)
            lep[lanes, torch.where(push, cnt.clamp(max=capl - 1), capl)
                .to(_I64)] = row
            ovf = ovf | (push & (cnt >= capl))
            cnt = cnt + (push & (cnt < capl)).to(_I32)
            if advance:
                pivot = torch.where(stop, torch.where(amb, i + 1, i), pivot)
                phase = torch.where(stop, 0, phase)
            else:
                done = done | stop
            ik = torch.where(cont[:, None], okc, ik)
            end = torch.where(cont, i + 1, end)
            i = torch.where(cont, i + 1, i)
    return lep[:, :capl], cnt.to(dt), ovf.to(dt)


def make_scan(fm: DeviceFMIndex | None, L: int, capl: int, advance: bool):
    """The lockstep LEP scan as a callable ``(qarr, rlens, pivots,
    min_hits, active) -> (lep (R, capl, 5), cnt (R,), ovf (R,))``; with
    ``fm`` None the index is the first argument."""
    def run(fm_, qarr, rlens, pivots, min_hits, active):
        return _scan_lanes(fm_, L, capl, advance, qarr, rlens, pivots,
                           min_hits, active)

    if fm is None:
        return run
    return lambda *a: run(fm, *a)


def build_pool(lep, cnt, GP: int):
    """Flatten per-read LEP buffers into a dense global pool.

    lep: (R, capl, 5) rows (k, l, s, end, pivot); cnt: (R,).
    Returns pool (GP, 7): k, l, s, end, pivot, rid, valid — stable-
    compacted so valid rows keep (read, push) order; plus n_valid and the
    overflow flag."""
    R, capl, _ = lep.shape
    dt = lep.dtype
    dev = lep.device
    vflat = (torch.arange(capl, device=dev)[None, :] <
             cnt[:, None].to(_I64)).reshape(-1)
    rflat = torch.arange(R, device=dev).repeat_interleave(capl)
    n = vflat.sum().to(_I32)
    take = _rank_order(vflat)[:GP]
    pool = torch.cat([lep.reshape(R * capl, 5)[take],
                      rflat[take][:, None].to(dt),
                      vflat[take][:, None].to(dt)], dim=1)
    return pool, n, n > GP


# ----------------------------------------------------------------------
# staged backward walks (dense worklist, fit-gated compaction)
# ----------------------------------------------------------------------

def walk_stage(fm: DeviceFMIndex, qflat, L: int, max_steps: int, state,
               t0: int = 0, fit: int = 0, rwflat=None):
    """Advance every live lane by backward extensions until all are dead,
    ``max_steps`` are spent in all (across stages: ``t0`` carries in) or
    — with ``fit`` > 0 — the live count fits a ``fit``-wide continuation.

    state: dict of tensors over M lanes: k, l, s, mh (dt); rid, i, death,
    slot (int32); alive (bool); optionally steps (int32, the executed
    extensions per lane: an mh-death counts its killing call, an N or
    past-start death does not).  With ``rwflat`` (packed_rev_windows) a
    segment's chars decode from ONE window gather per lane: a lane alive
    at local step t sits at i0 - t.  Returns (state, t)."""
    SEG = max(1, min(REV_W, max_steps))
    st = dict(state)
    t = t0
    while t < max_steps and int(st["alive"].sum()) > fit:
        if rwflat is not None:
            idx = (st["rid"].to(_I64) * L + st["i"].clamp(0, L - 1)).clamp(
                0, rwflat.shape[0] - 1)
            rw = rwflat[idx]
        for tl in range(min(SEG, max_steps - t)):
            alive, i = st["alive"], st["i"]
            if rwflat is None:
                src = qflat[(st["rid"].to(_I64) * L + i).clamp(
                    0, qflat.shape[0] - 1)].to(_I32)
            else:
                src = (rw >> (3 * tl)) & 7
            base = torch.where(i >= 0, src, 4)
            okc = dfm.extend_sel_batch(
                fm, torch.stack([st["k"], st["l"], st["s"]], dim=-1),
                base.clamp(0, 3), is_back=True)
            survive = alive & (base < 4) & (okc[:, 2] >= st["mh"])
            if "steps" in st:
                st["steps"] = st["steps"] + (alive & (base < 4)).to(_I32)
            st["death"] = torch.where(alive & ~survive, i, st["death"])
            st["alive"] = survive
            st["k"] = torch.where(survive, okc[:, 0], st["k"])
            st["l"] = torch.where(survive, okc[:, 1], st["l"])
            st["s"] = torch.where(survive, okc[:, 2], st["s"])
            st["i"] = torch.where(survive, i - 1, i)
            t += 1
    return st, t


def compact_state(state, new_size: int):
    """Sort live lanes to the front (stable) and slice to new_size.
    Returns (live state, ovf): ovf when more than new_size were live."""
    alive = state["alive"]
    take = _rank_order(alive)[:new_size]
    return {k: v[take] for k, v in state.items()}, alive.sum() > new_size


def walk_pool(fm: DeviceFMIndex, qflat, L: int, pool, stages, mh=None,
              rwflat=None):
    """Run the staged backward walks for every valid pool row.

    pool: (GP, 7) as from build_pool; a pivot-0 row dies on its first
    step (i0 == -1), which reproduces the pivot==0 fast path.  stages:
    (lane_cap, max_steps) with decreasing caps; each stage walks until
    the live count fits the next cap, so compaction never overflows.
    mh: per-row min_hits (GP,), 1 if omitted.
    Returns (death (GP,) int32, fk, fl, fs (GP,), ovf, calls)."""
    dt = fm.dtype
    dev = pool.device
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    if mh is None:
        mh = torch.ones(GP, dtype=dt, device=dev)
    state = dict(
        k=pool[:, 0], l=pool[:, 1], s=pool[:, 2],
        rid=pool[:, 5].to(_I32), i=pool[:, 4].to(_I32) - 1,
        death=torch.full((GP,), -2, dtype=_I32, device=dev),
        mh=mh.to(dt).clamp(min=1), alive=valid,
        slot=torch.where(valid, torch.arange(GP, dtype=_I32, device=dev), -1),
        steps=torch.zeros(GP, dtype=_I32, device=dev))
    death = torch.full((GP,), -2, dtype=_I32, device=dev)
    fk, fl, fs = pool[:, 0], pool[:, 1], pool[:, 2]
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    calls = torch.zeros((), dtype=_I64, device=dev)
    t = 0
    caps = [cap for cap, _ in stages]
    for idx, cap in enumerate(caps):
        if idx > 0:
            state, o = compact_state(state, cap)
            ovf = ovf | o                   # never fires: exits are fit-gated
        fit = caps[idx + 1] if idx + 1 < len(caps) else 0
        state, t = walk_stage(fm, qflat, L, L + 2, state, t0=t, fit=fit,
                              rwflat=rwflat)
        finished = ~state["alive"] & (state["slot"] >= 0)
        sl = torch.where(finished, state["slot"], GP)
        death = _drop_set(death, sl, torch.where(finished, state["death"], 0))
        fk = _drop_set(fk, sl, torch.where(finished, state["k"], 0))
        fl = _drop_set(fl, sl, torch.where(finished, state["l"], 0))
        fs = _drop_set(fs, sl, torch.where(finished, state["s"], 0))
        calls = calls + torch.where(finished, state["steps"], 0).sum()
        state["steps"] = torch.where(finished, 0, state["steps"])
        # finished lanes must not scatter again in later stages
        state["slot"] = torch.where(finished, -1, state["slot"])
    ovf = ovf | state["alive"].any()
    calls = calls + state["steps"].sum()
    return death, fk, fl, fs, ovf, calls.to(_I32)


# ----------------------------------------------------------------------
# backward dedup by content hashes (the round-4 engines)
# ----------------------------------------------------------------------

def _pow_u32(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^n] mod 2^32 (int64 words)."""
    out = np.empty(n + 1, np.int64)
    v = 1
    for i in range(n + 1):
        out[i] = v
        v = (v * base) & 0xFFFFFFFF
    return out


def _poly_scan(a: torch.Tensor, base: int, bits: int) -> torch.Tensor:
    """h[:, i] = h[:, i-1] * base + a[:, i] mod 2**bits along dim 1 (h[:, -1]
    = 0): the JAX package's associative scan with the (m1*m2, a1*m2 + a2)
    combine.  Its arithmetic is exact modular, so this doubling scan
    gives the same words.  32-bit words are int64 in [0, 2**32), 64-bit
    words int64 bit patterns."""
    if bits == 32:
        def mul(x, c):
            return mul32(x, c)

        def add(x, y):
            return (x + y) & 0xFFFFFFFF
        m = 0xFFFFFFFF
    else:
        mul, add, m = mul64, add64, (1 << 64) - 1
    h = a
    d, pw = 1, base & m
    while d < a.shape[1]:
        h = torch.cat([h[:, :d], add(h[:, d:], mul(h[:, :-d], pw))], dim=1)
        d, pw = 2 * d, (pw * pw) & m
    return h


def prefix_hashes(qarr: torch.Tensor) -> torch.Tensor:
    """(R, L) codes -> (R, L, 2) 32-bit rolling hashes (int64 words);
    [:, i, :] covers q[:, :i+1].  A backward walk from position i consumes
    exactly the read prefix below its pivot, so (k, s, pivot, prefix
    hash) identifies a walk's full outcome across the batch."""
    q = qarr.to(_I64)
    h1 = _poly_scan(q + 1, 0x01000193, 32)          # FNV-32 odd multiplier
    h2 = _poly_scan(q + 5, 0x9E3779B9, 32)          # golden-ratio multiplier
    return torch.stack([h1, h2], dim=-1)


def _group_rows(keys, mixes, valid, CAP: int):
    """Group rows by exact key equality; sort by ONE avalanched 32-bit
    mix of ``mixes`` and compare every real key at the boundaries: a mix
    collision only splits a group, never merges one.

    Returns (rep_take (CAP,) one representative per group, group (M,)
    each row's group index, n_unique, ovf)."""
    dev = valid.device
    gh = mixes[0]
    for i, x in enumerate(mixes[1:]):
        gh = mul32(gh ^ mul32(x, 0x9E3779B9 + 2 * i), 0x85EBCA6B)
        gh = gh ^ (gh >> 15)
    # invalid rows sort last: 0x7FFFFFFF is int32-max; a valid mix that
    # ties with it only splits a group
    order = torch.argsort(torch.where(valid, gh >> 1, _I32_MAX).to(_I32),
                          stable=True)
    vs = valid[order]
    head = _group_heads([x[order] for x in keys], vs)
    gidx_sorted = torch.cumsum(head, 0) - 1
    n_u = head.sum().to(_I32)
    rep_take = _drop_set(
        torch.zeros(CAP, dtype=_I64, device=dev),
        torch.where(head & (gidx_sorted < CAP), gidx_sorted, CAP), order)
    group = gidx_sorted[_inverse_perm(order)].clamp(0, CAP - 1)
    return rep_take, group, n_u, n_u > CAP


def _fold32(x: torch.Tensor) -> torch.Tensor:
    """``(x ^ (x >> 31)).astype(uint32)`` of an index-dtype column."""
    x = x.to(_I64)
    return u32(x ^ (x >> 31))


def dedup_pool(pool, ph, CAP_U: int, mh=None):
    """Group pool rows whose walks must be identical (key: prefix hashes
    below the pivot, k, s, pivot, and mh when given); compact one
    representative per group to the front.

    Returns (rep_pool (CAP_U, 7), group (GP,) each row's representative,
    n_unique, ovf, rep_take)."""
    dev = pool.device
    L = ph.shape[1]
    valid = pool[:, 6] != 0
    piv = pool[:, 4].to(_I64)
    pidx = pool[:, 5].to(_I64) * L + (piv - 1).clamp(0, L - 1)
    phf = ph.reshape(-1, 2)
    hrow = torch.where(piv > 0, phf[pidx, 0], 0)
    hrow2 = torch.where(piv > 0, phf[pidx, 1], 0)
    keys = [hrow, hrow2, pool[:, 0], pool[:, 2], piv]
    # 32-bit folds feed the sort mix only; the boundary compare uses the
    # exact keys
    mixes = [hrow, hrow2, _fold32(pool[:, 0]), _fold32(pool[:, 2]), u32(piv)]
    if mh is not None:
        keys.append(mh)
        mixes.append(u32(mh))
    rep_take, group, n_u, ovf = _group_rows(keys, mixes, valid, CAP_U)
    rep_pool = pool[rep_take]
    rep_pool[:, 6] = (torch.arange(CAP_U, device=dev) < n_u).to(pool.dtype)
    return rep_pool, group, n_u, ovf, rep_take


def walk_pool_dedup(fm: DeviceFMIndex, qflat, ph, L: int, pool, stages,
                    Wb: int = 8, mh=None, rwflat=None):
    """Backward walks with CONTENT-WINDOW dedup: a walk's next Wb steps
    depend only on (k, s, the Wb chars below its position, min_hits), not
    on the position, so

      1. rows group by (k, s, hash(window), wlen, mh), wlen = min(pivot,
         Wb);
      2. one representative per group walks up to Wb steps (fit-gated at
         the third stage's cap);
      3. groups whose representative died adopt its outcome (death
         shifted by the pivot delta, l by the initial-l delta);
      4. survivors re-enter at their post-window state through the exact
         whole-walk dedup (dedup_pool) and the staged walk.

    Returns (death, fk, fl, fs (GP,), ovf, calls, n_groups)."""
    dt = fm.dtype
    dev = pool.device
    GP = pool.shape[0]
    R, Lh = ph.shape[0], ph.shape[1]
    valid = pool[:, 6] != 0
    piv = pool[:, 4].to(_I64)
    mh_arr = torch.ones(GP, dtype=dt, device=dev) if mh is None else \
        mh.to(dt).clamp(min=1)

    # rolling hash of the wlen chars below the pivot: P[n] covers the
    # first n chars; W(a, b) = P[b] - P[a] * M^(b-a)
    pz = ph.new_zeros((R, 1))
    P1 = torch.cat([pz, ph[:, :, 0]], dim=1).reshape(-1)
    P2 = torch.cat([pz, ph[:, :, 1]], dim=1).reshape(-1)
    wlen = piv.clamp(max=Wb)
    bidx = pool[:, 5].to(_I64) * (Lh + 1)
    pw1 = torch.from_numpy(_pow_u32(0x01000193, Wb)).to(dev)[wlen]
    pw2 = torch.from_numpy(_pow_u32(0x9E3779B9, Wb)).to(dev)[wlen]
    wh1 = (P1[bidx + piv] - mul32(P1[bidx + piv - wlen], pw1)) & 0xFFFFFFFF
    wh2 = (P2[bidx + piv] - mul32(P2[bidx + piv - wlen], pw2)) & 0xFFFFFFFF

    keys = [wh1, wh2, pool[:, 0], pool[:, 2], wlen, mh_arr]
    mixes = [wh1, wh2, _fold32(pool[:, 0]), _fold32(pool[:, 2]), wlen,
             u32(mh_arr)]
    CAP0 = stages[0][0]
    rep_take, group, n_groups, ovf0 = _group_rows(keys, mixes, valid, CAP0)

    # probe: one representative per group walks up to Wb steps, fit-gated
    # two caps down (survivors continue exactly through the full-prefix
    # path from wherever the probe stopped)
    rp = pool[rep_take]
    rep_valid = torch.arange(CAP0, device=dev) < n_groups
    st = dict(
        k=rp[:, 0], l=rp[:, 1], s=rp[:, 2], rid=rp[:, 5].to(_I32),
        i=rp[:, 4].to(_I32) - 1,
        death=torch.full((CAP0,), -2, dtype=_I32, device=dev),
        mh=mh_arr[rep_take].clamp(min=1), alive=rep_valid,
        slot=torch.where(rep_valid,
                         torch.arange(CAP0, dtype=_I32, device=dev), -1),
        steps=torch.zeros(CAP0, dtype=_I32, device=dev))
    fit0 = stages[2][0] if len(stages) > 2 else 0
    st, _ = walk_stage(fm, qflat, L, Wb, st, fit=fit0, rwflat=rwflat)
    calls = st["steps"].sum()

    rep_done = ~st["alive"]
    rl0 = rp[:, 1]
    shift = (piv - rp[:, 4].to(_I64)[group]).to(_I32)
    g_done = rep_done[group] & valid
    g_live = ~rep_done[group] & valid
    l_rebased = st["l"][group] - rl0[group] + pool[:, 1]

    # survivors: members continue from the representative's post-window
    # state at their own (shifted) position
    cont_pool = torch.stack([
        st["k"][group], l_rebased, st["s"][group], pool[:, 3],
        (st["i"][group] + shift + 1).to(dt), pool[:, 5],
        g_live.to(dt)], dim=1).to(pool.dtype)
    CAP1 = stages[1][0] if len(stages) > 1 else CAP0
    rep2, group2, _n2, dovf, take2 = dedup_pool(cont_pool, ph, CAP1,
                                                mh=mh_arr)
    d2r, fk2r, fl2r, fs2r, wovf2, calls2 = walk_pool(
        fm, qflat, L, rep2, stages[1:] if len(stages) > 1 else stages,
        mh=mh_arr[take2], rwflat=rwflat)

    death = torch.where(g_done, st["death"][group] + shift,
                        torch.where(g_live, d2r[group2], -2))
    fk = torch.where(g_done, st["k"][group],
                     torch.where(g_live, fk2r[group2], pool[:, 0]))
    fl = torch.where(g_done, l_rebased,
                     torch.where(g_live, fl2r[group2] - rep2[group2, 1] +
                                 cont_pool[:, 1], pool[:, 1]))
    fs = torch.where(g_done, st["s"][group],
                     torch.where(g_live, fs2r[group2], pool[:, 2]))
    return (death, fk, fl, fs, ovf0 | dovf | wovf2,
            (calls + calls2).to(_I32), n_groups)


def walk_pool_chain(fm: DeviceFMIndex, rwflat, L: int, pool, CAPW: int,
                    mh=None, W: int = REV_W, segs=(1, 4, 16)):
    """Backward walks in W-char CHAINED ROUNDS with per-round exact
    content grouping.  Per round, every live walk is grouped by (k, s,
    the W chars below its position packed exactly into one word); ONE
    representative per group runs W backward extends (_chain_walk), and
    every member evaluates its own death (min_hits or ambiguous char) on
    the shared chain states.  The lane width drops by ``segs`` divisors
    with stable rank-scatter compaction.

    pool: (GP, >=7) rows (cols k, l, s, end, pivot, rid, valid[, task]).
    Returns (death, fk, fl, fs (GP,), ovf, calls, n_groups)."""
    dt = fm.dtype
    dev = pool.device
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    mh_all = torch.ones(GP, dtype=dt, device=dev) if mh is None else \
        mh.to(dt).clamp(min=1)
    n_valid = valid.sum()
    ovf = n_valid > CAPW
    ALL4 = sum(4 << (3 * j) for j in range(REV_W))

    # stable rank-scatter compaction of valid rows into CAPW lanes
    crank = torch.cumsum(valid, 0) - 1
    tgt = torch.where(valid, crank, CAPW)

    def compact(col, dtype=None):
        z = torch.zeros(CAPW, dtype=dtype or col.dtype, device=dev)
        return _drop_set(z, tgt, col)

    ar_gp = torch.arange(GP, dtype=_I32, device=dev)
    st = dict(
        k=compact(pool[:, 0]), l=compact(pool[:, 1]), s=compact(pool[:, 2]),
        rid=compact(pool[:, 5], _I32),
        i=compact(pool[:, 4].to(_I32) - 1, _I32),
        mh=compact(mh_all),
        slot=compact(torch.where(valid, ar_gp, GP), _I32),
        alive=torch.arange(CAPW, device=dev) < n_valid,
    )
    death = torch.full((GP,), -2, dtype=_I32, device=dev)
    fk, fl, fs = pool[:, 0], pool[:, 1], pool[:, 2]
    calls = torch.zeros((), dtype=_I32, device=dev)
    ngrp = torch.zeros((), dtype=_I32, device=dev)
    rnd = 0
    RCAP = L + 2
    jj = torch.arange(W, device=dev)[None, :]
    big_mh = torch.iinfo(dt).max

    def body(st, w: int, Uw: int):
        nonlocal death, fk, fl, fs, calls, ngrp
        alive = st["alive"]
        k, l, s, i = st["k"], st["l"], st["s"], st["i"]
        idx = (st["rid"].to(_I64) * L + i.clamp(0, L - 1)).clamp(
            0, rwflat.shape[0] - 1)
        rw = torch.where(i >= 0, rwflat[idx], ALL4)

        # ---- group by exact (window, k, s); sort on one 32-bit mix
        # (a collision only splits a group), boundary-compare full keys
        mix = rw ^ mul32(u32(k) ^ u32(k.to(_I64) >> 31), 0x9E3779B9) ^ \
            mul32(u32(s) ^ u32(s.to(_I64) >> 31), 0x85EBCA6B)
        mix = mul32(mix ^ (mix >> 15), 0xC2B2AE35)
        order = torch.argsort(torch.where(alive, mix >> 1, _I32_MAX)
                              .to(_I32), stable=True)
        vs = alive[order]
        head = _group_heads([rw[order], k[order], s[order]], vs)
        gidx_sorted = torch.cumsum(head, 0) - 1
        n_u = head.sum()
        n_w = torch.clamp(n_u, max=Uw)
        rep_take = _drop_set(
            torch.zeros(Uw, dtype=_I64, device=dev),
            torch.where(head & (gidx_sorted < Uw), gidx_sorted, Uw), order)
        gidx_lane = gidx_sorted[_inverse_perm(order)]
        group = gidx_lane.clamp(0, Uw - 1)
        walked = alive & (gidx_lane < n_w)

        # ---- one representative per group walks backward extends,
        # stopping at the group's smallest min_hits
        rep_valid = (torch.arange(Uw, device=dev) < n_w) & alive[rep_take]
        gmin = torch.full((Uw,), big_mh, dtype=dt, device=dev).scatter_reduce(
            0, gidx_sorted.clamp(0, Uw - 1),
            torch.where(vs & (gidx_sorted < Uw), st["mh"][order],
                        _I32_MAX), "amin", include_self=True)
        rep_rw = rw[rep_take]
        rep_bases = torch.stack([(rep_rw >> (3 * j)) & 7 for j in range(W)],
                                dim=1)
        rk, rl_, rs = k[rep_take], l[rep_take], s[rep_take]
        ck, cl, cs, ln = _chain_walk(fm, rep_bases, W, rk, rl_, rs,
                                     rep_valid, is_back=True, stop_s=gmin)
        calls = calls + torch.where(rep_valid, ln, 0).sum().to(_I32)
        ngrp = ngrp + n_w.to(_I32)

        # ---- every walked lane consumes the shared chain; k and s are
        # group-identical, l re-bases by the member offset
        CK = ck[group]
        CS = cs[group]
        CL = cl[group] + (l - rl_[group])[:, None]
        lng = ln[group][:, None]
        real = jj < lng
        amb_here = (jj == lng) & (lng < W)
        die_j = amb_here | (real & (CS < st["mh"][:, None]))
        died = die_j.any(1) & walked
        dj = torch.argmax(die_j.to(torch.uint8), dim=1)
        # state at the death = state BEFORE the killing step
        djc = dj[:, None]
        dK = torch.gather(torch.cat([k[:, None], CK[:, :-1]], 1), 1, djc)[:, 0]
        dL = torch.gather(torch.cat([l[:, None], CL[:, :-1]], 1), 1, djc)[:, 0]
        dS = torch.gather(torch.cat([s[:, None], CS[:, :-1]], 1), 1, djc)[:, 0]
        dsl = torch.where(died, st["slot"], GP)
        death = _drop_set(death, dsl, torch.where(died, i - dj.to(_I32), 0))
        fk = _drop_set(fk, dsl, torch.where(died, dK, 0))
        fl = _drop_set(fl, dsl, torch.where(died, dL, 0))
        fs = _drop_set(fs, dsl, torch.where(died, dS, 0))

        # ---- survivors advance W chars; un-walked lanes retry
        through = walked & ~died
        st = dict(st)
        st["k"] = torch.where(through, CK[:, W - 1], k)
        st["l"] = torch.where(through, CL[:, W - 1], l)
        st["s"] = torch.where(through, CS[:, W - 1], s)
        st["i"] = torch.where(through, i - W, i)
        st["alive"] = alive & ~died
        return st

    lane_keys = ("k", "l", "s", "rid", "i", "mh", "slot")
    widths = []
    for d in segs:
        w2 = max(CAPW // d, 256)
        if not widths or w2 < widths[-1]:
            widths.append(w2)
    for ix, w in enumerate(widths):
        nxtw = widths[ix + 1] if ix + 1 < len(widths) else 0
        while rnd < RCAP and int(st["alive"].sum()) > nxtw:
            st = body(st, w, max(w // 2, 64))
            rnd += 1
        if nxtw:
            lalive = st["alive"]
            tgt2 = torch.where(lalive, torch.cumsum(lalive, 0) - 1, nxtw)
            st = {kk: _drop_set(torch.zeros(nxtw, dtype=st[kk].dtype,
                                            device=dev), tgt2, st[kk])
                  for kk in lane_keys + ("alive",)}
    ovf = ovf | st["alive"].any()
    return death, fk, fl, fs, ovf, calls, ngrp


def reconstruct(pool, death, fk, fl, fs, min_seed_len: int, group_cols):
    """Emission flags + SMEM rows from walked pool rows.  Within a group
    run (push order) emit(p) <=> last row of group OR death[p] <
    death[p+1], with beg = death+1, end = row end, interval = walked
    final state (comp_seed.cpp:114-137).  Returns (emit, rid, k, l, s,
    beg, end), all (GP,)."""
    valid = pool[:, 6] != 0
    same = pool[1:, 6] != 0
    for c in group_cols:
        g = pool[:, c]
        same = same & (g[1:] == g[:-1])
    nxt_same = valid & torch.cat([same, same.new_zeros(1)])
    is_last = valid & ~nxt_same
    death_next = torch.cat([death[1:], death.new_full((1,), -2)])
    emit = valid & (is_last | (death < death_next))
    beg = death + 1
    end = pool[:, 3].to(_I32)
    ok = emit & ((end - beg) >= min_seed_len) & (fs > 0)
    return ok, pool[:, 5].to(_I32), fk, fl, fs, beg, end


# splitmix64-style avalanche constants for the memo's slot hash and the
# staged forward engine's group hash
_MX1 = 0xBF58476D1CE4E5B9
_MX2 = 0x94D049BB133111EB
_MX3 = 0x9E3779B97F4A7C15


# ----------------------------------------------------------------------
# staged forward sweep worklist with cross-read dedup (the forward SST,
# mapping/SST.h:60-71), selected by COMPSEED_FWD_MEMO=0
# ----------------------------------------------------------------------

_BM1 = 0x100000001B3
_BM2 = 0x9E3779B97F4A7C15
_SALT1 = 1
_SALT2 = 5


def _pow_u64(base: int, e: int) -> int:
    """base**e mod 2**64."""
    return pow(base, e, 1 << 64)


def padded_prefix_state(qarr: torch.Tensor, pad: int):
    """Prefix-hash accumulators of the rows extended with ``pad`` 4s, each
    (R, L+pad+1) of 64-bit words: A[r, p] = poly hash of row[:p] for two
    independent bases.  The window hash of row[p:p+B] is A[p+B] -
    A[p] * BM**B — the per-stage dedup key."""
    R, L = qarr.shape
    ext = torch.cat([qarr.to(_I64), torch.full((R, pad), 4, dtype=_I64,
                                                device=qarr.device)], dim=1)
    z = ext.new_zeros((R, 1))
    return tuple(torch.cat([z, _poly_scan(ext + salt, base, 64)], dim=1)
                 for base, salt in ((_BM1, _SALT1), (_BM2, _SALT2)))


def _fwd_stage_walk(fm: DeviceFMIndex, qflat, nxtflat, L: int, B: int,
                    state, mh, advance: bool, mode: str = "lep",
                    min_len: int = 0, max_intv: int = 0):
    """Walk up to B forward-sweep iterations for U representative lanes,
    pivot respawns included, as long as every consumed position stays in
    the lane's content window [pos0, pos0+B) — the region the dedup key
    hashes, so group members behave identically.  Lanes whose sweep
    leaves the window freeze until the stage boundary; amb stops whose
    next pivot lies outside it park in ``waiting`` for the boundary
    respawn.

    state: k, l, s (dt), pos, pivot, rid (int32), alive (bool) over U.
    Returns the final state plus per-step push records (pf, pk, pl, ps,
    pe, pp: (U, B)), waiting / wait_npv and per-lane occ-step counts."""
    dt = fm.dtype
    dev = state["k"].device
    U = state["k"].shape[0]
    nq = qflat.shape[0]
    pos_end = state["pos"] + B                        # window limit
    r3 = mode == "r3"
    st = dict(state)
    st["waiting"] = torch.zeros(U, dtype=torch.bool, device=dev)
    st["wait_npv"] = torch.zeros(U, dtype=_I32, device=dev)
    st["steps"] = torch.zeros(U, dtype=_I32, device=dev)
    st["pf"] = torch.zeros((U, B), dtype=torch.bool, device=dev)
    for key in ("pk", "pl", "ps"):
        st[key] = torch.zeros((U, B), dtype=dt, device=dev)
    st["pe"] = torch.zeros((U, B), dtype=_I32, device=dev)
    st["pp"] = torch.zeros((U, B), dtype=_I32, device=dev)

    def char(p):
        return torch.where(p < L, qflat[(st["rid"].to(_I64) * L + p).clamp(
            0, nq - 1)].to(_I32), 4)

    def body(j):
        pos, pivot = st["pos"], st["pivot"]
        k, l, s = st["k"], st["l"], st["s"]
        active = st["alive"] & (pos < pos_end)
        base = char(pos)
        okc = dfm.extend_sel_batch(fm, torch.stack([k, l, s], dim=-1),
                                   3 - base.clamp(0, 3), is_back=False)
        amb = base > 3
        if r3:
            # greedy round-3 segment (bwt_seed_strategy1, bwt.c:358-379):
            # emit the POST-extension interval when it first drops below
            # max_intv at length >= min_len, then restart past it
            hit = active & ~amb & (okc[:, 2] < max_intv) & \
                ((pos - pivot) >= min_len)
            push = hit
            stop = active & (hit | amb)
            rec = (okc[:, 0], okc[:, 1], okc[:, 2], pos + 1)
        else:
            changed = okc[:, 2] != s
            push = active & (amb | changed)
            stop = active & (amb | (changed & (okc[:, 2] < mh)))
            rec = (k, l, s, pos)
        cont = active & ~stop
        st["pf"][:, j] = push
        for key, v in zip(("pk", "pl", "ps", "pe"), rec):
            st[key][:, j] = v
        st["pp"][:, j] = pivot
        st["steps"] = st["steps"] + active.to(_I32)

        k = torch.where(cont, okc[:, 0], k)
        l = torch.where(cont, okc[:, 1], l)
        s = torch.where(cont, okc[:, 2], s)
        newpos = torch.where(cont, pos + 1, pos)
        alive = st["alive"] & ~stop
        if advance:
            # in-window respawn: a non-amb stop re-consumes ``pos`` as the
            # new pivot; an amb stop (any stop in round 3) jumps to the
            # next non-amb if it stays inside the window, else parks for
            # the boundary respawn
            rs_here = torch.zeros_like(stop) if r3 else stop & ~amb
            npv = pos + 1
            nx = torch.where(npv < L, nxtflat[(st["rid"].to(_I64) * L + npv)
                                              .clamp(0, nq - 1)], L)
            in_win = (nx < pos_end) & (nx < L)
            jumper = stop if r3 else stop & amb
            park = jumper & ~in_win
            newpiv = torch.where(rs_here, pos, nx)
            baseN = char(newpiv)
            ikN = _set_intv(fm, baseN.clamp(0, 3)).T
            # a jump target that is padding (no pivot left) ends the lane
            respawn = (rs_here | (jumper & in_win)) & (baseN < 4)
            st["pivot"] = torch.where(respawn, newpiv, pivot)
            k = torch.where(respawn, ikN[:, 0], k)
            l = torch.where(respawn, ikN[:, 1], l)
            s = torch.where(respawn, ikN[:, 2], s)
            newpos = torch.where(respawn, newpiv + 1, newpos)
            alive = alive | respawn
            st["waiting"] = st["waiting"] | park
            st["wait_npv"] = torch.where(park, npv, st["wait_npv"])
        st.update(k=k, l=l, s=s, pos=newpos, alive=alive)

    # segmented loop: the any-live test every 8 steps; steps past B are
    # frozen, as the JAX loop's guard does
    j = 0
    while j < B and bool((st["alive"] & (st["pos"] < pos_end)).any()):
        for _ in range(min(8, B)):
            if j < B:
                body(j)
                j += 1
    return st


def fwd_stages_for(R: int, L: int):
    """Stage schedule (rep_cap, step_budget) for the round-1 forward scan:
    budgets sum past the worst case ~2L; rep caps below R are where the
    gather savings come from, sized for ~25-30 % sharing."""
    MAXW = L + 2
    return [(R, 8), (R, 8), (R - R // 8, 16), (R - R // 4, 32),
            (R - R // 4, 64), (R - R // 4, MAXW), (R // 2, MAXW)]


def forward_scan_dedup(fm: DeviceFMIndex, qarr, rlens, GP: int, stages,
                       min_hits=None, pivots0=None, rids=None,
                       advance: bool = True, mode: str = "lep",
                       min_len: int = 0, max_intv: int = 0,
                       record_lane_index: bool = False, active=None):
    """Forward LEP scan with cross-read sweep deduplication, stage by
    stage: each stage groups the live lanes by (l, s, the B-char content
    window, mh[, segment length in round 3]) and walks one representative
    per group for up to B steps (_fwd_stage_walk); every member adopts its
    representative's pushes and state, positions shifted by its offset and
    k by its entry-k delta (a forward step ranks at l, so k only carries a
    member offset).  Produces the pool of make_scan + build_pool, rows
    (k, l, s, end, pivot, rid, valid) in (rid, pivot, end) order.  The
    stage boundaries are part of the result: fq/fc and the groups depend
    on each stage's width and budget.

    Returns (pool (GP, 7), n_rows, ovf, fwd_queries, fwd_calls)."""
    dt = fm.dtype
    dev = qarr.device
    R, L = qarr.shape
    n_lanes = R if rids is None else rids.shape[0]
    qflat = qarr.reshape(-1)
    nq = qflat.shape[0]
    rlens = rlens.to(_I32)
    max_b = max(b for _, b in stages)
    A1, A2 = padded_prefix_state(qarr, max_b)
    nxt = next_nonamb(qarr)
    nxtflat = nxt.reshape(-1)
    lane_rid = torch.arange(R, dtype=_I32, device=dev) if rids is None \
        else rids.to(_I32)
    lr = lane_rid.to(_I64)
    lane_rlen = rlens[lr]
    mh = torch.ones(n_lanes, dtype=dt, device=dev) if min_hits is None \
        else min_hits.to(dt).clamp(min=1)

    # initial spawn (phase 0 of the lockstep scan): pivot = first non-amb
    p0 = torch.zeros(n_lanes, dtype=_I32, device=dev) if pivots0 is None \
        else pivots0.to(_I32)
    pivot = nxt[lr, p0.clamp(0, L - 1).to(_I64)]
    alive = (pivot < lane_rlen) & (lane_rlen > 0)
    if pivots0 is not None:
        alive = alive & (p0 < lane_rlen)
    if active is not None:
        alive = alive & active

    def spawn(piv):
        base = qflat[(lr * L + piv).clamp(0, nq - 1)]
        return _set_intv(fm, base.clamp(0, 3)).T, base

    ik0, _ = spawn(pivot)
    k = torch.where(alive, ik0[:, 0], 0)
    l = torch.where(alive, ik0[:, 1], 0)
    s = torch.where(alive, ik0[:, 2], 0)
    pos = pivot + 1

    # the pool as six columns; pushes fill slots contiguously, so
    # validity is synthesized from the cursor
    pool_c = [torch.zeros(GP, dtype=dt, device=dev) for _ in range(6)]
    cursor = torch.zeros((), dtype=_I64, device=dev)
    povf = torch.zeros((), dtype=torch.bool, device=dev)
    uovf = torch.zeros((), dtype=torch.bool, device=dev)
    fq = torch.zeros((), dtype=_I64, device=dev)
    fc = torch.zeros((), dtype=_I64, device=dev)
    lanes = torch.arange(n_lanes, device=dev)
    big = int(np.iinfo(np.int64).max)

    for U, B in stages:
        U = min(U, n_lanes)
        # ---- group lanes by (l-interval, B-char content window, mh); NOT
        # by position (overlapping reads share walks at different
        # offsets) and on l, not k: a forward step ranks at l
        pcol = pos.clamp(0, L).to(_I64)
        w1 = sub64(A1[lr, pcol + B], mul64(A1[lr, pcol], _pow_u64(_BM1, B)))
        w2 = sub64(A2[lr, pcol + B], mul64(A2[lr, pcol], _pow_u64(_BM2, B)))
        valid = alive
        keys = [w1, w2, l.to(_I64), s.to(_I64), mh.to(_I64)]
        if mode == "r3":
            # the hit test reads the segment length, so members share it
            keys.append((pos - pivot).to(_I64))
        # sort by ONE avalanched 64-bit mix; the boundary test compares
        # every key, so a mix collision only splits a group
        gh = keys[0]
        for i, x in enumerate(keys[1:]):
            gh = mul64(gh ^ mul64(x, _MX1 + 2 * i), _MX3)
            gh = gh ^ lsr64(gh, 31)
        order = torch.argsort(torch.where(valid, lsr64(gh, 1), big),
                              stable=True)
        vs = valid[order]
        head = _group_heads([x[order] for x in keys], vs)
        gidx_sorted = torch.cumsum(head, 0) - 1
        n_u = head.sum()
        uovf = uovf | (n_u > U)
        rep_take = _drop_set(
            torch.zeros(U, dtype=_I64, device=dev),
            torch.where(head & (gidx_sorted < U), gidx_sorted, U), order)
        group = gidx_sorted[_inverse_perm(order)].clamp(0, U - 1)

        # ---- walk the representatives
        rep_valid = torch.arange(U, device=dev) < n_u
        st = _fwd_stage_walk(
            fm, qflat, nxtflat, L, B,
            dict(k=k[rep_take], l=l[rep_take], s=s[rep_take],
                 pos=pos[rep_take], pivot=pivot[rep_take],
                 rid=lane_rid[rep_take], alive=alive[rep_take] & rep_valid),
            mh[rep_take], advance, mode=mode, min_len=min_len,
            max_intv=max_intv)
        fq = fq + torch.where(valid, st["steps"][group], 0).sum()
        fc = fc + torch.where(rep_valid, st["steps"], 0).sum()

        # ---- scatter outcomes to every member: positions shift by the
        # lane's offset; a recorded pivot equal to the representative's
        # entry pivot predates any in-stage respawn (respawned pivots are
        # >= the entry pos), so it maps to the member's own entry pivot
        # and carries the member's entry-k offset
        was = alive
        delta = pos - pos[rep_take][group]
        piv0_g = pivot[rep_take][group]
        dk = k - k[rep_take][group]
        pf = st["pf"][group] & was[:, None]                    # (n, B)
        pp = st["pp"][group]
        pre_respawn = pp == piv0_g[:, None]
        pk = st["pk"][group]
        row_id = lanes if record_lane_index else lane_rid
        cols = (torch.where(pre_respawn, pk + dk[:, None], pk),
                st["pl"][group], st["ps"][group],
                st["pe"][group] + delta[:, None],
                torch.where(pre_respawn, pivot[:, None], pp + delta[:, None]),
                row_id[:, None].expand(n_lanes, B))
        pflat = pf.reshape(-1)
        slot = torch.where(pflat, cursor + torch.cumsum(pflat, 0) - 1, GP)
        pool_c = [_drop_set(c, slot, v.reshape(-1))
                  for c, v in zip(pool_c, cols)]
        cursor = cursor + pflat.sum()
        povf = povf | (cursor > GP)

        gpiv = st["pivot"][group]
        gk = st["k"][group]
        k = torch.where(was, torch.where(gpiv == piv0_g, gk + dk, gk), k)
        l = torch.where(was, st["l"][group], l)
        s = torch.where(was, st["s"][group], s)
        pivot = torch.where(was, torch.where(gpiv == piv0_g, pivot,
                                             gpiv + delta), pivot)
        pos = torch.where(was, st["pos"][group] + delta, pos)
        still = was & st["alive"][group]

        # ---- boundary respawn for amb stops whose next pivot fell
        # outside the stage window
        if advance:
            parked = was & st["waiting"][group]
            wait_npv = st["wait_npv"][group] + delta
            newpiv = torch.where(
                wait_npv >= L, L,
                nxt[lr, wait_npv.clamp(0, L - 1).to(_I64)])
            respawn = parked & (newpiv < lane_rlen)
            ikN, _ = spawn(newpiv)
            pivot = torch.where(respawn, newpiv, pivot)
            k = torch.where(respawn, ikN[:, 0], k)
            l = torch.where(respawn, ikN[:, 1], l)
            s = torch.where(respawn, ikN[:, 2], s)
            pos = torch.where(respawn, newpiv + 1, pos)
            alive = still | respawn
        else:
            alive = still

    ovf = povf | uovf | alive.any()

    # ---- final order: valid rows by (rid, pivot, end) = push order, as
    # one packed key (bounds are static)
    pvalid = torch.arange(GP, device=dev) < cursor
    EB = 2 * L + max_b + 4            # conservative: end < L in practice
    PB = 2 * L + 4                    # conservative: pivot < L in practice
    kdt = _I32 if (max(R, n_lanes) + 2) * EB * PB < 2**31 else _I64
    okey = (pool_c[5].to(kdt) * PB + pool_c[4].to(kdt)) * EB + \
        pool_c[3].to(kdt)
    forder = torch.argsort(torch.where(pvalid, okey, torch.iinfo(kdt).max),
                           stable=True)
    pool = torch.stack([c[forder] for c in pool_c + [pvalid.to(dt)]], dim=1)
    return pool, cursor.to(_I32), ovf, fq.to(_I32), fc.to(_I32)

MEMO_KEYS = ("tbl", "cst", "cur")
# tbl column indices: window, l0, s0, k0, len, ptr, valid
_T_W, _T_L0, _T_S0, _T_K0, _T_LN, _T_P, _T_V = range(7)


def make_chain_memo(H: int, M: int, W: int, dt: torch.dtype,
                    device: torch.device) -> dict:
    """Zeroed chain-memo state (the cross-round SST): a direct-mapped
    table of H slots (power of two), one (H, 8) row per slot — columns
    [window, l0, s0, k0, len, ptr, valid, pad] — and an append-only
    chain store of M rows of (ck | cl | cs).  Collisions evict (newest
    wins) and a full store stops inserting: both only LOSE reuse."""
    if H & (H - 1):
        raise ValueError("H must be a power of two")
    if 3 * W > 32:
        raise ValueError("chain window must pack into 32 bits (W <= 10)")
    return dict(tbl=torch.zeros((H, 8), dtype=dt, device=device),
                cst=torch.zeros((M, 3 * W), dtype=dt, device=device),
                cur=torch.zeros((), dtype=_I32, device=device))


def _w_store(wv: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """uint32 window key -> its bijective image in the table dtype."""
    return wv if dt == torch.int64 else as_i32(wv)


def _slot_hash(wv, l, s, H: int) -> torch.Tensor:
    """Avalanched slot index in [0, H) from the full chain key (the
    uint64 arithmetic of the JAX package, as int64 bit patterns)."""
    z = wv ^ mul64(l.to(_I64), _MX1) ^ mul64(s.to(_I64), _MX2)
    z = mul64(z ^ lsr64(z, 33), _MX1)
    z = z ^ lsr64(z, 29)
    return z & (H - 1)


def _chain_walk(fm: DeviceFMIndex, bases, W: int, k, l, s, valid,
                is_back: bool = False, stop_s=None):
    """W pure extensions from (k, l, s) over the decoded window chars
    ``bases`` (U, W).  Forward mode extends on the complement
    (c = 3 - seq[i], comp_seed.cpp:78), backward mode on the char
    itself.  Recording stops at the first ambiguous base; ln < W encodes
    that offset.  With ``stop_s`` a backward rep also stops once its
    interval drops below the group's smallest min_hits.
    Returns (ck, cl, cs (U, W) post-extension states, ln (U,))."""
    ln = torch.zeros(k.shape[0], dtype=_I32, device=k.device)
    alive = valid
    ck, cl, cs = [], [], []
    for j in range(W):
        base = bases[:, j]
        step = alive & (base <= 3)
        cb = base.clamp(0, 3)
        c = cb if is_back else 3 - cb
        okc = dfm.extend_sel_batch(fm, torch.stack([k, l, s], dim=-1), c,
                                   is_back=is_back)
        k = torch.where(step, okc[:, 0], k)
        l = torch.where(step, okc[:, 1], l)
        s = torch.where(step, okc[:, 2], s)
        ck.append(k)
        cl.append(l)
        cs.append(s)
        ln = ln + step.to(_I32)
        alive = step
        if stop_s is not None:
            alive = alive & (s >= stop_s)
    return (torch.stack(ck, dim=1), torch.stack(cl, dim=1),
            torch.stack(cs, dim=1), ln)


def _chain_seg_divs() -> tuple[int, ...]:
    """Lane-width divisors for chain_scan's segmented loop (each
    continuation is n_lanes/d wide); "" disables segmentation."""
    v = os.environ.get("COMPSEED_CHAIN_SEGS", "4,16")
    return tuple(int(x) for x in v.split(",") if x)


def chain_scan(fm: DeviceFMIndex, qarr, rlens, GP: int, memo: dict,
               min_hits=None, pivots0=None, rids=None,
               advance: bool = True, mode: str = "lep",
               min_len: int = 0, max_intv: int = 0,
               record_lane_index: bool = False, active=None,
               W: int = CHAIN_W, u_cap: int | None = None):
    """Forward scan with the cross-round, cross-mode extension-chain memo.

    The unit of sharing is a CHAIN: W pure forward extensions from a
    bi-interval state, keyed by (l, s, the W upcoming chars packed
    exactly into one word).  Forward steps rank at l, so (l, s, content)
    determines every l_j/s_j of the chain while each consumer re-bases k
    by its own offset.  Chains carry no stop/push semantics: min_hits
    (round 2), the greedy round-3 rule and the LEP push/stop logic are
    evaluated lane-side, so ONE memo serves all three rounds (pass the
    dict returned by round k into round k+1).

    Per round each live lane probes the memo table; misses co-group by
    key and one representative per group walks the chain (u_cap bounds
    the walk width; excess groups wait a round).  The loop is segmented
    (stable compaction to narrower widths), exactly like the JAX loop.

    Returns (pool (GP, 7), n_rows, ovf, fq, fc, memo')."""
    dt = fm.dtype
    dev = qarr.device
    R, L = qarr.shape
    n_lanes = R if rids is None else rids.shape[0]
    U = u_cap if u_cap is not None else max(n_lanes // 2, 64)
    U = min(U, n_lanes)
    H = memo["tbl"].shape[0]
    M = memo["cst"].shape[0]
    RCAP = 3 * L + 16
    r3 = mode == "r3"

    qflat = qarr.reshape(-1)
    nq = qflat.shape[0]
    rlens = rlens.to(_I32)
    winflat = packed_windows(qarr, W)
    nxt = next_nonamb(qarr)
    lane_rid0 = torch.arange(R, dtype=_I32, device=dev) if rids is None \
        else rids.to(_I32)
    lane_rlen0 = rlens[lane_rid0.to(_I64)]
    mh0 = torch.ones(n_lanes, dtype=dt, device=dev) if min_hits is None \
        else min_hits.to(dt).clamp(min=1)
    row_id0 = torch.arange(n_lanes, dtype=_I32, device=dev) \
        if record_lane_index else lane_rid0

    p0 = torch.zeros(n_lanes, dtype=_I32, device=dev) if pivots0 is None \
        else pivots0.to(_I32)
    pivot = nxt[lane_rid0.to(_I64), p0.clamp(0, L - 1).to(_I64)]
    alive = (pivot < lane_rlen0) & (lane_rlen0 > 0)
    if pivots0 is not None:
        alive = alive & (p0 < lane_rlen0)
    if active is not None:
        alive = alive & active

    base0 = qflat[(lane_rid0.to(_I64) * L + pivot).clamp(0, nq - 1)]
    ik0 = _set_intv(fm, base0.clamp(0, 3)).T
    jj = torch.arange(W, dtype=_I32, device=dev)[None, :]

    zp = torch.zeros(GP, dtype=dt, device=dev)
    st = dict(memo)
    st.update(
        lane0=torch.arange(n_lanes, dtype=_I32, device=dev),
        pivot=pivot, pos=pivot + 1, alive=alive,
        k=torch.where(alive, ik0[:, 0], 0), l=torch.where(alive, ik0[:, 1], 0),
        s=torch.where(alive, ik0[:, 2], 0),
        pool_k=zp, pool_l=zp, pool_s=zp, pool_e=zp, pool_p=zp, pool_r=zp,
        cursor=torch.zeros((), dtype=_I32, device=dev),
        povf=torch.zeros((), dtype=torch.bool, device=dev),
        fq=torch.zeros((), dtype=_I32, device=dev),
        fc=torch.zeros((), dtype=_I32, device=dev))

    def body(st, w: int, Uw: int):
        st = dict(st)
        lane0 = st["lane0"].to(_I64)
        lane_rid = lane_rid0[lane0].to(_I64)
        lane_rlen = lane_rlen0[lane0]
        mh = mh0[lane0]
        row_id = row_id0[lane0]
        pivot, pos, lalive = st["pivot"], st["pos"], st["alive"]
        k, l, s = st["k"], st["l"], st["s"]
        pc = pos.clamp(0, L + 1).to(_I64)
        wv = winflat[lane_rid * (L + 2) + pc]           # exact W-char window

        # ---- probe the memo table (one row gather per lane), BEFORE
        # this round's inserts: a hit applies the entry it matched
        slot = _slot_hash(wv, l, s, H)
        wst = _w_store(wv, dt)
        trow = st["tbl"][slot]                          # (w, 8)
        hit = lalive & (trow[:, _T_V] != 0) & (trow[:, _T_W] == wst) & \
            (trow[:, _T_L0] == l) & (trow[:, _T_S0] == s)
        ptr = trow[:, _T_P].clamp(0, M - 1).to(_I64)
        hk0 = trow[:, _T_K0]
        hln = trow[:, _T_LN].to(_I32)

        # ---- group misses by (window, l, s): sort by slot (same key =>
        # same slot), boundary-compare the full key
        miss = lalive & ~hit
        order = torch.argsort(torch.where(miss, slot, H).to(_I32),
                              stable=True)
        vs = miss[order]
        head = _group_heads([wv[order], l[order], s[order]], vs)
        gidx_sorted = torch.cumsum(head, 0) - 1
        n_u = head.sum()
        n_w = torch.clamp(n_u, max=Uw)
        rep_take = _drop_set(
            torch.zeros(Uw, dtype=_I64, device=dev),
            torch.where(head & (gidx_sorted < Uw), gidx_sorted, Uw), order)
        gidx_lane = gidx_sorted[_inverse_perm(order)]
        group = gidx_lane.clamp(0, Uw - 1)
        walked = miss & (gidx_lane < n_w)

        # ---- representatives walk one chain each
        rep_valid = (torch.arange(Uw, device=dev) < n_w) & miss[rep_take]
        rep_wv = wv[rep_take]
        rep_bases = torch.stack([(rep_wv >> (3 * j)) & 7 for j in range(W)],
                                dim=1)
        rk, rl_, rs = k[rep_take], l[rep_take], s[rep_take]
        ck, cl, cs, ln = _chain_walk(fm, rep_bases, W, rk, rl_, rs,
                                     rep_valid)
        st["fc"] = st["fc"] + torch.where(rep_valid, ln, 0).sum().to(_I32)

        # ---- insert: chains append to the store (drop when full); the
        # table slot is overwritten whole (newest wins), one rep per slot
        rank = torch.cumsum(rep_valid, 0) - 1
        cptr = st["cur"] + rank
        can = rep_valid & (cptr < M)
        rslot = slot[rep_take]
        first = torch.ones_like(can)
        first[1:] = rslot[1:] != rslot[:-1]
        keep = first & can
        tslot = torch.where(keep, rslot, H)
        cidx = torch.where(can, cptr, M)
        st["cst"] = _drop_set(st["cst"], cidx, torch.cat([ck, cl, cs], 1))
        trows = torch.stack(
            [_w_store(rep_wv, dt), rl_, rs, rk, ln.to(dt), cptr.to(dt),
             torch.ones(Uw, dtype=dt, device=dev),
             torch.zeros(Uw, dtype=dt, device=dev)], dim=1)
        st["tbl"] = _drop_set(st["tbl"], tslot, trows)
        st["cur"] = st["cur"] + can.sum().to(_I32)

        # ---- apply: every lane consumes its chain (entry or rep walk)
        applied = hit | walked
        crow = st["cst"][ptr]
        hit2 = hit[:, None]

        def pick(lo, wbuf):
            return torch.where(hit2, crow[:, lo * W:(lo + 1) * W], wbuf[group])

        src_k0 = torch.where(hit, hk0, rk[group])
        src_ln = torch.where(hit, hln, ln[group])[:, None]
        CK = pick(0, ck) + (k - src_k0)[:, None]
        CL = pick(1, cl)
        CS = pick(2, cs)
        real = jj < src_ln
        amb_here = (jj == src_ln) & (src_ln < W)
        if r3:
            # bwt_seed_strategy1 (FM_index/bwt.c:358-379): emit the
            # POST-extension interval at the first position where it
            # drops below max_intv at length >= min_len
            hitj = real & (CS < max_intv) & \
                ((pos[:, None] + jj - pivot[:, None]) >= min_len)
            push = hitj
            stop = hitj | amb_here
            recK, recL, recS = CK, CL, CS
            recE = pos[:, None] + jj + 1
        else:
            prevs = torch.cat([s[:, None], CS[:, :-1]], 1)
            changed = CS != prevs
            small = CS < mh[:, None]
            push = (real & changed) | amb_here
            stop = (real & changed & small) | amb_here
            recK = torch.cat([k[:, None], CK[:, :-1]], 1)
            recL = torch.cat([l[:, None], CL[:, :-1]], 1)
            recS = prevs
            recE = pos[:, None] + jj
        has_stop = stop.any(1)
        t = torch.argmax(stop.to(torch.uint8), dim=1).to(_I32)
        t_eff = torch.where(has_stop, t, W)
        push = push & (jj <= t_eff[:, None]) & applied[:, None]
        cons = torch.where(has_stop, t + 1, W)
        st["fq"] = st["fq"] + torch.where(applied, cons, 0).sum().to(_I32)

        # ---- flush pushes (six column scatters)
        pflat = push.reshape(-1)
        pslot = torch.where(pflat, st["cursor"] + torch.cumsum(pflat, 0) - 1,
                            GP)
        for col, v in (("pool_k", recK), ("pool_l", recL), ("pool_s", recS),
                       ("pool_e", recE),
                       ("pool_p", pivot[:, None].expand(w, W)),
                       ("pool_r", row_id[:, None].expand(w, W))):
            st[col] = _drop_set(st[col], pslot, v.reshape(-1))
        st["cursor"] = st["cursor"] + pflat.sum().to(_I32)
        st["povf"] = st["povf"] | (st["cursor"] > GP)

        # ---- advance / respawn
        stop_pos = pos + t
        amb_stop = has_stop & (t == src_ln[:, 0])
        if r3:
            npv = stop_pos + 1
        else:
            npv = torch.where(amb_stop, stop_pos + 1, stop_pos)
        newpiv = torch.where(npv < L,
                             nxt[lane_rid, npv.clamp(0, L - 1).to(_I64)], L)
        respawn = applied & has_stop & (newpiv < lane_rlen)
        if not advance:
            respawn = torch.zeros_like(respawn)
        through = applied & ~has_stop
        baseN = qflat[(lane_rid * L + newpiv).clamp(0, nq - 1)]
        ikN = _set_intv(fm, baseN.clamp(0, 3)).T
        last = (src_ln - 1).clamp(0, W - 1).to(_I64)
        endK = torch.gather(CK, 1, last)[:, 0]
        endL = torch.gather(CL, 1, last)[:, 0]
        endS = torch.gather(CS, 1, last)[:, 0]
        st["k"] = torch.where(respawn, ikN[:, 0],
                              torch.where(through, endK, k))
        st["l"] = torch.where(respawn, ikN[:, 1],
                              torch.where(through, endL, l))
        st["s"] = torch.where(respawn, ikN[:, 2],
                              torch.where(through, endS, s))
        st["pivot"] = torch.where(respawn, newpiv, pivot)
        st["pos"] = torch.where(respawn, newpiv + 1,
                                torch.where(through, pos + W, pos))
        st["alive"] = torch.where(applied, respawn | through, lalive)
        return st

    # segment widths: each continuation is narrower, entered once the
    # alive count fits (bit-exact: lanes are only re-indexed)
    segs = [n_lanes]
    for d in _chain_seg_divs():
        w2 = max(n_lanes // d, 256)
        if w2 < segs[-1]:
            segs.append(w2)

    lane_keys = ("lane0", "pivot", "pos", "k", "l", "s", "alive")
    rnd = 0
    for ix, w in enumerate(segs):
        nxtw = segs[ix + 1] if ix + 1 < len(segs) else 0
        Uw = min(U, w)
        while rnd < RCAP and int(st["alive"].sum()) > nxtw:
            st = body(st, w, Uw)
            rnd += 1
        if nxtw:
            lalive = st["alive"]
            tgt = torch.where(lalive, torch.cumsum(lalive, 0) - 1, nxtw)
            for kk in lane_keys:
                st[kk] = _drop_set(torch.zeros(nxtw, dtype=st[kk].dtype,
                                               device=dev), tgt, st[kk])
    ovf = st["povf"] | st["alive"].any()

    # pushes fill slots 0..cursor-1 contiguously; the (rid, pivot, end)
    # final order packs into one integer key (bounds are static)
    pvalid = torch.arange(GP, device=dev) < st["cursor"]
    EB = L + 2 * W + 4
    PB = L + 2
    kdt = _I32 if (max(R, n_lanes) + 2) * EB * PB < 2**31 else _I64
    okey = (st["pool_r"].to(kdt) * PB + st["pool_p"].to(kdt)) * EB + \
        st["pool_e"].to(kdt)
    forder = torch.argsort(torch.where(pvalid, okey, torch.iinfo(kdt).max),
                           stable=True)
    pool = torch.stack([c[forder] for c in
                        (st["pool_k"], st["pool_l"], st["pool_s"],
                         st["pool_e"], st["pool_p"], st["pool_r"],
                         pvalid.to(dt))], dim=1)
    memo_out = {kk: st[kk] for kk in MEMO_KEYS}
    return pool, st["cursor"], ovf, st["fq"], st["fc"], memo_out
