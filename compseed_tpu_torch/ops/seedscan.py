"""Compressive seeding scans — the default-path subset of
compseed_tpu/ops/seedscan.py, in PyTorch.

  * ``chain_scan`` — the forward LEP sweep with the cross-round
    extension-chain memo (the forward SST trie, mapping/SST.h:60-92), in
    its three modes: round-1 LEP collection, round-2 re-seed tasks and
    round-3 greedy seeding (``mode="r3"``);
  * ``walk_pool_chain`` — backward walks in W-char chained rounds with
    exact per-round content grouping (the backward trie's sharing,
    SST.h:72-92);
  * ``reconstruct`` — SMEM emission from walked pool rows.

Every step is the JAX package's, operation for operation, so pools,
death positions, memo trajectories and every counter are bit-equal.  Where
JAX runs a device while loop, this runs a Python loop that tests the same
condition at the same points (the segment widths set the shapes, and so
the rounds, that the counters count).  JAX's drop-mode scatters become
``_drop_set``: indices past the end land in a dump row that is cut off,
so the real rows are written once each and deterministically.  Packed
windows are int64 tensors holding uint32 words (``ops/bits.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops.bits import as_i32, lsr64, mul32, mul64, u32
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


# splitmix64-style avalanche constants for the memo's slot hash
_MX1 = 0xBF58476D1CE4E5B9
_MX2 = 0x94D049BB133111EB

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
