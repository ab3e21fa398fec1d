"""Batched SMEM seeding on device (port of compseed_tpu/ops/smem.py).

The exact lockstep seeder: the three seeding rounds of the reference
(mapping/comp_seed.cpp:2262-2301) as fixed-shape programs over read
lanes.  ``ops/seeder2.DeviceSeeder`` reruns a chunk here when one of its
chunk-global caps overflows, and ``COMPSEED_SEEDER=v1`` selects it
outright.

  round 1  collect_mem (comp_seed.cpp:67-139 == bwt_smem1a, bwt.c:289-351):
           forward sweep collecting LEP intervals, then a backward-shrink
           loop over the LEP frontier.  The frontier is kept compacted in
           ascending-interval-size order, which makes the reference's
           sequential list logic (first-failure emission, equal-size
           dedup) expressible as masked cummax/cumsum passes.
  round 2  re-seeding from SMEM midpoints with min_hits = occ + 1.
  round 3  greedy forward pass (tem_forward_sst, comp_seed.cpp:141-160)
           fused into ONE left-to-right scan per read (the reference
           restarts a scan after each hit; the restart state is carried
           in-lane instead).

The JAX package writes each round as a per-read program with device
while loops and vmaps it over the batch.  Here each is one batched
program over lanes: every state carries a leading lane dimension, a
per-lane ``act`` mask gates each update, and the Python loop runs while
any lane is live.  A lane whose own loop condition is false is never
active again, so the results equal the vmapped per-read programs lane
for lane.

Fixed caps (LEP frontier, SMEMs per call) are enforced with overflow
flags; overflowing reads fall back to the scalar oracle so results are
always exact.  All rounds share occ gathers through ops.fm.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from compseed_tpu_torch.cpu import fm_oracle as fo
from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops.device_index import DeviceFMIndex, to_device
from compseed_tpu_torch.pipeline.chain import l_rep_flat
from compseed_tpu_torch.pipeline.seeding import SeedingStats
from compseed_tpu_torch.pipeline.types import Seed

MLEP = 32    # LEP frontier cap (pushes need distinct interval sizes)
MMEM = 32    # SMEMs per collect call
MMEM3 = 32   # round-3 seeds per read

_I32 = torch.int32
_I64 = torch.int64


def _set_intv(fm: DeviceFMIndex, c: torch.Tensor) -> torch.Tensor:
    """The bi-interval of single base c per lane: (P,) -> (P, 3)."""
    dt = fm.dtype
    L2 = fm.L2
    c = c.to(_I64)
    return torch.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]],
                       dim=-1).to(dt)


def _char_at(q: torch.Tensor, i: torch.Tensor, L: int) -> torch.Tensor:
    """q[lane, clip(i, 0, L-1)] per lane as int32."""
    return torch.gather(q, 1, i.clamp(0, L - 1).to(_I64)[:, None])[:, 0] \
        .to(_I32)


def _set_slot(buf: torch.Tensor, slot: torch.Tensor, row: torch.Tensor,
              when: torch.Tensor) -> torch.Tensor:
    """buf[lane, slot[lane]] = row[lane] on the lanes where ``when``."""
    n = buf.shape[1]
    hit = (torch.arange(n, device=buf.device)[None, :] == slot[:, None]) & \
        when[:, None]
    if buf.dim() == 3:
        return torch.where(hit[:, :, None], row[:, None, :], buf)
    return torch.where(hit, row[:, None], buf)


def _collect_one(fm: DeviceFMIndex, L: int, q, pivot, min_hits, active):
    """collect_mem for every lane: q (P, L) uint8, pivot, min_hits (P,),
    active (P,) bool.

    Returns (P, MMEM*5 + 3) of the index dtype: per lane the mems rows
    (k, l, s, beg, end — in emission order, descending beg) flattened,
    then n_mems, ret_pivot, overflow.
    """
    dt = fm.dtype
    dev = q.device
    P = q.shape[0]
    pivot = pivot.to(_I32)
    min_hits = min_hits.to(dt).clamp(min=1)

    first_base = _char_at(q, pivot, L)
    bad_start = (first_base > 3) | ~active

    # ---------------- forward sweep (comp_seed.cpp:76-97)
    ik = _set_intv(fm, first_base.clamp(0, 3))
    end = pivot + 1
    stopped = bad_start.clone()
    ret = torch.where(bad_start, pivot + 1, L).to(_I32)
    lep = torch.zeros((P, MLEP, 3), dtype=dt, device=dev)
    lep_end = torch.zeros((P, MLEP), dtype=_I32, device=dev)
    cnt = torch.zeros(P, dtype=_I32, device=dev)
    ovf = torch.zeros(P, dtype=torch.bool, device=dev)

    def push_lep(lep, lep_end, cnt, ovf, ik, end, push):
        slot = cnt.clamp(max=MLEP - 1)
        lep = _set_slot(lep, slot, ik, push)
        lep_end = _set_slot(lep_end, slot, end, push)
        ovf = ovf | (push & (cnt >= MLEP))
        cnt = cnt + (push & (cnt < MLEP)).to(_I32)
        return lep, lep_end, cnt, ovf

    t = 0
    while bool(((~stopped) & (pivot + 1 + t < L)).any()):
        i = pivot + 1 + t
        act = (~stopped) & (i < L)
        base = _char_at(q, i, L)
        amb = base > 3
        c = 3 - base.clamp(0, 3)
        okc = dfm.extend_sel_batch(fm, ik, c, is_back=False)   # (P, 3)
        changed = okc[:, 2] != ik[:, 2]
        too_small = okc[:, 2] < min_hits
        push = act & (amb | changed)
        stop_amb = act & amb
        stop_small = act & ~amb & changed & too_small
        reach = act & ~amb & ~stop_small

        lep, lep_end, cnt, ovf = push_lep(lep, lep_end, cnt, ovf, ik, end,
                                          push)
        ik = torch.where(reach[:, None], okc.to(dt), ik)
        end = torch.where(reach, i + 1, end)
        ret = torch.where(stop_amb, i + 1, torch.where(stop_small, i, ret))
        stopped = stopped | stop_amb | stop_small
        t += 1

    # final push when the sweep reached the read end (comp_seed.cpp:97)
    reached_end = (~stopped) & ~bad_start
    lep, lep_end, cnt, ovf = push_lep(lep, lep_end, cnt, ovf, ik, end,
                                      reached_end)

    # reverse the LEP list so ascending interval sizes sit at 0..cnt-1
    idx = torch.arange(MLEP, dtype=_I32, device=dev)[None, :]
    src = (cnt[:, None] - 1 - idx).clamp(0, MLEP - 1).to(_I64)
    cur = torch.gather(lep, 1, src[:, :, None].expand(P, MLEP, 3))
    cur_end = torch.gather(lep_end, 1, src)

    # pivot == 0 fast path: only the longest match is an SMEM
    # (comp_seed.cpp:98-101)
    fast = (pivot == 0) & ~bad_start

    mems = torch.zeros((P, MMEM, 5), dtype=dt, device=dev)
    mems_fast = mems.clone()
    mems_fast[:, 0, :] = torch.cat(
        [cur[:, 0, :], torch.zeros((P, 1), dtype=dt, device=dev),
         cur_end[:, 0:1].to(dt)], dim=1)

    # ---------------- backward shrink (comp_seed.cpp:105-137)
    n = cnt.clone()
    n_mems = torch.zeros(P, dtype=_I32, device=dev)
    last_beg = torch.full((P,), L + 2, dtype=_I32, device=dev)
    done = bad_start | fast
    bovf = torch.zeros(P, dtype=torch.bool, device=dev)
    neg1 = torch.full((P, 1), -1, dtype=dt, device=dev)

    u = 0
    while bool(((~done) & (pivot >= u)).any()):
        i = pivot - 1 - u
        act = (~done) & (i >= -1)
        base = torch.where(i >= 0, _char_at(q, i, L), 4)
        cvalid = base < 4
        c = base.clamp(0, 3)
        valid = idx < n[:, None]
        okc = dfm.extend_sel_batch(fm, cur, c[:, None].expand(P, MLEP),
                                   is_back=True)          # (P, MLEP, 3)
        s_ok = okc[:, :, 2]
        survive = valid & cvalid[:, None] & (s_ok >= min_hits[:, None])
        # first slot fails -> emit its (old) interval as an SMEM
        fail0 = (n > 0) & ~(cvalid & (s_ok[:, 0] >= min_hits))
        emit = act & fail0 & ((n_mems == 0) | (i + 1 < last_beg))
        mrow = torch.cat([cur[:, 0, :], (i + 1).to(dt)[:, None],
                          cur_end[:, 0:1].to(dt)], dim=1)
        mems = _set_slot(mems, n_mems.clamp(max=MMEM - 1), mrow, emit)
        bovf = bovf | (emit & (n_mems >= MMEM))
        n_mems = n_mems + (emit & (n_mems < MMEM)).to(_I32)
        last_beg = torch.where(emit, i + 1, last_beg)

        # dedup equal sizes (keep first), sizes are non-decreasing
        masked = torch.where(survive, s_ok, -1)
        run = torch.cummax(masked, dim=1).values
        excl = torch.cat([neg1, run[:, :-1]], dim=1)
        keep = survive & (masked > excl)
        pos = torch.cumsum(keep.to(_I64), dim=1) - 1
        dest = torch.where(keep, pos, MLEP)      # MLEP: the drop column
        new_cur = torch.zeros((P, MLEP + 1, 3), dtype=dt, device=dev) \
            .scatter_(1, dest[:, :, None].expand(P, MLEP, 3), okc.to(dt))
        new_end = torch.zeros((P, MLEP + 1), dtype=_I32, device=dev) \
            .scatter_(1, dest, cur_end)
        new_n = keep.sum(dim=1).to(_I32)

        done = done | (act & (new_n == 0)) | (~act & ~done)
        cur = torch.where(act[:, None, None], new_cur[:, :MLEP], cur)
        cur_end = torch.where(act[:, None], new_end[:, :MLEP], cur_end)
        n = torch.where(act, new_n, n)
        u += 1

    mems_out = torch.where(fast[:, None, None], mems_fast, mems)
    n_out = torch.where(fast, 1, n_mems)
    n_out = torch.where(bad_start, 0, n_out)
    overflow = ovf | bovf
    return torch.cat([
        mems_out.reshape(P, -1).to(dt),
        torch.stack([n_out.to(dt), ret.to(dt), overflow.to(dt)], dim=1)],
        dim=1)


def _seed_strategy_one(fm: DeviceFMIndex, L: int, min_len: int,
                       max_intv: int, q, active):
    """Fused round-3 pass for every lane: q (P, L) uint8, active (P,).

    Returns (P, MMEM3*5 + 2) of the index dtype: mems rows (k, l, s,
    beg, end) flattened, then n, overflow.  The reference restarts
    bwt_seed_strategy1 after every hit/N (comp_seed.cpp:2290-2298); one
    scan carries the restart in-lane.
    """
    dt = fm.dtype
    dev = q.device
    P = q.shape[0]
    s0 = torch.zeros(P, dtype=_I32, device=dev)
    ik = torch.zeros((P, 3), dtype=dt, device=dev)
    mems = torch.zeros((P, MMEM3, 5), dtype=dt, device=dev)
    n = torch.zeros(P, dtype=_I32, device=dev)
    ovf = torch.zeros(P, dtype=torch.bool, device=dev)

    for i in range(L):
        base = q[:, i].to(_I32)
        amb = base > 3
        at_start = s0 == i
        inside = s0 < i

        # restart cases
        ik_new = _set_intv(fm, base.clamp(0, 3))
        c = 3 - base.clamp(0, 3)
        okc = dfm.extend_sel_batch(fm, ik, c, is_back=False)
        hit = inside & ~amb & (okc[:, 2] < max_intv) & \
            ((i - s0) >= min_len) & active
        mrow = torch.cat([okc.to(dt), s0.to(dt)[:, None],
                          torch.full((P, 1), i + 1, dtype=dt, device=dev)],
                         dim=1)
        mems = _set_slot(mems, n.clamp(max=MMEM3 - 1), mrow, hit)
        ovf = ovf | (hit & (n >= MMEM3))
        n = n + (hit & (n < MMEM3)).to(_I32)

        ik = torch.where((at_start & ~amb)[:, None], ik_new,
                         torch.where((inside & ~amb & ~hit)[:, None],
                                     okc.to(dt), ik))
        s0 = torch.where(amb | hit, i + 1, s0)

    return torch.cat([mems.reshape(P, -1).to(dt),
                      torch.stack([n.to(dt), ovf.to(dt)], dim=1)], dim=1)


class BatchSeeder:
    """Device-backed seeder with the pipeline.align seeder interface."""

    SEED_BLOCK = 8192

    def __init__(self, opt, fm, device: torch.device,
                 dfi: DeviceFMIndex | None = None):
        self.opt = opt
        self.fm = fm
        self.device = torch.device(device)
        self.dfi = dfi if dfi is not None else to_device(fm, self.device)
        if self.dfi.device != self.device:
            raise ValueError(f"index is on {self.dfi.device}, seeder on "
                             f"{self.device}")
        # wall-time per phase (the reference's display_profile equivalent,
        # main.cpp:203-214): r1 entries are (n_lanes, seconds)
        self.prof = {"r1": [], "r2": 0.0, "r3": 0.0, "sal": 0.0,
                     "post": 0.0}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def run_flat(self, queries: list[np.ndarray],
                 stats: SeedingStats | None = None):
        """Vectorized interface: returns (lrep, sflat, soff) where lrep
        is the per-read repetitive-coverage length (the only chaining
        input derived from matches, comp_seed.cpp:271-281) and sflat
        rows are (rbeg, qbeg, len) — the native tail's input format."""
        outs = [self._run(queries[s: s + self.SEED_BLOCK], stats)
                for s in range(0, len(queries), self.SEED_BLOCK)]
        lrep = np.concatenate(
            [l_rep_flat(o[0], o[1], self.opt.max_occ) for o in outs])
        if len(outs) == 1:
            return lrep, outs[0][2], outs[0][3]
        sflat = np.concatenate([o[2] for o in outs])
        soff = np.concatenate(
            [outs[0][3]] + [o[3][1:] + off for o, off in
                            zip(outs[1:], np.cumsum(
                                [o[3][-1] for o in outs[:-1]]))])
        return lrep, sflat, soff

    def __call__(self, fm, opt, queries: list[np.ndarray],
                 stats: SeedingStats | None = None):
        """Legacy per-read interface for the Python tail and tests."""
        out = []
        for s in range(0, len(queries), self.SEED_BLOCK):
            block = queries[s: s + self.SEED_BLOCK]
            mflat, moff, sflat, soff = self._run(block, stats)
            for r in range(len(block)):
                ms = [tuple(int(x) for x in row)
                      for row in self._mrows[moff[r]: moff[r + 1]]]
                seeds = [Seed(rbeg=int(rb), qbeg=int(qb), len=int(ln),
                              score=int(ln))
                         for rb, qb, ln in sflat[soff[r]: soff[r + 1]]]
                out.append((ms, seeds))
        return out

    def _run(self, queries: list[np.ndarray],
             stats: SeedingStats | None = None):
        opt = self.opt
        R = len(queries)
        L = _round_up(max(len(q) for q in queries), 32)
        qarr = np.full((R, L), 4, dtype=np.uint8)
        lens = np.zeros(R, dtype=np.int32)
        for i, q in enumerate(queries):
            qarr[i, :len(q)] = q
            lens[i] = len(q)
        # NB: padding with 4 (ambiguous) naturally terminates sweeps at the
        # true read end; ret_pivot is clamped to the true length below.

        chunks: list[np.ndarray] = []  # (M, 6): read, k, l, s, beg, end

        def add_rows(read_ids, mems, counts, min_len, max_end=None):
            valid = np.arange(mems.shape[1])[None, :] < counts[:, None]
            lane, slot = np.nonzero(valid)
            if len(lane) == 0:
                return
            rows = mems[lane, slot].astype(np.int64)      # k,l,s,beg,end
            rids = read_ids[lane].astype(np.int64)
            keep = (rows[:, 4] - rows[:, 3]) >= min_len
            keep &= rows[:, 2] > 0
            if max_end is not None:
                keep &= rows[:, 4] <= max_end[lane]
            rows = rows[keep]
            rids = rids[keep]
            chunks.append(np.concatenate([rids[:, None], rows], axis=1))

        def add_tuples(r, ms, min_len):
            rows = np.array([(r, k, l, s, beg, end)
                             for (k, l, s, beg, end) in ms
                             if end - beg >= min_len and s > 0],
                            dtype=np.int64).reshape(-1, 6)
            if len(rows):
                chunks.append(rows)

        def run_collect(q_rows, piv, mh):
            n_lanes = len(piv)
            P = 64
            while P < n_lanes:
                P <<= 1
            qp = np.full((P, L), 4, dtype=np.uint8)
            qp[:n_lanes] = q_rows
            pp = np.zeros(P, np.int32)
            pp[:n_lanes] = piv
            hh = np.ones(P, np.int32)
            hh[:n_lanes] = mh
            aa = np.zeros(P, bool)
            aa[:n_lanes] = True
            packed = _collect_one(self.dfi, L, self._dev(qp), self._dev(pp),
                                  self._dev(hh), self._dev(aa)).cpu().numpy()
            packed = packed[:n_lanes]
            mems = packed[:, : MMEM * 5].reshape(n_lanes, MMEM, 5)
            return (mems, packed[:, MMEM * 5].astype(np.int64),
                    packed[:, MMEM * 5 + 1].astype(np.int64),
                    packed[:, MMEM * 5 + 2] != 0)

        # -------- round 1: repeated collect; later iterations compact to
        # the (rapidly shrinking) set of still-active reads
        pivots = np.zeros(R, dtype=np.int32)
        while True:
            idxs = np.nonzero(pivots < lens)[0]
            if len(idxs) == 0:
                break
            _t0 = time.time()
            mems, n, ret, ovf = run_collect(
                qarr[idxs], pivots[idxs], np.ones(len(idxs), np.int32))
            self.prof["r1"].append((len(idxs), time.time() - _t0))
            ovf_lanes = np.nonzero(ovf)[0]
            n = n.copy()
            for t in ovf_lanes:  # exactness fallback per overflowing read
                r = idxs[t]
                ms, rp = fo.collect_mem(self.fm, queries[r],
                                        int(pivots[r]), 1)
                add_tuples(r, ms, opt.min_seed_len)
                n[t] = 0
                ret[t] = rp
            add_rows(idxs, mems, n, opt.min_seed_len)
            pivots[idxs] = np.minimum(ret, lens[idxs])
            bad = pivots[idxs] <= 0
            if bad.any():
                pivots[idxs[bad]] = lens[idxs[bad]]  # safety: progress

        r1 = np.concatenate(chunks) if chunks else np.zeros((0, 6), np.int64)

        # -------- round 2: re-seed long low-occ matches from midpoints
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        sel = ((r1[:, 5] - r1[:, 4] >= split_len) &
               (r1[:, 3] <= opt.split_width))
        if sel.any():
            _t0 = time.time()
            rr = r1[sel]
            rids2 = rr[:, 0].astype(np.int64)
            p2 = ((rr[:, 4] + rr[:, 5]) // 2).astype(np.int32)
            h2 = (rr[:, 3] + 1).astype(np.int32)
            mems, n, _, ovf = run_collect(qarr[rids2], p2, h2)
            ovf_lanes = np.nonzero(ovf)[0]
            n = n.copy()
            for t in ovf_lanes:
                r = int(rids2[t])
                ms, _ = fo.collect_mem(self.fm, queries[r], int(p2[t]),
                                       int(h2[t]))
                add_tuples(r, ms, opt.min_seed_len)
                n[t] = 0
            add_rows(rids2, mems, n, opt.min_seed_len)
            self.prof["r2"] += time.time() - _t0

        # -------- round 3: greedy forward seeding
        if opt.max_mem_intv > 0:
            _t0 = time.time()
            packed = _seed_strategy_one(
                self.dfi, L, opt.min_seed_len, int(opt.max_mem_intv),
                self._dev(qarr), self._dev(np.ones(R, bool))).cpu().numpy()
            mems = packed[:, : MMEM3 * 5].reshape(R, MMEM3, 5)
            n = packed[:, MMEM3 * 5].astype(np.int64).copy()
            ovf = packed[:, MMEM3 * 5 + 1] != 0
            for r in np.nonzero(ovf)[0]:
                j = 0
                ms = []
                while j < lens[r]:
                    if queries[r][j] < 4:
                        mem, j = fo.seed_strategy1(
                            self.fm, queries[r], j, opt.min_seed_len,
                            opt.max_mem_intv)
                        if mem is not None and mem[2] > 0:
                            ms.append(mem)
                    else:
                        j += 1
                add_tuples(int(r), ms, 0)
                n[r] = 0
            add_rows(np.arange(R), mems, n, 0, max_end=lens)
            self.prof["r3"] += time.time() - _t0

        _t0 = time.time()
        allm = np.concatenate(chunks) if chunks else np.zeros((0, 6),
                                                              np.int64)
        order = np.lexsort((allm[:, 5], allm[:, 4], allm[:, 0]))
        allm = allm[order]
        moff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(allm[:, 0], minlength=R), out=moff[1:])
        self._mrows = allm[:, [1, 2, 3, 4, 5]]  # (k, l, s, beg, end)

        # -------- seed sampling (comp_seed.cpp:2313-2324), vectorized
        occ = allm[:, 3]
        step = np.where(occ > opt.max_occ,
                        occ // np.int64(opt.max_occ), 1)
        cnt = np.minimum(-(-occ // step), opt.max_occ).astype(np.int64)
        total = int(cnt.sum())
        midx = np.repeat(np.arange(len(allm)), cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
        locs = allm[midx, 1] + within * step[midx]
        sflat = np.empty((total, 3), dtype=np.int64)
        sflat[:, 1] = allm[midx, 4]                      # qbeg
        sflat[:, 2] = allm[midx, 5] - allm[midx, 4]      # len
        soff = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(allm[midx, 0], minlength=R), out=soff[1:])

        self.prof["post"] += time.time() - _t0

        # -------- merged SAL on device (comp_seed.cpp:2306-2347)
        _t0 = time.time()
        if total:
            uniq = np.unique(locs)
            P = 256
            while P < len(uniq):
                P <<= 1
            padded = np.zeros(P, dtype=np.int64)
            padded[: len(uniq)] = uniq
            vals = dfm.sa_batch(self.dfi, self._dev(padded)) \
                .cpu().numpy()[:len(uniq)]
            sflat[:, 0] = vals[np.searchsorted(uniq, locs)]
            if stats is not None:
                stats.sal_queries += total
                stats.sal_calls += len(uniq)
        self.prof["sal"] += time.time() - _t0
        mflat = allm[:, [4, 5, 3]].copy()  # (beg, end, occ)
        return mflat, moff, sflat, soff


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
