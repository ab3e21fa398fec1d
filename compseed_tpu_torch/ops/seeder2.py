"""Device-resident batch seeder (port of compseed_tpu/ops/seeder2.py).

The default path of the JAX package's ``DeviceSeeder(dedup=True)``: the
forward chain-memo scan (``seedscan.chain_scan``) for rounds 1, 2 and 3,
the chained backward walker (``seedscan.walk_pool_chain``) for rounds 1
and 2, SMEM reconstruction, match merge, seed sampling and merged SAL,
all on the device.  The host receives one compact result per chunk: a
head of counters + per-read words and a bit-packed seed matrix, in the
JAX package's exact layout, so ``unpack_results`` and the native tail
consume either package's output unchanged.

Engines outside this path (the staged forward engine, the r4 backward
engines, the legacy lockstep seeder) are not ported yet: the knobs that
select them raise ``NotImplementedError`` naming the ROADMAP item, and a
chunk-global cap overflow — where the JAX package reruns the chunk on
its lockstep seeder — raises ``SeederCapOverflow``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops import seedscan as ss
from compseed_tpu_torch.ops.bits import as_i32
from compseed_tpu_torch.ops.device_index import DeviceFMIndex, to_device
from compseed_tpu_torch.ops.seedscan import _drop_set

_I32 = torch.int32
_I64 = torch.int64

# scalar head of the result: [mtotal, stotal, n_uniq] + 11 overflow
# flags + per-round BWT counters [n_pool, n_u, n2, n_u2 (walk volumes),
# bq1, bc1, bq2, bc2 (backward steps), fq1, fc1, fq2, fc2, fq3, fc3
# (forward steps)] — queries/calls are STEP-granular like the
# reference's (comp_seed.cpp:81,123,151; SST.h bwt_call)
N_SCAL = 28

_EXACT_FALLBACK = ("ROADMAP: modules to port — exact fallbacks "
                   "(smem.BatchSeeder, _note_fwd_overflow, adaptive caps)")
_ENGINES = "ROADMAP: modules to port — non-default engines behind env knobs"


class SeederCapOverflow(RuntimeError):
    """A chunk-global static cap overflowed.  The JAX package reruns such
    a chunk on its exact lockstep seeder, which is not ported yet."""


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def result_dims(R: int, packed: bool) -> tuple[int, int]:
    """(len(head), seed-matrix rows) for one shard's pack output."""
    return N_SCAL + 2 * R, 2 if packed else 4


def seed_bucket(stotal: int, seedcap: int) -> int:
    """Fetch width for the seed matrix: the D2H copy ships only ~stotal
    columns instead of the full static cap, quantized to <= 32 widths."""
    g = max(4096, seedcap // 32)
    k = -(-max(int(stotal), 1) // g) * g
    return min(seedcap, k)


def unpack_results(head: np.ndarray, seedpk: np.ndarray, R: int,
                   n_reads: int, packed: bool = True) -> dict:
    """Decode one shard's (head, seed-matrix) result pair into host-side
    flats + counters.  ``seedpk`` may be column-bucketed (seed_bucket).
    The match list never ships: chaining consumes only the per-read
    repetitive-coverage length l_rep (comp_seed.cpp:271-281)."""
    scal = head[:N_SCAL]
    cntbad = head[N_SCAL:N_SCAL + R]
    lrep_h = head[N_SCAL + R:N_SCAL + 2 * R]
    seed_cnt_h = cntbad & 0xFFFFFF
    bad_h = cntbad >> 24
    mtotal_h, stotal_h, n_uniq_h = int(scal[0]), int(scal[1]), int(scal[2])
    oflags = scal[3:14]  # r1 pool/walk/fwd/bwd; r2 x4; merge; seeds; r3
    npool_h, nu_h = int(scal[14]), int(scal[15])
    n2_h, nu2_h = int(scal[16]), int(scal[17])
    bq1, bc1, bq2, bc2 = (int(x) for x in scal[18:22])
    fq1, fc1, fq2, fc2, fq3, fc3 = (int(x) for x in scal[22:28])
    fq_h, fc_h = fq1 + fq2 + fq3, fc1 + fc2 + fc3

    k = min(stotal_h, seedpk.shape[1])
    w0 = seedpk[0, :k].astype(np.uint32).astype(np.uint64)
    if packed:
        w1 = seedpk[1, :k].astype(np.uint32)
        rbeg = (w0 | ((w1 & np.uint32(0xFFF)).astype(np.uint64)
                      << np.uint64(32))).astype(np.int64)
        qb_h = ((w1 >> np.uint32(12)) & np.uint32(0x3FF)).astype(np.int64)
        ln_h = (w1 >> np.uint32(22)).astype(np.int64)
    else:
        hi = seedpk[1, :k].astype(np.uint32).astype(np.uint64)
        rbeg = (w0 | (hi << np.uint64(32))).astype(np.int64)
        qb_h = seedpk[2, :k].astype(np.int64)
        ln_h = seedpk[3, :k].astype(np.int64)

    sflat = np.stack([rbeg, qb_h, ln_h], axis=1).astype(np.int64)
    soff = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(seed_cnt_h[:n_reads], out=soff[1:])
    return dict(lrep=lrep_h[:n_reads].astype(np.int64),
                sflat=sflat, soff=soff,
                oflags=oflags, bad=bad_h[:n_reads],
                mtotal=mtotal_h, stotal=stotal_h, n_uniq=n_uniq_h,
                npool=npool_h, n_u=nu_h, n2=n2_h, n_u2=nu2_h,
                bq1=bq1, bc1=bc1, bq2=bq2, bc2=bc2,
                fq=fq_h, fc=fc_h,
                fq1=fq1, fc1=fc1, fq2=fq2, fc2=fc2, fq3=fq3, fc3=fc3)


def _accumulate_stats(stats, res: dict) -> None:
    """Fold one chunk's counters into SeedingStats at the reference's
    granularity — one query per character-extension request, one call
    per executed FM extension — for both directions and all three
    rounds, plus the per-round decomposition."""
    stats.sal_queries += res["stotal"]
    stats.sal_calls += res["n_uniq"]
    stats.bwt_queries += res["bq1"] + res["bq2"] + res["fq"]
    stats.bwt_calls += res["bc1"] + res["bc2"] + res["fc"]
    r = stats.rounds
    for key in ("npool", "n_u", "n2", "n_u2", "bq1", "bc1", "bq2", "bc2",
                "fq1", "fc1", "fq2", "fc2", "fq3", "fc3"):
        r[key] = r.get(key, 0) + res[key]


def _bucket(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b <<= 1
    return b


def _segmented_cummax(v: torch.Tensor, seg_start: torch.Tensor, span: int):
    """Running max of v within runs that begin at seg_start — the JAX
    package's associative scan with the (rid-equal ? max : take) combine,
    which is this for non-decreasing rids.  Requires -1 <= v < span - 1."""
    seg = torch.cumsum(seg_start, 0)
    key = seg * span + (v.to(_I64) + 1)
    return (torch.cummax(key, 0).values - seg * span - 1).to(v.dtype)


def _check_knobs(dedup: bool):
    """The env knobs that select an engine outside the ported path."""
    if not dedup:
        raise NotImplementedError(
            f"DeviceSeeder(dedup=False) selects the lockstep scan + staged "
            f"walk engines, not ported yet ({_ENGINES})")
    for name, default, want in (
            ("COMPSEED_SEEDER", "v2", "v2"),
            ("COMPSEED_FWD_MEMO", "1", "1"),
            ("COMPSEED_BWD_CHAIN", "1", "1"),
            ("COMPSEED_R2_DEDUP", "1", "1"),
            ("COMPSEED_FWD_DEDUP", "1", "1"),
            ("COMPSEED_BWD_DEDUP", "1", "1")):
        if os.environ.get(name, default) != want:
            raise NotImplementedError(
                f"{name}={os.environ[name]} selects an engine that is not "
                f"ported to compseed_tpu_torch yet ({_ENGINES})")


class DeviceSeeder:
    """run_flat-compatible seeder: the JAX package's default
    ``DeviceSeeder(dedup=True)`` path on a torch device."""

    # caps as multiples of R, env-overridable under the JAX package's
    # names so the shapes (and with them every counter) match
    GP_F = int(os.environ.get("COMPSEED_GP_F", "36"))    # round-1 pool
    CAPU_F = int(os.environ.get("COMPSEED_CAPU_F", "24"))  # bwd-dedup reps
    T2L_F = int(os.environ.get("COMPSEED_T2_F", "4"))    # round-2 task lanes
    GP2_F = int(os.environ.get("COMPSEED_GP2_F", "16"))  # round-2 pool
    MEM_F = int(os.environ.get("COMPSEED_MEM_F", "8"))   # merged matches
    SEED_F = int(os.environ.get("COMPSEED_SEED_F", "8"))  # sampled seeds
    U_F = int(os.environ.get("COMPSEED_U_F", "6"))       # unique SAL

    def __init__(self, opt, fm, device: torch.device,
                 dfi: DeviceFMIndex | None = None, dedup: bool = True):
        _check_knobs(dedup)
        if int(opt.max_mem_intv) <= 0:
            raise NotImplementedError(
                "max_mem_intv <= 0 selects the lockstep round-3 seeder "
                f"(smem._seed_strategy_one), not ported yet ({_ENGINES})")
        self.opt = opt
        self.fm = fm
        self.device = torch.device(device)
        self.dfi = dfi if dfi is not None else to_device(fm, self.device)
        if self.dfi.device != self.device:
            raise ValueError(f"index is on {self.dfi.device}, seeder on "
                             f"{self.device}")
        self.dedup = dedup
        self.chain_w = int(os.environ.get("COMPSEED_CHAIN_W", "5"))
        self.MEM3_F = int(os.environ.get("COMPSEED_MEM3_F", "32"))
        self._progs: dict = {}
        self.prof: dict = {}
        self.last_overflow = False
        self.last_qd = None
        self.last_L = 0

    # ------------------------------------------------------------------
    def _build(self, R: int, L: int):
        """The per-(R, L) programs r1, r2, r3, merge, seeds and pack (the
        JAX package's jitted stages, as plain functions on tensors)."""
        key = (R, L)
        if key in self._progs:
            return self._progs[key]
        opt = self.opt
        dt = self.dfi.dtype
        dev = self.device
        GP = self.GP_F * R
        T2 = self.T2L_F * R
        GP2 = self.GP2_F * R
        MEMCAP = self.MEM_F * R
        SEEDCAP = self.SEED_F * R
        UCAP = self.U_F * R
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        CAP_U = min(self.CAPU_F * R, GP)
        CAP_U2 = min(int(os.environ.get("COMPSEED_CAPU2_F",
                                        str(self.GP2_F))) * R, GP2)
        CW = self.chain_w
        MEMO_M = (256 // CW) * R                  # chain-store rows
        MEMO_H = 1 << (4 * MEMO_M - 1).bit_length()   # table slots
        max_intv = int(opt.max_mem_intv)
        zero = torch.zeros((), dtype=_I32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)

        def nonN_prefix(qarr):
            """S[r, i] = # non-N bases of read r in [0, i): a walk span
            becomes its exact BWT-query count (comp_seed.cpp:123)."""
            nn = torch.cumsum((qarr < 4).to(_I32), dim=1)
            return torch.cat([torch.zeros((qarr.shape[0], 1), dtype=_I32,
                                          device=dev), nn],
                             dim=1).to(_I32).reshape(-1)

        def walk_steps(S_flat, pool_, death, valid):
            """Sum of per-entry step counts: queries at i in
            [max(death, 0), pivot-1] where seq[i] < 4."""
            rid = pool_[:, 5].to(_I64)
            piv = pool_[:, 4].to(_I64)
            lo = death.to(_I64).clamp(min=0)
            base = rid * (L + 1)
            span = S_flat[base + piv] - S_flat[base + lo]
            return torch.where(valid, span, 0).sum().to(_I32)

        def r1(qarr, rlens):
            R_ = qarr.shape[0]
            memo = ss.make_chain_memo(MEMO_H, MEMO_M, CW, dt, dev)
            pool, n_pool, fovf, fqc, fcc, memo = ss.chain_scan(
                self.dfi, qarr, rlens, GP, memo, W=CW,
                u_cap=max(R_ // 2, 64))
            bad = torch.zeros(R_, dtype=torch.bool, device=dev)
            S_flat = nonN_prefix(qarr)
            rw = ss.packed_rev_windows(qarr)
            death, fk, fl, fs, wovf, bc1, n_u = ss.walk_pool_chain(
                self.dfi, rw, L, pool, CAP_U)
            bq1 = walk_steps(S_flat, pool, death, pool[:, 6] != 0)
            ok, rid, k, l, s, beg, end = ss.reconstruct(
                pool, death, fk, fl, fs, opt.min_seed_len, (5, 4))
            flags = torch.stack([false, wovf, fovf, false])
            return (pool, ok, rid, k, l, s, beg, end, flags, bad,
                    n_pool, n_u, fqc, fcc, bq1, bc1, memo)

        def r2(qarr, rlens, ok, rid, k, s, beg, end, memo):
            # task extraction (comp_seed.cpp:2274-2286)
            sel = ok & ((end - beg) >= split_len) & (s <= opt.split_width)
            order = torch.argsort((~sel).to(torch.int8), stable=True)
            tovf = sel.sum() > T2
            take = order[:T2]
            t_valid = sel[take]
            t_rid = torch.where(t_valid, rid[take], 0)
            t_mid = torch.where(t_valid, (beg[take] + end[take]) // 2, 0)
            t_mh = torch.where(t_valid, s[take] + 1, 1)
            R_ = qarr.shape[0]
            pool2, n2, fovf2, fq2, fc2, memo = ss.chain_scan(
                self.dfi, qarr, rlens, GP2, memo, W=CW,
                u_cap=max(R_ // 4, 64), min_hits=t_mh,
                pivots0=t_mid.to(_I32), rids=t_rid.to(_I32),
                advance=False, record_lane_index=True, active=t_valid)
            bad = torch.zeros(R_, dtype=torch.bool, device=dev)
            # pool2 col 5 is the task index; remap to the real read id
            # and append the task index as the grouping column
            tix = pool2[:, 5].to(_I64)
            pool2 = torch.cat([pool2[:, :5], t_rid[tix][:, None].to(dt),
                               pool2[:, 6:7], tix[:, None].to(dt)], dim=1)
            mh_rows = t_mh[tix].to(_I32)
            S_flat2 = nonN_prefix(qarr)
            rw2 = ss.packed_rev_windows(qarr)
            death2, fk2, fl2, fs2, wovf2, bc2, n_u2 = ss.walk_pool_chain(
                self.dfi, rw2, L, pool2, CAP_U2, mh=mh_rows)
            bq2 = walk_steps(S_flat2, pool2, death2, pool2[:, 6] != 0)
            ok2, rid2, k2, l2, s2, beg2, end2 = ss.reconstruct(
                pool2, death2, fk2, fl2, fs2, opt.min_seed_len, (7,))
            flags = torch.stack([tovf, false, wovf2, fovf2])
            return (ok2, rid2, k2, l2, s2, beg2, end2, flags, bad,
                    fq2, fc2, n2, n_u2, bq2, bc2, memo)

        def r3(qarr, rlens, memo):
            # greedy round 3 (tem_forward_sst, comp_seed.cpp:141-160)
            R_ = qarr.shape[0]
            GP3 = R_ * self.MEM3_F
            pool3, n3, ovf3g, fq3, fc3, memo = ss.chain_scan(
                self.dfi, qarr, rlens, GP3, memo, W=CW, mode="r3",
                u_cap=max(R_ // 2, 64), min_len=int(opt.min_seed_len),
                max_intv=max_intv)
            valid3 = pool3[:, 6] != 0
            ok3 = valid3 & (pool3[:, 2] > 0)
            ovf3 = torch.zeros(R_, dtype=torch.bool, device=dev)
            return (ok3, pool3[:, 5].to(_I32), pool3[:, 0], pool3[:, 1],
                    pool3[:, 2], pool3[:, 4].to(_I32), pool3[:, 3].to(_I32),
                    ovf3, ovf3g, fq3, fc3)

        def merge(*parts):
            ok, rid, k, l, s, beg, end = (
                torch.cat([parts[j], parts[7 + j], parts[14 + j]])
                for j in range(7))
            # single packed-key stable sort by (rid, beg, end)
            rid_kc = torch.where(ok, rid.to(_I32), R)
            span = L + 2
            kd = _I32 if (R + 2) * span * span < 2**31 else _I64
            okey = (rid_kc.to(kd) * span + beg.to(kd)) * span + end.to(kd)
            order = torch.argsort(okey, stable=True)
            total = ok.sum().to(_I32)
            movf = total > MEMCAP
            take = order[:MEMCAP]
            return (ok[take], rid[take], k[take], l[take], s[take],
                    beg[take], end[take], total, movf)

        def seeds(ok, rid, k, s, beg, end):
            # sampling (comp_seed.cpp:2309-2325)
            step = torch.where(s > opt.max_occ, s // opt.max_occ, 1)
            cnt = torch.minimum(-((-s) // step),
                                torch.full_like(s, opt.max_occ)).to(_I32)
            cnt = torch.where(ok, cnt, 0)
            total = cnt.sum().to(_I32)
            sovf = total > SEEDCAP
            csum = torch.cumsum(cnt, 0)
            starts = csum - cnt
            pos = torch.arange(SEEDCAP, dtype=_I32, device=dev)
            # jnp.repeat(arange(MEMCAP), cnt, total_repeat_length=SEEDCAP)
            # on the valid prefix pos < total (the tail is masked by v)
            midx = torch.searchsorted(csum, pos.to(csum.dtype), right=True)
            midx = midx.clamp(max=MEMCAP - 1)
            v = pos < total
            within = (pos - starts[midx]).to(dt)
            locs = torch.where(v, k[midx] + within * step[midx], 0)
            # merged SAL (comp_seed.cpp:2306-2347)
            lord = torch.argsort(torch.where(v, locs,
                                             torch.iinfo(locs.dtype).max),
                                 stable=True)
            lsort = locs[lord]
            vsort = v[lord]
            head = vsort.clone()
            head[1:] &= (lsort[1:] != lsort[:-1]) | ~vsort[:-1]
            n_uniq = head.sum().to(_I32)
            uovf = n_uniq > UCAP
            urank = torch.cumsum(head, 0) - 1
            reps = _drop_set(torch.zeros(UCAP, dtype=dt, device=dev),
                             torch.where(head & (urank < UCAP), urank, UCAP),
                             lsort)
            sa, wovf = dfm.sa_batch_compact(self.dfi, reps)
            # resolved values back: sorted position -> rep index
            sa_sorted = sa[urank.clamp(0, UCAP - 1)]
            rbeg_sorted = torch.where(vsort, sa_sorted, 0)
            rbeg = torch.empty(SEEDCAP, dtype=dt, device=dev)
            rbeg[lord] = rbeg_sorted.to(dt)
            qb = torch.where(v, beg[midx], 0).to(_I32)
            ln = torch.where(v, end[midx] - beg[midx], 0).to(_I32)
            seed_rid = torch.where(v, rid[midx], 0).to(_I64)
            seed_cnt = torch.zeros(R, dtype=_I32, device=dev).index_add_(
                0, seed_rid, v.to(_I32))
            return (rbeg, qb, ln, total, n_uniq, seed_cnt,
                    sovf | uovf | wovf)

        packed = L < 1024                   # read positions fit 10 bits

        def pack(mok, mrid, ms, mbeg, mend, mtotal, rbeg, qb, ln, stotal,
                 n_uniq, seed_cnt, f1, f2, bad1, bad2, bad3, f4, f5, f6,
                 *counters):
            """Pack results into the scalar+per-read head and the
            bit-packed all-int32 seed matrix (the JAX package's layout:
            rbeg lo32; rbeg hi12 | qb<<12 | len<<22), with the per-read
            l_rep reduced here by a segmented prefix max over the (rid,
            beg, end)-sorted merged matches (comp_seed.cpp:271-281)."""
            bad = (bad1 | bad2 | bad3).to(_I64)
            scalars = torch.cat([
                torch.stack([mtotal.to(_I32), stotal.to(_I32),
                             n_uniq.to(_I32)]),
                f1.to(_I32), f2.to(_I32),
                torch.stack([x.to(_I32) for x in (f4, f5, f6) + counters])])
            occ32 = ms.to(_I64).clamp(max=(1 << 31) - 1)
            m_rep = mok & (occ32 > opt.max_occ)
            e32 = torch.where(m_rep, mend.to(_I32), -1)
            rid32 = mrid.to(_I32)
            seg_start = torch.ones_like(mok)
            seg_start[1:] = rid32[1:] != rid32[:-1]
            run = _segmented_cummax(e32, seg_start, L + 3)
            prev = torch.cat([run.new_full((1,), -1), run[:-1]])
            Mx = torch.where(seg_start, -1, prev)
            contrib = torch.where(
                m_rep, (mend.to(_I32) - torch.maximum(mbeg.to(_I32), Mx))
                .clamp(min=0), 0)
            tgt = torch.where(mok, mrid.to(_I64), R)
            lrep = torch.zeros(R + 1, dtype=_I32, device=dev).index_add_(
                0, tgt, contrib.to(_I32))[:R]
            cntbad = seed_cnt.to(_I64) | (bad << 24)
            head = torch.cat([scalars.to(_I64), cntbad, lrep.to(_I64)])
            r64 = rbeg.to(_I64)
            lo = r64 & 0xFFFFFFFF
            hi = (r64 >> 32) if dt == _I64 else torch.zeros_like(r64)
            if packed:
                w1 = hi | (qb.to(_I64) << 12) | (ln.to(_I64) << 22)
                seedpk = torch.stack([lo, w1])
            else:
                seedpk = torch.stack([lo, hi, qb.to(_I64), ln.to(_I64)])
            return as_i32(head), as_i32(seedpk)

        progs = dict(r1=r1, r2=r2, r3=r3, merge=merge, seeds=seeds,
                     pack=pack, packed=packed,
                     sizes=(GP, T2, GP2, MEMCAP, SEEDCAP, UCAP))
        self._progs[key] = progs
        return progs

    def _run(self, fns, qd, rd):
        (pool, ok, rid, k, l, s, beg, end, ovf1, bad1, n_pool, n_u,
         fqc, fcc, bq1, bc1, memo) = fns["r1"](qd, rd)
        r2 = fns["r2"](qd, rd, ok, rid, k, s, beg, end, memo)
        r3 = fns["r3"](qd, rd, r2[15])
        merged = fns["merge"](ok, rid, k, l, s, beg, end, *r2[:7], *r3[:7])
        mok, mrid, mk, ml, ms, mbeg, mend, mtotal, movf = merged
        seeds = fns["seeds"](mok, mrid, mk, ms, mbeg, mend)
        rbeg, qb, ln, stotal, n_uniq, seed_cnt, sovf = seeds
        head, seedpk = fns["pack"](
            mok, mrid, ms, mbeg, mend, mtotal, rbeg, qb, ln, stotal, n_uniq,
            seed_cnt, ovf1, r2[7], bad1, r2[8], r3[7], movf, sovf, r3[8],
            n_pool, n_u, r2[11], r2[12], bq1, bc1, r2[13], r2[14], fqc, fcc,
            r2[9], r2[10], r3[9], r3[10])
        return merged, seeds, head, seedpk

    def _upload(self, queries):
        n_reads = len(queries)
        R = _bucket(n_reads, 256)
        lens = np.fromiter((len(q) for q in queries), np.int64,
                           count=n_reads)
        L = _round_up(int(lens.max(initial=1)) + 1, 32)
        qarr = np.full((R, L), 4, dtype=np.uint8)
        rlens = np.zeros(R, dtype=np.int32)
        rlens[:n_reads] = lens
        flat = np.concatenate(queries) if n_reads else np.zeros(0, np.uint8)
        rows = np.repeat(np.arange(n_reads), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        qarr[rows, cols] = flat
        qd = torch.from_numpy(qarr).to(self.device)
        rd = torch.from_numpy(rlens).to(self.device)
        return R, L, qd, rd

    # ------------------------------------------------------------------
    def run_flat(self, queries: list[np.ndarray], stats=None):
        """Seed one chunk -> (lrep (n,), sflat (S, 3), soff (n+1,))."""
        n_reads = len(queries)
        R, L, qd, rd = self._upload(queries)
        fns = self._build(R, L)
        t0 = time.time()
        # a fresh tensor per chunk: the engine slices pair sequences
        # from it while the next chunk is being seeded
        self.last_qd = qd
        self.last_L = L
        _, _, head_d, seed_d = self._run(fns, qd, rd)

        # two copies: the head (counters first), then only
        # seed_bucket(stotal) columns of the seed matrix
        _, _, _, MEMCAP, SEEDCAP, _ = fns["sizes"]
        head = head_d.cpu().numpy()
        if head[3:14].any():
            seedpk = np.zeros((2 if fns["packed"] else 4, 0), np.int32)
        else:
            K = seed_bucket(head[1], SEEDCAP)
            seedpk = seed_d[:, :K].cpu().numpy()
        self.prof["device_s"] = time.time() - t0
        self.prof["d2h_bytes"] = head.nbytes + seedpk.nbytes

        res = unpack_results(head, seedpk, R, n_reads, packed=fns["packed"])
        if res["oflags"].any():
            self.last_overflow = True
            self.last_qd = None
            self.prof["overflow_flags"] = res["oflags"].tolist()
            raise SeederCapOverflow(
                f"chunk-global cap overflow (oflags={res['oflags'].tolist()}"
                " = r1 pool/walk/fwd/bwd, r2 task/pool/walk/fwd, merge, "
                f"seeds, r3); the exact rerun is not ported ({_EXACT_FALLBACK})")
        self.last_overflow = False

        if stats is not None:
            _accumulate_stats(stats, res)
        lrep, sflat, soff = res["lrep"], res["sflat"], res["soff"]
        bad_reads = np.nonzero(res["bad"])[0]
        if len(bad_reads):
            lrep, sflat, soff = self._splice_oracle(
                queries, bad_reads, lrep, sflat, soff)
        return lrep, sflat, soff

    def _splice_oracle(self, queries, bad_reads, lrep, sflat, soff):
        """Per-read exactness fallback: reads whose per-read buffers
        overflowed are recomputed with the scalar host oracle and spliced
        into the flat output; the chunk keeps its device results."""
        from compseed_tpu.pipeline import seeding as sd
        from compseed_tpu.pipeline.chain import l_rep_one

        bad = set(int(r) for r in bad_reads)
        n_reads = len(queries)
        lrep = np.array(lrep, dtype=np.int64, copy=True)
        sseg = []
        for r in range(n_reads):
            if r in bad:
                m = sd.collect_matches(self.fm, self.opt, queries[r])
                seeds = sd.sample_seeds(self.opt, m)
                sd.resolve_sal(self.fm, [seeds])
                lrep[r] = l_rep_one(
                    [(beg, end, s) for (_, _, s, beg, end) in m],
                    self.opt.max_occ)
                sseg.append(np.array(
                    [(x.rbeg, x.qbeg, x.len) for x in seeds],
                    dtype=np.int64).reshape(-1, 3))
            else:
                sseg.append(sflat[soff[r]:soff[r + 1]])
        sflat = np.concatenate(sseg) if sseg else sflat[:0]
        soff = np.zeros(n_reads + 1, np.int64)
        np.cumsum([len(x) for x in sseg], out=soff[1:])
        return lrep, sflat, soff

    # ------------------------------------------------------------------
    def __call__(self, fm, opt, queries: list[np.ndarray], stats=None):
        """Per-read debug/test interface: [(matches, seeds)] per read,
        matches as full (k, l, s, beg, end) tuples."""
        from compseed_tpu.pipeline.types import Seed
        n_reads = len(queries)
        R, L, qd, rd = self._upload(queries)
        fns = self._build(R, L)
        merged, seeds, head_d, _ = self._run(fns, qd, rd)
        if head_d[3:14].any():
            raise SeederCapOverflow(f"chunk-global cap overflow "
                                    f"({_EXACT_FALLBACK})")
        mok, mrid, mk, ml, ms, mbeg, mend, _, _ = (
            x.cpu().numpy() for x in merged)
        rbeg, qb, ln, stotal, _, seed_cnt, _ = (x.cpu().numpy()
                                               for x in seeds)
        valid = mok.astype(bool)
        mrid_v = mrid[valid]
        rows = np.stack([mk[valid], ml[valid], ms[valid], mbeg[valid],
                         mend[valid]], axis=1)
        stotal = int(stotal)
        soff = np.zeros(n_reads + 1, dtype=np.int64)
        np.cumsum(seed_cnt[:n_reads], out=soff[1:])
        srows = np.stack([rbeg[:stotal], qb[:stotal], ln[:stotal]], axis=1)
        out = []
        for r in range(n_reads):
            ms_r = [tuple(int(x) for x in row) for row in rows[mrid_v == r]]
            sd = [Seed(rbeg=int(a), qbeg=int(b), len=int(c), score=int(c))
                  for a, b, c in srows[soff[r]: soff[r + 1]]]
            out.append((ms_r, sd))
        return out
