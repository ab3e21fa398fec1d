"""Device-resident batch seeder (port of compseed_tpu/ops/seeder2.py).

``DeviceSeeder`` runs the JAX package's seeding engines on a torch
device: forward LEP scan, backward walks, SMEM reconstruction, round-2
re-seeding, round-3 greedy seeding, match merge, seed sampling and merged
SAL, all on the device.  The engine follows the JAX package's selection
exactly: ``dedup`` and the env knobs ``COMPSEED_FWD_MEMO``,
``COMPSEED_FWD_DEDUP``, ``COMPSEED_BWD_DEDUP``, ``COMPSEED_BWD_CHAIN``,
``COMPSEED_BWD_WIN`` / ``COMPSEED_BWD_W`` and ``COMPSEED_R2_DEDUP``
(the default, ``dedup=True``, is the chain-memo forward scan and the
chained backward walker).  The host receives one compact result per
chunk: a head of counters + per-read words and a bit-packed seed matrix,
in the JAX package's exact layout, so ``unpack_results`` and the native
tail consume either package's output unchanged.

On a card every engine runs a chunk as one CUDA graph, as the JAX
package runs it as compiled device programs: ``_run`` (r1, r2, r3, merge,
seeds, pack: the JAX package's ``whole``) captured once per (thread, call
shape) into a ``cuda_lib.CallGraph``, its loops joining the capture, and
replayed for every later chunk of the shape: the host uploads the reads,
launches the graph and reads the two results back (``CALL_GRAPH``; a mix
of engines that no entry names runs eagerly).

A chunk-global cap overflow shows in the head's flags: the chunk is
then rerun exactly on the lockstep seeder (``smem.BatchSeeder``) and the
overflowing cap factor doubles for the chunks that follow, or a dedup
pass switches itself off (``_note_fwd_overflow``), as in the JAX
package.  A per-read buffer overflow (the lockstep scans) marks the read
bad, and ``_splice_oracle`` recomputes that read on the host.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops import (chain_cuda, cuda_lib, fm_cuda,
                                    lockstep_cuda, smem_cuda, walk_cuda)
from compseed_tpu_torch.ops import seedscan as ss
from compseed_tpu_torch.ops.bits import as_i32
from compseed_tpu_torch.ops.device_index import DeviceFMIndex, to_device
from compseed_tpu_torch.ops.seedscan import _drop_set
from compseed_tpu_torch.ops.smem import (MMEM3, BatchSeeder,
                                         _seed_strategy_one)
from compseed_tpu_torch.pipeline import seeding
from compseed_tpu_torch.pipeline.chain import l_rep_one
from compseed_tpu_torch.pipeline.types import Seed

_I32 = torch.int32
_I64 = torch.int64

# scalar head of the result: [mtotal, stotal, n_uniq] + 11 overflow
# flags + per-round BWT counters [n_pool, n_u, n2, n_u2 (walk volumes),
# bq1, bc1, bq2, bc2 (backward steps), fq1, fc1, fq2, fc2, fq3, fc3
# (forward steps)] — queries/calls are STEP-granular like the
# reference's (comp_seed.cpp:81,123,151; SST.h bwt_call)
N_SCAL = 28

FWD_OVF_SLOTS = (2, 7, 10)       # oflags indices of the fwd-dedup flags
BWD_OVF_SLOT = 3                 # backward (walk) dedup cap overflow
R2_OVF_SLOT = 5                  # round-2 walk dedup cap overflow

# The engine matrix: name -> (dedup, env knobs) selecting it.  Forward
# r1/r2, backward r1, backward r2, round 3:
ENGINES = {
    # chain_scan memo, walk_pool_chain, walk_pool_chain, memo r3
    "default": (True, {}),
    # forward_scan_dedup, walk_pool_chain x2, forward_scan_dedup(r3)
    "fwd_staged": (True, {"COMPSEED_FWD_MEMO": "0"}),
    # make_scan + build_pool, walk_pool_chain x2, lockstep r3
    "fwd_off": (True, {"COMPSEED_FWD_DEDUP": "0"}),
    # memo, walk_pool_dedup (Wb = 8) x2, memo r3
    "bwd_win": (True, {"COMPSEED_BWD_CHAIN": "0"}),
    # memo, dedup_pool + walk_pool x2 (r2 with mh), memo r3
    "bwd_whole": (True, {"COMPSEED_BWD_CHAIN": "0", "COMPSEED_BWD_WIN": "0"}),
    # memo, walk_pool(stages1), walk_pool_chain, memo r3
    "bwd_off": (True, {"COMPSEED_BWD_DEDUP": "0"}),
    # memo, walk_pool_chain, walk_pool(stages2), memo r3
    "r2_off": (True, {"COMPSEED_R2_DEDUP": "0"}),
    # make_scan + build_pool, walk_pool(stages1), walk_pool(stages2),
    # lockstep r3
    "all_off": (False, {}),
}


# What each engine runs: (forward, backward round 1, backward round 2,
# round 3) as DeviceSeeder._build picks them.  A mix no entry names (two
# dedup passes switched off after overflows) is no engine of the table.
ENGINE_STAGES = {
    "default": ("memo", "chain", "chain", "memo"),
    "fwd_staged": ("staged", "chain", "chain", "staged"),
    "fwd_off": ("lockstep", "chain", "chain", "lockstep"),
    "bwd_win": ("memo", "win", "win", "memo"),
    "bwd_whole": ("memo", "whole", "whole", "memo"),
    "bwd_off": ("memo", "plain", "chain", "memo"),
    "r2_off": ("memo", "chain", "plain", "memo"),
    "all_off": ("lockstep", "plain", "plain", "lockstep"),
}
# Which engines run a call on a card as one CUDA graph (DeviceSeeder._call):
# those whose every loop runs on the card, every engine of the table since
# fwd_staged's staged forward walk (seedscan._fwd_stage_walk) runs as one
# kernel a stage.  EagerCalls turns the entries off for a block.
CALL_GRAPH = dict.fromkeys(ENGINE_STAGES, True)


class EagerCalls:
    """While active, every engine runs its calls eagerly (CALL_GRAPH's
    entries all false; the table is restored after): for what records a
    call's steps from Python or steps its rounds from the host, which a
    replayed graph runs neither of (ops/chain_cases.py's and
    walk_cases.py's captures, chip_smoke.py's diagnostics)."""

    def __enter__(self):
        self._table = dict(CALL_GRAPH)
        CALL_GRAPH.update(dict.fromkeys(CALL_GRAPH, False))
        return self

    def __exit__(self, *exc):
        CALL_GRAPH.update(self._table)
        return False


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


class DeviceSeeder:
    """run_flat-compatible seeder backed by the device pipeline, with the
    JAX package's engine selection (see the module docstring)."""

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
                 dfi: DeviceFMIndex | None = None, dedup: bool = False):
        """dedup=True enables the cross-read walk deduplication (the
        compressive SST reuse); dedup=False runs the lockstep scan and the
        plain staged walks.  On a CUDA device the FM kernels', the chain
        scan's, the chained walker's, the lockstep loops' and the lockstep
        round 3's libraries are built and loaded here (not inside a call's
        capture): a failed build stops the construction."""
        self.opt = opt
        self.fm = fm
        self.device = torch.device(device)
        if self.device.type == "cuda":
            fm_cuda.LIB.load()
            chain_cuda.LIB.load()
            walk_cuda.LIB.load()
            lockstep_cuda.LIB.load()
            smem_cuda.LIB.load()
        self.dfi = dfi if dfi is not None else to_device(fm, self.device)
        if self.dfi.device != self.device:
            raise ValueError(f"index is on {self.dfi.device}, seeder on "
                             f"{self.device}")
        self.dedup = dedup
        # round-2 walk dedup (on with dedup unless COMPSEED_R2_DEDUP=0)
        self.r2_dedup = dedup and \
            os.environ.get("COMPSEED_R2_DEDUP", "1") == "1"
        # the dedup passes switch themselves off after an overflow that
        # raising a cap cannot answer (_note_fwd_overflow)
        self.fwd_disabled = \
            os.environ.get("COMPSEED_FWD_DEDUP", "1") == "0"
        # forward engine: the cross-round chain memo, or (=0) the staged
        # forward dedup
        self.fwd_memo = os.environ.get("COMPSEED_FWD_MEMO", "1") == "1"
        self.chain_w = int(os.environ.get("COMPSEED_CHAIN_W", "5"))
        self.bwd_disabled = \
            os.environ.get("COMPSEED_BWD_DEDUP", "1") == "0"
        # instance copies of the cap factors: a cap overflow at runtime
        # DOUBLES the factor and rebuilds the programs (adaptive static
        # shapes) instead of paying the exact rerun on every chunk
        self.GP_F = type(self).GP_F
        self.CAPU_F = type(self).CAPU_F
        self.T2L_F = type(self).T2L_F
        self.GP2_F = type(self).GP2_F
        self.MEM_F = type(self).MEM_F
        self.SEED_F = type(self).SEED_F
        self.U_F = type(self).U_F
        self.MEM3_F = int(os.environ.get("COMPSEED_MEM3_F", "32"))
        # =0 disables the overflow -> double-and-rebuild response: an
        # overflow drops the dedup pass instead (what whole-genome runs
        # are advised to use)
        self.adaptive_caps = \
            os.environ.get("COMPSEED_ADAPTIVE_CAPS", "1") == "1"
        self._cap_raises = 0
        self._progs: dict = {}
        # the call graphs, per (thread, call shape): _call
        self._calls = cuda_lib.Kept(ss.HELD_CALLS)
        self.prof: dict = {}
        self.last_overflow = False
        self.last_qd = None
        self.last_L = 0

    # ------------------------------------------------------------------
    def _build(self, R: int, L: int, dfi: DeviceFMIndex | None = None):
        """The per-(R, L) programs r1, r2, r3, merge, seeds and pack (the
        JAX package's jitted stages, as plain functions on tensors) of the
        engine the knobs select, on the device of ``dfi`` (default: the
        seeder's index).  A program binds its index and device, so the
        programs are kept per device.  Also ``engine`` (its ENGINES name,
        or None), ``dev`` and ``key``, the call shape its call graphs are
        kept by."""
        dfi0 = self.dfi if dfi is None else dfi
        dev = dfi0.device
        key = (dev, R, L)
        if key in self._progs:
            return self._progs[key]
        opt = self.opt
        dt = dfi0.dtype
        GP = self.GP_F * R
        T2 = self.T2L_F * R
        GP2 = self.GP2_F * R
        MEMCAP = self.MEM_F * R
        SEEDCAP = self.SEED_F * R
        UCAP = self.U_F * R
        MAXW = L + 2
        split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
        stages1 = [(GP, 8), (GP // 2, 16), (GP // 8, 48), (GP // 16, MAXW)]
        stages2 = [(GP2, 8), (GP2 // 2, 24), (GP2 // 8, MAXW)]
        CAP_U = min(self.CAPU_F * R, GP)
        stages_u = [(CAP_U, 8), (CAP_U // 2, 16), (CAP_U // 4, 32),
                    (CAP_U // 8, 72), (CAP_U // 16, MAXW)]
        CAP_U2 = min(int(os.environ.get("COMPSEED_CAPU2_F",
                                        str(self.GP2_F))) * R, GP2)
        stages_u2 = [(CAP_U2, 8), (CAP_U2 // 2, 24), (CAP_U2 // 4, MAXW)]
        fwd_stages = ss.fwd_stages_for(R, L)
        # round-2 tasks run ONE sweep each
        fwd_stages2 = [(T2, 8), (T2, 24), (T2, MAXW)]
        use_fwd = self.dedup and not self.fwd_disabled
        use_bwd = self.dedup and not self.bwd_disabled
        r2_dedup = self.r2_dedup
        # backward engine: chained rounds (the default), or (=0) the
        # windowed probe + staged walk (BWD_WIN=1) or whole-walk keying
        bwd_chain = os.environ.get("COMPSEED_BWD_CHAIN", "1") == "1"
        bwd_win = os.environ.get("COMPSEED_BWD_WIN", "1") == "1"
        BWD_W = int(os.environ.get("COMPSEED_BWD_W", "8"))
        use_memo = self.fwd_memo
        # the staged forward dedup and the r4 backward dedup clamp the
        # group index of lanes past a rep cap: an overflowed chunk's
        # members then carry garbage intervals, whose FM reads follow the
        # JAX package's gather rule (so its head, flags and counters
        # still equal JAX's; the chunk itself is rerun)
        clamps = (use_fwd and not use_memo) or \
            (not bwd_chain and (use_bwd or r2_dedup))
        dfi = replace(dfi0, fill_oob=True) if clamps else dfi0
        scan1 = ss.make_scan(dfi, L, ss.CAPL, advance=True)
        scan2 = ss.make_scan(dfi, L, ss.CAPL2, advance=False)
        CW = self.chain_w
        MEMO_M = (256 // CW) * R                  # chain-store rows
        MEMO_H = 1 << (4 * MEMO_M - 1).bit_length()   # table slots
        max_intv = int(opt.max_mem_intv)
        zero = torch.zeros((), dtype=_I32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)

        def fwd_scan(qa, rl, cap, stages_, memo, u_cap=None, **kw):
            if use_memo:
                return ss.chain_scan(dfi, qa, rl, cap, memo, W=CW,
                                     u_cap=u_cap, **kw)
            return ss.forward_scan_dedup(dfi, qa, rl, cap, stages_,
                                         **kw) + (memo,)

        def init_memo():
            if use_memo:
                return ss.make_chain_memo(MEMO_H, MEMO_M, CW, dt, dev)
            return torch.zeros(0, dtype=_I32, device=dev)  # inert

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

        def walk(qarr, pool, chain_cap, stages_u_, stages_plain, dedup_on,
                 mh=None):
            """The backward engine of one round: (death, fk, fl, fs, wovf,
            calls, n_u, dovf, bq)."""
            qflat = qarr.reshape(-1)
            rw = ss.packed_rev_windows(qarr)
            dovf = false
            if dedup_on and bwd_chain:
                death, fk, fl, fs, wovf, bc, n_u = ss.walk_pool_chain(
                    dfi, rw, L, pool, chain_cap, mh=mh)
            elif dedup_on and bwd_win:
                # content-window dedup: walks from different positions
                # holding the same (interval, next-Wb-chars) state share
                # one representative
                death, fk, fl, fs, wovf, bc, n_u = ss.walk_pool_dedup(
                    dfi, qflat, ss.prefix_hashes(qarr), L, pool, stages_u_,
                    Wb=BWD_W, mh=mh, rwflat=rw)
            elif dedup_on:
                # whole-walk dedup: one representative per (interval,
                # pivot, prefix) state
                rep, group, n_u, dovf, rep_take = ss.dedup_pool(
                    pool, ss.prefix_hashes(qarr), chain_cap, mh=mh)
                death_r, fk_r, fl_r, fs_r, wovf, bc = ss.walk_pool(
                    dfi, qflat, L, rep, stages_u_,
                    mh=None if mh is None else mh[rep_take], rwflat=rw)
                death, fk, fs = death_r[group], fk_r[group], fs_r[group]
                fl = fl_r[group] - rep[group, 1] + pool[:, 1]
            else:
                n_u = None
                death, fk, fl, fs, wovf, bc = ss.walk_pool(
                    dfi, qflat, L, pool, stages_plain, mh=mh, rwflat=rw)
            bq = walk_steps(nonN_prefix(qarr), pool, death, pool[:, 6] != 0)
            return death, fk, fl, fs, wovf, bc, n_u, dovf, bq

        def r1(qarr, rlens):
            R_ = qarr.shape[0]
            memo = init_memo()
            if use_fwd:
                # forward SST reuse: the chain memo or the staged worklist
                pool, n_pool, fovf, fqc, fcc, memo = fwd_scan(
                    qarr, rlens, GP, fwd_stages, memo,
                    u_cap=max(R_ // 2, 64))
                bad = torch.zeros(R_, dtype=torch.bool, device=dev)
                povf = false
            else:
                z = torch.zeros(R_, dtype=_I32, device=dev)
                lep, cnt, sovf = scan1(qarr, rlens, z, z + 1, rlens > 0)
                pool, n_pool, povf = ss.build_pool(lep, cnt, GP)
                fqc = fcc = zero
                fovf = false
                bad = sovf != 0                           # per read
            death, fk, fl, fs, wovf, bc1, n_u, dovf, bq1 = walk(
                qarr, pool, CAP_U, stages_u, stages1, use_bwd)
            if n_u is None:
                n_u = n_pool
            ok, rid, k, l, s, beg, end = ss.reconstruct(
                pool, death, fk, fl, fs, opt.min_seed_len, (5, 4))
            flags = torch.stack([povf, wovf, fovf, dovf])  # chunk-global
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
            if use_fwd:
                # one sweep per task through the forward engine, with
                # per-lane pivots and min_hits
                pool2, n2, fovf2, fq2, fc2, memo = fwd_scan(
                    qarr, rlens, GP2, fwd_stages2, memo,
                    u_cap=max(R_ // 4, 64), min_hits=t_mh,
                    pivots0=t_mid.to(_I32), rids=t_rid.to(_I32),
                    advance=False, record_lane_index=True, active=t_valid)
                bad = torch.zeros(R_, dtype=torch.bool, device=dev)
            else:
                tr = t_rid.to(_I64)
                lep2, cnt2, sovf2 = scan2(qarr[tr], rlens[tr],
                                          t_mid.to(_I32), t_mh.to(_I32),
                                          t_valid)
                pool2, n2, fovf2 = ss.build_pool(lep2, cnt2, GP2)
                fq2 = fc2 = zero
                # per read: .at[t_rid].max(t_valid & sovf2 != 0)
                bad = torch.zeros(R_, dtype=_I32, device=dev).scatter_reduce(
                    0, tr, (t_valid & (sovf2 != 0)).to(_I32), "amax") != 0
            # pool2 col 5 is the task index; remap to the real read id
            # and append the task index as the grouping column
            tix = pool2[:, 5].to(_I64)
            pool2 = torch.cat([pool2[:, :5], t_rid[tix][:, None].to(dt),
                               pool2[:, 6:7], tix[:, None].to(dt)], dim=1)
            mh_rows = t_mh[tix].to(_I32)
            death2, fk2, fl2, fs2, wovf2, bc2, n_u2, povf2, bq2 = walk(
                qarr, pool2, CAP_U2, stages_u2, stages2, r2_dedup,
                mh=mh_rows)
            if n_u2 is None:
                n_u2 = n2
            ok2, rid2, k2, l2, s2, beg2, end2 = ss.reconstruct(
                pool2, death2, fk2, fl2, fs2, opt.min_seed_len, (7,))
            flags = torch.stack([tovf, povf2, wovf2, fovf2])  # chunk-global
            return (ok2, rid2, k2, l2, s2, beg2, end2, flags, bad,
                    fq2, fc2, n2, n_u2, bq2, bc2, memo)

        def r3(qarr, rlens, memo):
            # greedy round 3 (tem_forward_sst, comp_seed.cpp:141-160)
            R_ = qarr.shape[0]
            if not (use_fwd and max_intv > 0):
                return r3_lockstep(qarr, rlens)
            GP3 = R_ * self.MEM3_F
            pool3, n3, ovf3g, fq3, fc3, memo = fwd_scan(
                qarr, rlens, GP3, fwd_stages, memo, mode="r3",
                u_cap=max(R_ // 2, 64), min_len=int(opt.min_seed_len),
                max_intv=max_intv)
            valid3 = pool3[:, 6] != 0
            ok3 = valid3 & (pool3[:, 2] > 0)
            ovf3 = torch.zeros(R_, dtype=torch.bool, device=dev)
            return (ok3, pool3[:, 5].to(_I32), pool3[:, 0], pool3[:, 1],
                    pool3[:, 2], pool3[:, 4].to(_I32), pool3[:, 3].to(_I32),
                    ovf3, ovf3g, fq3, fc3)

        def r3_lockstep(qarr, rlens):
            # max_mem_intv <= 0: the lockstep round 3, MMEM3 slots and an
            # overflow flag per read, no forward-step counters
            R_ = qarr.shape[0]
            packed3 = _seed_strategy_one(
                dfi, L, int(opt.min_seed_len), max_intv, qarr,
                rlens > 0)
            flat = packed3[:, :MMEM3 * 5].reshape(-1, 5)
            n = packed3[:, MMEM3 * 5].to(_I32)
            ovf3 = packed3[:, MMEM3 * 5 + 1] != 0          # per read
            slot = torch.arange(MMEM3, dtype=_I32, device=dev)[None, :]
            valid = (slot < n[:, None]).reshape(-1)
            rid3 = torch.arange(R_ * MMEM3, dtype=_I32, device=dev) // MMEM3
            end3 = flat[:, 4].to(_I32)
            ok3 = valid & (flat[:, 2] > 0) & (end3 <= rlens[rid3.to(_I64)])
            return (ok3, rid3, flat[:, 0], flat[:, 1], flat[:, 2],
                    flat[:, 3].to(_I32), end3, ovf3, false, zero, zero)

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
            sa, wovf = dfm.sa_batch_compact(dfi, reps)
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

        fwd = ("memo" if use_memo else "staged") if use_fwd else "lockstep"
        bwd = "chain" if bwd_chain else "win" if bwd_win else "whole"
        stages = (fwd, bwd if use_bwd else "plain",
                  bwd if r2_dedup else "plain",
                  fwd if use_fwd and max_intv > 0 else "lockstep")
        engine = next((n for n, v in ENGINE_STAGES.items() if v == stages),
                      None)
        caps = (self.GP_F, self.CAPU_F, self.T2L_F, self.GP2_F, self.MEM_F,
                self.SEED_F, self.U_F, self.MEM3_F, CW)
        progs = dict(r1=r1, r2=r2, r3=r3, merge=merge, seeds=seeds,
                     pack=pack, packed=packed,
                     sizes=(GP, T2, GP2, MEMCAP, SEEDCAP, UCAP),
                     engine=engine, dev=dev,
                     key=(dev, R, L, engine, caps, id(dfi0), dt))
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

    @staticmethod
    def _graphed(fns) -> bool:
        """Whether ``_call`` runs the programs ``fns`` as one CUDA graph:
        on a card, for an engine CALL_GRAPH names."""
        return fns["dev"].type == "cuda" and CALL_GRAPH.get(fns["engine"],
                                                            False)

    def _call(self, fns, qd, rd):
        """The whole program of ``fns`` on one chunk's reads: (head,
        seed matrix) on the device.  Where ``_graphed(fns)``, by the call
        graph of this call shape on the calling thread (captured at its
        first call, at most HELD_CALLS shapes a thread): the reads are
        copied into the graph's and the graph is replayed, and what it
        returns is the graph's own, which the next replay on this thread
        overwrites; else ``_run``, eagerly."""
        if not self._graphed(fns):
            return self._run(fns, qd, rd)[2:]
        cg = self._calls.get(fns["key"], lambda: cuda_lib.CallGraph(
            qd.device, lambda q, r: self._run(fns, q, r)[2:], (qd, rd)))
        return cg.run((qd, rd))

    def _rebuild(self) -> None:
        """Drop the programs (and the calling thread's call graphs) after
        a change of caps or engine: the next chunk builds them anew."""
        self._progs.clear()
        self._calls.drop_thread()

    def _upload(self, queries):
        n_reads = len(queries)
        R = _bucket(n_reads, 256)
        lens = np.fromiter((len(q) for q in queries), np.int64,
                           count=n_reads)
        L = _round_up(int(lens.max(initial=1)) + 1, 32)
        # on a card, page-locked host buffers: the copies to the card do
        # not wait for the host
        pin = self.device.type == "cuda"
        qt = torch.full((R, L), 4, dtype=torch.uint8, pin_memory=pin)
        rt = torch.zeros(R, dtype=torch.int32, pin_memory=pin)
        qarr, rlens = qt.numpy(), rt.numpy()
        rlens[:n_reads] = lens
        flat = np.concatenate(queries) if n_reads else np.zeros(0, np.uint8)
        rows = np.repeat(np.arange(n_reads), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        qarr[rows, cols] = flat
        qd = qt.to(self.device, non_blocking=True)
        rd = rt.to(self.device, non_blocking=True)
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
        head_d, seed_d = self._call(fns, qd, rd)

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
            # chunk-global cap overflow (pool/walk/tasks/merge/seeds):
            # the whole chunk reruns exactly on the lockstep seeder
            self.last_overflow = True
            self.last_qd = None      # meta engines must not reuse stale qd
            self.prof["overflow_flags"] = res["oflags"].tolist()
            self._note_fwd_overflow(res["oflags"])
            t0 = time.time()
            legacy = BatchSeeder(self.opt, self.fm, self.device, self.dfi)
            out = legacy.run_flat(queries, stats)
            self.prof["rerun_s"] = time.time() - t0
            self.prof["rerun_split"] = legacy.split()
            return out
        self.last_overflow = False

        if stats is not None:
            _accumulate_stats(stats, res)
        lrep, sflat, soff = res["lrep"], res["sflat"], res["soff"]
        bad_reads = np.nonzero(res["bad"])[0]
        if len(bad_reads):
            lrep, sflat, soff = self._splice_oracle(
                queries, bad_reads, lrep, sflat, soff)
        return lrep, sflat, soff

    def _note_fwd_overflow(self, oflags) -> None:
        """Adaptive response to a cap overflow.  Pool/buffer caps
        (sized to bench volumes) DOUBLE and the programs are rebuilt —
        overflow there means the input genuinely carries more volume
        (whole-genome interval counts), and per-chunk exact fallback
        would otherwise run forever.  Only the dedup REP caps still
        respond by dropping the dedup pass (low-sharing input).  Raises
        are bounded at 9 in all before falling through to the disable
        response."""
        changed = False
        # oflags: r1 pool/walk/fwd/bwd, r2 task/pool/walk/fwd,
        # merge, seeds, r3
        raises = []
        if self.adaptive_caps and self._cap_raises < 9:
            def bump(attr, slots):
                nonlocal changed
                if any(oflags[s] for s in slots):
                    setattr(self, attr, getattr(self, attr) * 2)
                    raises.append(f"{attr}->{getattr(self, attr)}")
                    self._cap_raises += 1
                    changed = True
            # slots 2/7/10 are pool-equivalent only in memo mode
            # (fovf == pool there); in the staged engine they are the
            # dedup REP caps, whose overflow means low-sharing input
            memo = self.fwd_memo and not self.fwd_disabled
            bump("GP_F", (0, 2) if memo else (0,))    # r1 pool
            bump("CAPU_F", (1,))     # r1 walk lane cap
            bump("T2L_F", (4,))      # round-2 task lanes
            bump("GP2_F", (5, 6, 7) if memo else (5, 6))  # r2 pool/walks
            bump("MEM_F", (8,))
            bump("SEED_F", (9,))
            bump("U_F", (9,))
            bump("MEM3_F", (10,) if memo else ())
        if raises:
            print(f"[M::seeder2] cap overflow -> raising {raises} and "
                  "recompiling (results unchanged; the overflowing "
                  "chunk was recomputed exactly)", file=sys.stderr)
            self._rebuild()
            return
        if not self.fwd_disabled and any(oflags[s] for s in FWD_OVF_SLOTS):
            print("[M::seeder2] forward-sweep dedup caps overflowed "
                  f"(oflags={list(map(int, oflags))} = r1 pool/walk/"
                  "fwd/bwd, r2 task/pool/walk/fwd, merge, seeds, r3); "
                  "disabling the forward path for subsequent chunks",
                  file=sys.stderr)
            self.fwd_disabled = True
            changed = True
        if not self.bwd_disabled and oflags[BWD_OVF_SLOT]:
            print("[M::seeder2] backward-walk dedup caps overflowed; "
                  "disabling the backward dedup for subsequent chunks",
                  file=sys.stderr)
            self.bwd_disabled = True
            changed = True
        if self.r2_dedup and oflags[R2_OVF_SLOT]:
            print("[M::seeder2] round-2 walk dedup caps overflowed; "
                  "disabling the round-2 dedup for subsequent chunks",
                  file=sys.stderr)
            self.r2_dedup = False
            changed = True
        if changed:
            self._rebuild()

    def _splice_oracle(self, queries, bad_reads, lrep, sflat, soff):
        """Per-read exactness fallback: reads whose per-read buffers
        overflowed are recomputed with the scalar host oracle and spliced
        into the flat output; the chunk keeps its device results."""
        bad = set(int(r) for r in bad_reads)
        n_reads = len(queries)
        lrep = np.array(lrep, dtype=np.int64, copy=True)
        sseg = []
        for r in range(n_reads):
            if r in bad:
                m = seeding.collect_matches(self.fm, self.opt, queries[r])
                seeds = seeding.sample_seeds(self.opt, m)
                seeding.resolve_sal(self.fm, [seeds])
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
        n_reads = len(queries)
        R, L, qd, rd = self._upload(queries)
        fns = self._build(R, L)
        merged, seeds, head_d, _ = self._run(fns, qd, rd)
        if bool(head_d[3:14].any()):
            return BatchSeeder(opt or self.opt, self.fm, self.device,
                               self.dfi)(fm, opt or self.opt, queries, stats)
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
