"""Multi-device data parallelism for the production pipeline (port of
compseed_tpu/parallel/sharded.py).

The reference's parallel runtime is kt_for over 512-read tiles with one
private SST pair per thread (cstl/kthread.c:51-63, comp_seed.cpp:2541-2548).
The JAX package's equivalent runs the whole device seeding program under
``jax.shard_map`` over a one-axis mesh; here a mesh is a list of devices
(parallel/mesh.py) and each -K chunk is cut into contiguous per-device
read sub-batches, one per mesh entry.  The COMPLETE device seeding program
(seeder2 rounds 1-3, match merge, compressive dedup, merged SAL) runs on
each shard against that device's replica of the FM-index (read-only, like
the shm-shared index of bwashm.c); the cross-read compressive sort/unique
stages stay *within* each shard exactly as each reference thread's SST
only spans its own tile.  The banded-SW DP runs each shard's pairs on the
shard's device.

Shards on distinct devices run side by side: one worker thread per
distinct device, which runs that device's shards one after the other
(a shard's program is a stream of host calls, so one Python loop over
the devices would run the cards in turn).  On a card a shard's program
is one CUDA graph a call shape (``DeviceSeeder._call``), which a chunk's
workers take over from the last chunk's; a shard's seed matrix is copied
out of the graph's before the next shard replays it.  Everything that
decides a result (the cap response, the exact reruns, the splices, the
re-assembly) runs on the calling thread in shard order after every shard
has returned, as the JAX package's loop does.

Determinism: every per-read result is independent of the sharding (the
compressive dedup only skips duplicate work, never changes results — the
reference's own invariant, README.md:74-76), and the host tail consumes
the re-assembled per-read flats in original read order, so the SAM is
byte-identical across mesh shapes {1, 2, 4, 8, ...}; tests/test_torch_mesh.py
asserts this.  The counters are not: dedup spans one shard, so the reuse
shares fall as the shard count grows.  This is the `-K`-order merge
contract of kt_pipeline (cstl/kthread.c:95-105) carried to a device list.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time

import numpy as np
import torch

from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import BswRunner, _bucket, _collect
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.seeder2 import (DeviceSeeder, _accumulate_stats,
                                            _round_up, result_dims,
                                            seed_bucket, unpack_results)
from compseed_tpu_torch.ops.smem import BatchSeeder
from compseed_tpu_torch.parallel.mesh import (distinct, make_mesh,
                                              replicate_index)


def _on(dev: torch.device):
    """``dev`` made current in this thread (a CUDA device), for the block."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def shard_layout(queries, S: int):
    """A chunk cut into S contiguous shards of per = ceil(n / S) reads:
    (per, R_shard, L, qarr (S * R_shard, L) uint8 padded with 4, read
    lengths (S * R_shard,), row_map: read id -> shard-major row)."""
    n_reads = len(queries)
    per = -(-n_reads // S)               # reads per shard (ceil)
    R_shard = _bucket(max(per, 1), 256)
    lens = np.fromiter((len(q) for q in queries), np.int64, count=n_reads)
    L = _round_up(int(lens.max(initial=1)) + 1, 32)
    qarr = np.full((S * R_shard, L), 4, dtype=np.uint8)
    rlens = np.zeros(S * R_shard, dtype=np.int32)
    idx = np.arange(n_reads)
    row_map = (idx // max(per, 1)) * R_shard + idx % max(per, 1)
    row_map = row_map.astype(np.int64) if n_reads else np.zeros(1, np.int64)
    rlens[row_map[:n_reads]] = lens
    flat = np.concatenate(queries) if n_reads else np.zeros(0, np.uint8)
    rows = np.repeat(row_map[:n_reads], lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    qarr[rows, cols] = flat
    return per, R_shard, L, qarr, rlens, row_map


class ShardedSeeder(DeviceSeeder):
    """run_flat-compatible seeder running the full device seeding program
    data-parallel over a mesh (a list of devices, parallel/mesh.py).

    ``last_qd`` is a tuple of one (R_shard, L) read matrix per shard, on
    the shard's device, fresh each chunk; ``last_row_map`` maps a read id
    to its shard-major row (shard * R_shard + position in the shard)."""

    def __init__(self, opt, fm, mesh=None, dfi=None, dedup: bool = False):
        self.mesh = make_mesh(mesh)
        self.S = len(self.mesh)
        self.replicas = replicate_index(
            self.mesh, dfi if dfi is not None else to_device(fm, self.mesh[0]))
        super().__init__(opt, fm, self.mesh[0],
                         dfi=self.replicas[self.mesh[0]], dedup=dedup)
        self.last_row_map = None

    def _run_shards(self, R: int, L: int, qarr: np.ndarray,
                    rlens: np.ndarray):
        """Every shard's program on its device, one worker thread per
        distinct device.  Returns, in shard order, (head as numpy, seed
        matrix on the device, a copy of the shard's own, read matrix on the
        device, seconds)."""
        # built here, not in the workers: building reads the cap state
        fns = {d: self._build(R, L, self.replicas[d])
               for d in distinct(self.mesh)}

        def work(dev, shards):
            out = []
            with _on(dev):
                for s in shards:
                    t0 = time.perf_counter()
                    qd = torch.from_numpy(qarr[s * R:(s + 1) * R]).to(dev)
                    rd = torch.from_numpy(rlens[s * R:(s + 1) * R]).to(dev)
                    head_d, seed_d = self._call(fns[dev], qd, rd)
                    # copied out before the next shard's replay
                    out.append((s, (head_d.cpu().numpy(), seed_d.clone(),
                                    qd, time.perf_counter() - t0)))
            return out

        by_dev = {d: [s for s in range(self.S) if self.mesh[s] == d]
                  for d in fns}
        with cf.ThreadPoolExecutor(max_workers=len(by_dev)) as ex:
            futs = [ex.submit(work, d, sh) for d, sh in by_dev.items()]
            done = dict(r for f in futs for r in f.result())
        return [done[s] for s in range(self.S)], fns[self.mesh[0]]

    def run_flat(self, queries, stats=None):
        n_reads = len(queries)
        S = self.S
        per, R_shard, L, qarr, rlens, row_map = shard_layout(queries, S)
        t0 = time.time()
        shards, fns = self._run_shards(R_shard, L, qarr, rlens)
        # a fresh tuple per chunk: the engine slices pair sequences from
        # it while the next chunk is being seeded
        self.last_qd = tuple(x[2] for x in shards)
        self.last_L = L
        self.last_row_map = row_map
        SEEDCAP = fns["sizes"][4]
        ROWS = result_dims(R_shard, fns["packed"])[1]
        # the heads came first; the per-shard stotal counters bound the
        # seed-matrix columns the second copy must ship
        head = np.stack([x[0] for x in shards])
        clean = ~head[:, 3:14].any(axis=1)
        if clean.any():
            K = seed_bucket(int(head[clean, 1].max(initial=0)), SEEDCAP)
            seedpk = np.stack([x[1][:, :K].cpu().numpy() for x in shards])
        else:   # every shard overflowed: all reads rerun on the
            seedpk = np.zeros((S, ROWS, 0), np.int32)  # lockstep seeder
        self.prof["device_s"] = time.time() - t0
        self.prof["shard_s"] = [x[3] for x in shards]
        self.prof["r_shard"] = R_shard
        self.prof["d2h_bytes"] = head.nbytes + seedpk.nbytes
        self.prof.pop("rerun_s", None)
        self.prof.pop("rerun_split", None)

        self.last_overflow = False
        lsegs, ssegs = [], []      # one lrep/(sflat, soff) per shard
        for s in range(S):
            lo = s * per
            hi = min(lo + per, n_reads)
            n_local = hi - lo
            if n_local <= 0:
                break
            res = unpack_results(head[s], seedpk[s], R_shard, n_local,
                                 packed=fns["packed"])
            sub = queries[lo:hi]
            if res["oflags"].any():
                # shard-level cap overflow: recompute just this shard's
                # reads with the exact lockstep seeder
                self.last_overflow = True
                self.prof["overflow_flags"] = res["oflags"].tolist()
                self._note_fwd_overflow(res["oflags"])
                dev = self.mesh[s]
                t1 = time.time()
                legacy = BatchSeeder(self.opt, self.fm, dev,
                                     self.replicas[dev])
                with _on(dev):
                    lrep, sflat, soff = legacy.run_flat(sub, stats)
                self.prof["rerun_s"] = self.prof.get("rerun_s", 0.0) + \
                    time.time() - t1
                split = self.prof.setdefault("rerun_split", {})
                for k, v in legacy.split().items():
                    split[k] = split.get(k, 0) + v
            else:
                lrep, sflat, soff = (res["lrep"], res["sflat"],
                                     res["soff"])
                bad_reads = np.nonzero(res["bad"])[0]
                if len(bad_reads):
                    lrep, sflat, soff = self._splice_oracle(
                        sub, bad_reads, lrep, sflat, soff)
                if stats is not None:
                    _accumulate_stats(stats, res)
            lsegs.append(lrep)
            ssegs.append((sflat, soff))
        if self.last_overflow:
            self.last_qd = None    # meta engines must not reuse stale qd

        # deterministic re-assembly in original read order (shards are
        # contiguous read ranges, so concatenation restores -K order)
        lrep = np.concatenate(lsegs) if lsegs else np.zeros(0, np.int64)
        sflat = np.concatenate([x for x, _ in ssegs]) if ssegs else \
            np.zeros((0, 3), np.int64)
        soff = np.zeros(n_reads + 1, np.int64)
        pos = 0
        sbase = 0
        for x, so in ssegs:
            k = len(so) - 1
            soff[pos + 1: pos + k + 1] = sbase + so[1:]
            sbase += so[-1]
            pos += k
        return lrep, sflat, soff


class ShardedBswRunner(BswRunner):
    """Banded-SW engine sharding the pair batch over the mesh: each
    shard's pairs run on its device through the single-device routine
    (per query-length class, sorted by target length), each device with
    its own early exits (the per-lane-class batching of
    mem_chain2aln_across_reads_V2, comp_seed.cpp:1692-2126, spread over
    devices instead of SIMD lanes).  Every shard's launches are issued
    before the first copy back, so shards on distinct cards overlap.

    Three pair interfaces, like the single-device runner:
      * ``run_meta_dual`` / ``run_meta``: metadata per pair; each pair is
        routed to the shard OWNING its read (rows are shard-major), where
        the DP slices its sequences from that shard's read matrix and
        the device's replica of the packed reference.
      * ``run_flat``: host-packed pairs cut into contiguous shards."""

    def __init__(self, opt, mat: np.ndarray, mesh=None, dfi=None):
        self.mesh = make_mesh(mesh)
        self.S = len(self.mesh)
        # the base engine builds on the first device and runs the launch
        # self-check there; every other distinct card is checked here
        super().__init__(opt, mat, self.mesh[0], dfi=dfi)
        self.replicas = replicate_index(self.mesh, dfi) \
            if dfi is not None else {}
        self.mats = {d: self.mat.to(d) for d in distinct(self.mesh)}
        for d in distinct(self.mesh)[1:]:
            if d.type == "cuda":
                bsw_cuda.self_check(d)
        self._R_rows = 0              # rows per shard in the read matrix

    # ---- metadata pair interface -------------------------------------
    def set_query_context(self, qd, L: int = 0, row_map=None) -> None:
        """``qd``: ShardedSeeder.last_qd, one read matrix per shard."""
        if qd is None:
            self._qctx = None
            self._row_map = None
            return
        self._R_rows = int(qd[0].shape[0])
        self._qctx = ([q.reshape(-1) for q in qd], L)
        self._row_map = row_map

    @property
    def supports_meta(self) -> bool:
        return (self.dfi is not None and self._qctx is not None and
                self._R_rows > 0)

    def _by_shard(self, qmeta):
        """Per shard that owns pairs, in shard order: (shard, its pair
        indices), and qmeta with shard-local rows."""
        rows = qmeta[:, 0] if self._row_map is None else \
            np.asarray(self._row_map)[qmeta[:, 0]]
        shard = rows // self._R_rows
        local = qmeta.copy()
        local[:, 0] = (rows % self._R_rows).astype(qmeta.dtype)
        return [(int(s), np.nonzero(shard == s)[0])
                for s in np.unique(shard)], local

    def _shard_ctx(self, s: int):
        dev = self.mesh[s]
        return dev, self.mats[dev], self.replicas[dev], self._qctx[0][s]

    def run_meta_dual(self, qmeta: np.ndarray, rmeta: np.ndarray,
                      h0: np.ndarray, prev: np.ndarray, w: int,
                      pen_clip: int):
        """The fused band-retry interface, each pair on the shard owning
        its read; seven (n,) int32 arrays as BswRunner.run_meta_dual."""
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 7
        L = self._qctx[1]
        groups, local = self._by_shard(qmeta)
        parts = []
        for s, sel in groups:
            parts += [(sel[o], out) for o, out in self._dual_launch(
                *self._shard_ctx(s), L, local[sel], rmeta[sel], h0[sel],
                prev[sel], w, pen_clip)]
        return self._fetch(n, 7, parts)

    def run_meta(self, qmeta: np.ndarray, rmeta: np.ndarray,
                 h0: np.ndarray, w: int, pen_clip: int):
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 6
        L = self._qctx[1]
        groups, local = self._by_shard(qmeta)
        parts = []
        for s, sel in groups:
            parts += [(sel[o], out) for o, out in self._meta_launch(
                *self._shard_ctx(s), L, local[sel], rmeta[sel], h0[sel], w,
                pen_clip)]
        return _collect(n, 6, parts)

    def run_flat(self, qbuf, qoff, rbuf, roff, h0, w: int, pen_clip: int):
        """Flat pairs in contiguous shards of ceil(n / S) pairs, shard s
        on mesh[s]."""
        n = len(h0)
        if n == 0:
            z = np.zeros(0, np.int32)
            return (z,) * 6
        per = -(-n // self.S)
        parts = []
        for s in range(self.S):
            lo, hi = s * per, min((s + 1) * per, n)
            if lo >= hi:
                break
            dev = self.mesh[s]
            parts += [(lo + o, out) for o, out in self._tiles_launch(
                dev, self.mats[dev], qbuf[qoff[lo]:qoff[hi]],
                qoff[lo:hi + 1] - qoff[lo], rbuf[roff[lo]:roff[hi]],
                roff[lo:hi + 1] - roff[lo], h0[lo:hi], w, pen_clip)]
        return _collect(n, 6, parts)
