"""Smoke run of compseed_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  0. device   — a CUDA card must be present; prints its nvidia-smi
                name and power limit.
  1. build    — compiles csrc/bsw_extend.cu with nvcc for sm_90a (and,
                beside it, the host tail with g++), loads the library
                and runs its launch self-check: the probe kernel against
                its plain version; a wrong tile is fatal.  The probe and
                torch.add are timed two ways each: a loop of launches
                between two events, and the same launches captured once
                in a CUDA graph and replayed.
  2. kernels  — the DP kernel (H/E rows in shared memory) and its
                device-memory-scratch variant against the plain PyTorch
                version on the card, exactly, on seeded random pairs at
                the main path's shapes (z-drop breaks, band shrink, h0
                near the bound, empty queries, tlen=0 lanes); on a second
                set whose h0 keeps the int16 gate, three ways: int16
                kernel == plain int16 version == int32 kernel.  Then the
                fused kernel (tile decode + both band rounds + acceptance
                in one launch) against its plain version on seeded pair
                tables over the bench index: forward and reverse lanes,
                reads across l_pac, lanes rejected at round 0, pad lanes,
                narrow and wide r0, int32 and int16 rows.  A Q = 1024
                table goes through _meta_dual_core both ways: int32 rows
                do not fit, so it builds tiles and launches the scratch
                kernel once per round; int16 rows fit, one fused launch.
  3. goldens  — tests/fixtures reads, each 2,000-read file as ONE chunk,
                through align_stream with the port's seeder, DP engine
                and native tail: the seeder's caps overflow, the chunk
                is rerun exactly on the lockstep seeder and a cap is
                raised; SAM must be byte-equal to the committed bwamem /
                CompSeed goldens, and the DP kernel must have launched
                in that run (counts set to 0 just before it).
  4. main     — the bench input (2 Mbp repeat-structured genome,
                sa_intv=8, 30x layout-ordered 101 bp reads): 4 chunks of
                16,384 reads through align_stream, one warm-up stream
                and 3 timed ones, with int32 DP state and again with an
                engine built under COMPSEED_BSW_I16=1 (then int32 once
                more, to time the two in turns); each kernel must have
                launched; the first 1,024 reads must give SAM
                byte-equal to the host oracle path.  A third window
                takes the tile route (build_tiles + one DP launch per
                band round) so that the engine's call time is read both
                ways in turns.  The pair tables captured from the first
                chunk go through the fused kernel, the DP kernels on the
                tiles decoded from them, and every plain version once
                more.  Then a forced overflow: a fresh seeder with
                GP_F=18 takes two chunks; the first must overflow, be
                rerun on the lockstep seeder and double GP_F, the second
                must not overflow, the SAM of both must equal the
                unforced run's, and the DP kernel's launches are counted
                for this run alone.

With --scratch-variants (and --old-source FILE, an earlier
csrc/bsw_extend.cu whose launcher has no pairs-per-block argument) the
source is also built with the scratch variant's hoisted loads off and on,
and the builds are timed in turns on the Q = 2048 pairs and on the main
path's captured tiles, each held to the plain version first.

Prints the kernel table as one JSON line, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Imports torch,
numpy and compseed_tpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "compseed_tpu_torch/csrc/bsw_extend.cu"
CHUNK = 16384          # reads per chunk, the bench's default
N_CHUNKS = 4
RUNS = 3               # timed streams after one warm-up stream
ORACLE_READS = 1024
FORCED_GP_F = 18       # the bench input needs a round-1 pool of ~23.2 R
LONG_READS = 16        # reads of LONG_LEN + 3 bp for the Q = 2048 class
LONG_LEN = 1500
LONG_Q = 2048          # their query-length class
LONG_SEED = 11
# bwt_hit_pct, sal_merged_pct of one unforced stream: the seeder is
# bit-exact, so these are fixed numbers of the input and the chunking
EXPECT_REUSE = (38.4605, 39.9724)

# Roofline inputs.  HBM rate: NVIDIA's H100 SXM data sheet.  The data
# sheet gives no int32 rate; an SM has 64 int32 lanes against 128 fp32
# lanes and no fused multiply-add to count twice, so the int32 peak is
# the 67 TFLOP/s fp32 figure / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# integer operations per band cell that the recurrence itself needs
# (ksw_extend2's inner loop; addressing, loop control and the clamp of
# the input codes are not counted): add score + select (2), two max for
# h (2), row-max compare + two selects (3), E: sub, max0, sub, max (4),
# F: sub, max0, sub, max (4)
OPS_PER_CELL = 15


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    import torch
    fn()                                        # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def random_pairs(rng, P: int, Q: int, T: int, big_h0: bool = True,
                 qmax: int = 101):
    """Extension-like pairs with the DP's corner cases mixed in."""
    import numpy as np
    qlens = rng.integers(1, qmax + 1, P).astype(np.int32)
    tlens = rng.integers(0, T + 1, P).astype(np.int32)
    queries = np.full((P, Q), 4, np.int8)
    targets = np.full((P, T), 4, np.int8)
    err = rng.choice([0.01, 0.05, 0.3], P)           # 0.3 => z-drop breaks
    for i in range(P):
        q = rng.integers(0, 4, int(qlens[i]))
        queries[i, :len(q)] = q
        tl = int(tlens[i])
        if tl:
            t = np.resize(q, tl).copy()
            e = rng.random(tl) < err[i]
            t[e] = rng.integers(0, 4, int(e.sum()))
            if rng.random() < 0.2:                    # indel: band shrink
                j = int(rng.integers(0, tl))
                t = np.concatenate([t[:j], rng.integers(0, 4, 3), t[j:]])[:tl]
            targets[i, :tl] = t
    queries[rng.random((P, Q)) < 0.01] = 4
    qlens[::97] = 0                                  # empty queries
    tlens[::89] = 0                                  # tlen = 0 lanes
    h0 = rng.integers(1, 120, P).astype(np.int32)
    if big_h0:
        h0[::13] = rng.integers(400, 1 << 14, len(h0[::13]))  # near bound
    ws = rng.choice([1, 5, 50, 100], P).astype(np.int32)
    return queries, qlens, targets, tlens, h0, ws


def graph_time_ms(fn, launches: int = 100, reps: int = 10) -> float:
    """ms per call of ``fn`` when ``launches`` calls are captured once in
    a CUDA graph on the capture stream and the graph is replayed: the
    card's time for a launch without the interpreter's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up on that stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * launches)


def ops_bound(nbytes: int, cells: int):
    """(bound_ms, bound_by): the bytes over the HBM rate against the band
    cells times the operations per cell over the int32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def dp_bound_ms(tiles, cells: int):
    """Bound of one DP launch on tiles: each input read once and the
    output written once, against the band cells this data needs."""
    P = tiles[1].shape[0]
    return ops_bound(sum(x.numel() * x.element_size() for x in tiles)
                     + P * 8 * 4, cells)


def dual_bound_ms(meta, cells: int):
    """Bound of one fused launch: the pair table, the read bytes (one a
    query code) and the packed-reference bytes (8 per 16 bases as stored)
    that its pairs touch, and the output; cells over both rounds."""
    P = meta.shape[0]
    touched = int(meta[:, 2].clamp(min=0).sum()) \
        + int(meta[:, 6].clamp(min=0).sum()) // 2
    return ops_bound(P * 12 * 4 + touched + 25 * 4 + P * 8 * 4, cells)


def err(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_dual(args, kw, gap):
    """One pair table through the fused kernel and its plain version with
    int32 and with int16 rows.  Returns max_abs_err and times per variant,
    the band cells of both rounds (counted by the plain DP's loop bounds)
    and the tiles decoded from the table with round 0's bands."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core, _meta_dual_plain
    mat, qflat, pac, meta = args
    i32 = torch.int32

    def kern(s16):
        return lambda: bsw_cuda.bsw_meta_dual(*args, **kw, state16=s16)

    def plain(s16):
        return lambda: _meta_dual_plain(*args, **kw, state16=s16)

    r0 = meta[:, 4]
    if kw["wide_r0"]:
        r0 = (meta[:, 4].to(torch.int64) & 0xFFFFFFFF) | \
            (meta[:, 5].to(torch.int64) << 32)
    qt, ql, tt = bsw_cuda.build_tiles(
        qflat, pac, meta[:, 0:4], r0, meta[:, 6], Q=kw["Q"], T=kw["T"],
        L=kw["L"], l_pac=kw["l_pac"])
    col = lambda x: x[:, None].to(i32).contiguous()        # noqa: E731
    tiles = (mat, qt, col(ql), tt, col(meta[:, 6]), col(meta[:, 7]),
             col(meta[:, 9]))

    def cells_of(tl, ws):
        return _extend_core(*gap.values(), mat, ws, qt, ql.to(i32), tt, tl,
                            meta[:, 7], count_cells=True)

    out0, cells0 = cells_of(meta[:, 6], meta[:, 9])
    w0 = kw["w0"]
    accept0 = (out0[0] == meta[:, 8]) | (out0[5] < (w0 >> 1) + (w0 >> 2))
    _, cells1 = cells_of(torch.where(accept0, 0, meta[:, 6]), meta[:, 10])

    p32, p16 = plain(False)(), plain(True)()
    k32, k16 = kern(False)(), kern(True)()
    torch.cuda.synchronize()
    return dict(cells=int(cells0) + int(cells1), tiles=tiles,
                rejected=int((~accept0).sum()),
                err32=err(k32, p32), err16=err(k16, p16),
                k32_ms=cuda_time_ms(kern(False), 5),
                k16_ms=cuda_time_ms(kern(True), 5),
                p32_ms=cuda_time_ms(plain(False), 2),
                p16_ms=cuda_time_ms(plain(True), 2))


def compare(tiles, gap, state16: bool):
    """One set of DP tiles through the int32 kernel (rows in shared
    memory), the device-memory-scratch kernel and their plain version
    and, with state16, also the int16 kernel and its plain version.
    Returns a dict of max_abs_err and times per variant plus the band
    cells counted by the plain version's loop bounds."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core
    mat, q, ql, t, tl, h0, ws = tiles

    def kern(s16):
        return lambda: bsw_cuda.bsw_extend_tiles(mat, q, ql, t, tl, h0, ws,
                                                 **gap, state16=s16)

    def scratch(s16):
        return lambda: bsw_cuda._launch_extend(mat, q, ql, t, tl, h0, ws,
                                               **gap, state16=s16, threads=0)

    def plain(s16, count=False):
        return lambda: _extend_core(
            gap["o_del"], gap["e_del"], gap["o_ins"], gap["e_ins"],
            gap["zdrop"], mat, ws[:, 0], q, ql[:, 0], t, tl[:, 0], h0[:, 0],
            state16=s16, count_cells=count)

    p32, cells = plain(False, count=True)()
    k32 = kern(False)()[:, :6]
    g32 = scratch(False)()[:, :6]
    torch.cuda.synchronize()
    out = dict(cells=int(cells), err32=err(k32, p32.T),
               errg=err(g32, p32.T),
               k32_ms=cuda_time_ms(kern(False), 5),
               g32_ms=cuda_time_ms(scratch(False), 5),
               p32_ms=cuda_time_ms(plain(False), 2))
    if state16:
        k16 = kern(True)()[:, :6]
        g16 = scratch(True)()[:, :6]
        p16 = plain(True)().T
        torch.cuda.synchronize()
        out["errg"] = max(out["errg"], err(g16, p16))
        out.update(err16=max(err(k16, p16), err(k16, k32)),
                   k16_ms=cuda_time_ms(kern(True), 5),
                   p16_ms=cuda_time_ms(plain(True), 2))
    return out


def scratch_variants(old_source):
    """name -> fn(tiles, gap) launching the int32 device-memory-scratch
    kernel of a build of its own: the source with BSW_SCRATCH_HOIST=0 and
    =1 and, when given, ``old_source`` (launcher without the
    pairs-per-block argument).  The builds run side by side."""
    import ctypes as ct
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    builds = {f"hoist{h}": (bsw_cuda._SRC, (f"BSW_SCRATCH_HOIST={h}",))
              for h in (0, 1)}
    if old_source:
        builds["old"] = (os.path.abspath(old_source), ())
    sos = {k: os.path.join(bsw_cuda._BUILD, f"libbsw_scratch_{k}.so")
           for k in builds}
    os.makedirs(bsw_cuda._BUILD, exist_ok=True)
    with cf.ThreadPoolExecutor(max_workers=len(builds)) as ex:
        for f in [ex.submit(bsw_cuda.compile_source, src, sos[k], defs)
                  for k, (src, defs) in builds.items()]:
            f.result()

    def launcher(name):
        fn = ct.CDLL(sos[name]).bsw_extend_launch
        tail = () if name == "old" else (0,)
        fn.restype = ct.c_int
        fn.argtypes = [ct.c_void_p] * 10 + [ct.c_int] * (8 + len(tail)) \
            + [ct.c_void_p]

        def run(tiles, gap):
            mat, q, ql, t, tl, h0, ws = tiles
            P, Q = q.shape
            out = torch.empty((P, 8), dtype=torch.int32, device=q.device)
            hbuf = torch.empty(((Q + 1) * P,), dtype=torch.int32,
                               device=q.device)
            ebuf = torch.empty_like(hbuf)
            rc = fn(*(x.data_ptr() for x in (mat, q, ql, t, tl, h0, ws, out,
                                             hbuf, ebuf)),
                    P, Q, t.shape[1], *gap.values(), *tail,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"scratch build {name}: CUDA error {rc}")
            return out
        return run

    return {k: launcher(k) for k in builds}


def time_scratch(variants, tiles, gap):
    """Each build's scratch kernel on ``tiles``: held to the plain version,
    then timed in turns (forward, then backward).  name -> [ms, ms]."""
    import torch
    from compseed_tpu_torch.ops.bsw import _extend_tiles_plain
    want = _extend_tiles_plain(*tiles, **gap)
    times = {}
    for name, run in variants.items():
        if not torch.equal(run(tiles, gap), want):
            raise SystemExit(f"scratch build {name} disagrees with the plain "
                             f"version")
    for name in list(variants) + list(variants)[::-1]:
        times.setdefault(name, []).append(cuda_time_ms(
            lambda: variants[name](tiles, gap), 5))
    return times


def load_reads(reader, name):
    reads = []
    for chunk in reader(os.path.join(ROOT, "tests", "fixtures", name),
                        10_000_000):
        reads.extend(chunk)
    return reads


def golden(name):
    with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
        return [line for line in f if not line.startswith("@")]


def watch_overflow(seeder):
    """Record (last_overflow, GP_F, rerun seconds) after every run_flat."""
    seen = []
    run_flat = seeder.run_flat

    def watched(queries, stats=None):
        out = run_flat(queries, stats)
        seen.append((bool(seeder.last_overflow), seeder.GP_F,
                     seeder.prof.get("rerun_s") if seeder.last_overflow
                     else None))
        return out

    seeder.run_flat = watched
    return seen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scratch-variants", action="store_true")
    ap.add_argument("--old-source")
    cli = ap.parse_args()
    # ---- phase 0: device
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this needs a "
            "CUDA card")
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import numpy as np

    from compseed_tpu_torch import bench_input, native
    from compseed_tpu_torch.index.build import build_index
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import (Read, read_fastq_chunks,
                                             read_reordered_chunks)
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.index.build import unpack_pac
    from compseed_tpu_torch.ops import bsw, bsw_cuda
    from compseed_tpu_torch.ops.bsw_cases import dual_meta_case
    from compseed_tpu_torch.ops.device_index import pack_pac_words
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.pipeline.align import align_chunk, align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[0] device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    opt = MemOptions()
    gap = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
               e_ins=opt.e_ins, zdrop=opt.zdrop)
    mat = torch.tensor(np.array(opt.mat, np.int32).reshape(5, 5),
                       device=dev)

    def reset_counts():
        for k in bsw_cuda.LAUNCHES:
            bsw_cuda.LAUNCHES[k] = 0

    def engine_under(env, fm_, seeder_):
        """A DP engine built with ``env`` set (the int16 opt-in is read
        when an engine is built)."""
        os.environ.update(env)
        try:
            return device_engine(opt, fm_, dfi=seeder_.dfi, device=dev)
        finally:
            for k in env:
                del os.environ[k]

    # ---- phase 1: build (nvcc and g++ side by side), self-check
    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=2) as ex:
        host = ex.submit(native.build_library, True)
        bsw_cuda.build_library(force=True)
        build_s = time.time() - t0
        host.result()
    log(f"[1] build: kernels {build_s:.2f} s, with the host tail "
        f"{time.time() - t0:.2f} s")
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    probe_err = int((bsw_cuda.probe_add_one(x).to(torch.int64)
                     - bsw_cuda._probe_plain(x).to(torch.int64)).abs().max())
    bsw_cuda.self_check(dev)
    torch.cuda.synchronize()
    y = torch.empty_like(x)
    probe_err = max(probe_err, err(bsw_cuda.probe_add_one(x, out=y),
                                   bsw_cuda._probe_plain(x)))

    def probe_k():
        bsw_cuda.probe_add_one(x, out=y)

    def probe_lib():
        torch.add(x, 1, out=y)

    # in turns (kernel, library, library, kernel): the loop reads the
    # host's launch rate, the replayed graph the card's time per launch
    probe = {}
    for name, fn in (("k", probe_k), ("lib", probe_lib), ("lib", probe_lib),
                     ("k", probe_k)):
        probe.setdefault(name + "_loop", []).append(cuda_time_ms(fn, 200))
        probe.setdefault(name + "_graph", []).append(graph_time_ms(fn))
    probe_ms, probe_lib_ms = min(probe["k_loop"]), min(probe["lib_loop"])
    probe_graph_ms = min(probe["k_graph"])
    probe_lib_graph_ms = min(probe["lib_graph"])
    probe_alloc_ms = cuda_time_ms(lambda: bsw_cuda.probe_add_one(x), 200)
    probe_plain_ms = cuda_time_ms(lambda: bsw_cuda._probe_plain(x), 200)
    t0 = time.perf_counter()
    bsw_cuda.self_check(dev)
    self_check_ms = (time.perf_counter() - t0) * 1e3
    log(f"[1] self-check passed: probe max_abs_err {probe_err}; per launch "
        f"in a loop: kernel {probe_ms:.4f} ms (with its own allocation "
        f"{probe_alloc_ms:.4f}), torch.add(out=) {probe_lib_ms:.4f} ms, "
        f"plain x + 1 {probe_plain_ms:.4f} ms; replayed from a CUDA graph: "
        f"kernel {probe_graph_ms:.5f} ms, torch.add {probe_lib_graph_ms:.5f} "
        f"ms; all turns {json.dumps(probe)}; one self_check() "
        f"{self_check_ms:.3f} ms of wall time")
    if probe_err:
        raise SystemExit("probe kernel disagrees with its plain version")
    threads = {f"Q={Q} {'int16' if s16 else 'int32'}":
               bsw_cuda.block_threads(Q, s16)
               for Q in (128, 256, 512, 1024, 2048) for s16 in (False, True)}
    log(f"[1] pairs per block by class (0 = device-memory scratch): "
        f"{json.dumps(threads)}")

    variants = scratch_variants(cli.old_source) if cli.scratch_variants \
        else {}
    variant_ms = {}

    # ---- phase 2: kernels vs plain versions, synthetic pairs
    rng = np.random.default_rng(2024)
    errs32, errs16, errsg, errsd32, errsd16 = [], [], [], [], []
    synth = {}
    for T in (128, 256):
        for big_h0 in (True, False):
            q, ql, t, tl, h0, ws = random_pairs(rng, 4096, 128, T, big_h0)
            tiles = (mat,) + tuple(
                torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (q, ql[:, None], t, tl[:, None], h0[:, None],
                          ws[:, None]))
            r = compare(tiles, gap, state16=not big_h0)
            errs32.append(r["err32"])
            errsg.append(r["errg"])
            tag = f"T={T} {'h0 near bound' if big_h0 else 'h0 < 120'}"
            msg = (f"[2] P=4096 Q=128 {tag}: int32 kernel vs plain "
                   f"max_abs_err {r['err32']}, scratch kernel {r['errg']}; "
                   f"kernel {r['k32_ms']:.3f} ms, scratch kernel "
                   f"{r['g32_ms']:.3f} ms, plain {r['p32_ms']:.3f} ms")
            if not big_h0:
                errs16.append(r["err16"])
                msg += (f"; int16 kernel vs plain int16 vs int32 kernel "
                        f"max_abs_err {r['err16']}; kernel "
                        f"{r['k16_ms']:.3f} ms, plain {r['p16_ms']:.3f} ms")
            log(msg)
            synth[tag] = {k: v for k, v in r.items() if k.endswith("_ms")}
            if r["err32"] or r["errg"] or r.get("err16"):
                raise SystemExit(f"a kernel disagrees with its plain "
                                 f"version ({tag})")

    # the long reads' class: its rows do not fit in shared memory, so the
    # wrapper's own choice is the device-memory-scratch kernel
    if bsw_cuda.block_threads(LONG_Q, False) or \
            bsw_cuda.block_threads(LONG_Q, True):
        raise SystemExit(f"Q={LONG_Q} was expected to take the scratch kernel")
    q, ql, t, tl, h0, ws = random_pairs(rng, 512, LONG_Q, LONG_Q, False,
                                        qmax=LONG_LEN)
    tiles = (mat,) + tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (q, ql[:, None], t, tl[:, None], h0[:, None], ws[:, None]))
    n0 = bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"]
    gm = compare(tiles, gap, state16=True)
    if bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"] - n0 < 20:
        raise SystemExit(f"Q={LONG_Q} did not take the scratch kernel")
    gm["bound_ms"], gm["bound_by"] = dp_bound_ms(tiles, gm["cells"])
    errsg += [gm["err32"], gm["errg"], gm["err16"]]
    log(f"[2] P=512 Q={LONG_Q} T={LONG_Q} (scratch kernel by shape): "
        f"max_abs_err int32 {gm['err32']}, int16 {gm['err16']}; kernel "
        f"{gm['k32_ms']:.3f} / {gm['k16_ms']:.3f} ms, plain "
        f"{gm['p32_ms']:.3f} / {gm['p16_ms']:.3f} ms; {gm['cells']} band "
        f"cells, bound {gm['bound_ms']:.5f} ms by {gm['bound_by']}")
    synth[f"Q={LONG_Q} scratch"] = {k: v for k, v in gm.items()
                                    if k.endswith("_ms")}
    if gm["err32"] or gm["errg"] or gm["err16"]:
        raise SystemExit("the scratch kernel disagrees with its plain "
                         "version")
    if variants:
        variant_ms[f"seeded P=512 Q=T={LONG_Q}"] = time_scratch(
            variants, tiles, gap)
        log(f"[2] scratch kernel builds in turns, ms: "
            f"{json.dumps(variant_ms)}")

    # the fused kernel on seeded pair tables over the bench index
    t0 = time.time()
    fm, reads_arr = bench_input.setup()
    log(f"[2] bench input ready in {time.time() - t0:.1f} s: genome "
        f"{fm.l_pac} bp, {len(reads_arr)} reads, sa_intv {fm.sa_intv}")
    pac_dev = torch.from_numpy(pack_pac_words(fm.pac, fm.l_pac)
                               .astype(np.int64)).to(dev)
    ref_codes = unpack_pac(fm.pac, fm.l_pac)
    for w0, wide in ((100, False), (5, True), (1, False)):
        qarr, meta = dual_meta_case(rng, ref_codes, n=4000, P=4096, Q=128,
                                    T=256, w0=w0, opt=opt, R=512,
                                    wide_r0=wide)
        args = (mat, torch.from_numpy(qarr.reshape(-1)).to(dev), pac_dev,
                torch.from_numpy(meta).to(dev))
        kw = dict(Q=128, T=256, L=qarr.shape[1], l_pac=fm.l_pac, w0=w0,
                  wide_r0=wide, **gap)
        r = compare_dual(args, kw, gap)
        errsd32.append(r["err32"])
        errsd16.append(r["err16"])
        tag = f"fused w0={w0} wide_r0={wide}"
        log(f"[2] P=4096 Q=128 T=256 {tag}: {r['rejected']} lanes rejected "
            f"at round 0 (96 pad lanes), {r['cells']} band cells; max_abs_err "
            f"int32 {r['err32']}, int16 {r['err16']}; kernel "
            f"{r['k32_ms']:.3f} / {r['k16_ms']:.3f} ms, plain "
            f"{r['p32_ms']:.3f} / {r['p16_ms']:.3f} ms")
        synth[tag] = {k: v for k, v in r.items() if k.endswith("_ms")}
        if r["err32"] or r["err16"]:
            raise SystemExit(f"the fused kernel disagrees with its plain "
                             f"version ({tag})")
        if w0 == 5 and not 96 < r["rejected"] < 4096:
            raise SystemExit("the seeded pair table rejected no real lane")

    # a Q = 1024 class through _meta_dual_core: int32 rows do not fit, so
    # it takes the tile route on the scratch kernel (two launches); int16
    # rows fit and take one fused launch
    qarr, meta = dual_meta_case(rng, ref_codes, n=400, P=512, Q=1024,
                                T=1024, w0=100, opt=opt, R=64,
                                read_len=1000)
    args = (mat, torch.from_numpy(qarr.reshape(-1)).to(dev), pac_dev,
            torch.from_numpy(meta).to(dev))
    kw = dict(Q=1024, T=1024, L=qarr.shape[1], l_pac=fm.l_pac, w0=100,
              wide_r0=False, **gap)
    for s16, kernel, n in ((False, "bsw_extend_kernel_gmem", 2),
                           (True, "bsw_meta_dual_kernel_i16", 1)):
        n0 = dict(bsw_cuda.LAUNCHES)
        got = bsw._meta_dual_core(*args, **kw, state16=s16)
        torch.cuda.synchronize()
        if bsw_cuda.LAUNCHES != dict(n0, **{kernel: n0[kernel] + n}):
            raise SystemExit(f"Q=1024 state16={s16}: expected {n} launch(es) "
                             f"of {kernel} alone: {n0} -> {bsw_cuda.LAUNCHES}")
        e = err(got, bsw._meta_dual_plain(*args, **kw, state16=s16))
        (errsd16 if s16 else errsg).append(e)
        log(f"[2] P=512 Q=1024 T=1024 _meta_dual_core, "
            f"{'int16' if s16 else 'int32'} rows: {n} x {kernel}, "
            f"max_abs_err {e}")
        if e:
            raise SystemExit("_meta_dual_core disagrees with its plain "
                             "version at Q=1024")

    # ---- phase 3: goldens on the card, each file as one chunk
    fm_t = FMIndex.from_built(build_index(
        os.path.join(ROOT, "tests", "fixtures", "tiny.fa")))
    golden_runs = {}
    for name, reader, gold, env in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam", {}),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam", {}),
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam",
             {"COMPSEED_BSW_I16": "1"})):
        reads = load_reads(reader, name)
        seeder = device_seeder(opt, fm_t, dedup=True, device=dev)
        engine = engine_under(env, fm_t, seeder)
        dp_kernel = "bsw_extend_kernel_i16" if env else "bsw_extend_kernel"
        name += " (int16 DP state)" if env else ""
        tail = NativeTail(opt, fm_t)
        seen = watch_overflow(seeder)
        done = []
        reset_counts()
        align_stream(opt, fm_t, iter([reads]), engine, seeder, tail,
                     on_done=done.extend, stats=SeedingStats())
        launches = dict(bsw_cuda.LAUNCHES)
        mine = "".join(r.sam for r in done).splitlines(keepends=True)
        want = golden(gold)
        bad = [i for i, (m, g) in enumerate(zip(mine, want)) if m != g]
        log(f"[3] {name}: one chunk of {len(reads)} reads, overflow "
            f"{[s[0] for s in seen]}, {seeder._cap_raises} cap raise(s), "
            f"rerun {seen[0][2]} s, launches {launches}; {len(mine)} "
            f"records vs {gold} ({len(want)}): {len(bad)} differ")
        if not any(s[0] for s in seen) or seeder._cap_raises < 1:
            raise SystemExit(f"{name}: the overflow path was not taken")
        if launches[dp_kernel] <= 0:
            raise SystemExit(f"{name}: the overflow path did not launch "
                             f"{dp_kernel}: {launches}")
        if len(mine) != len(want) or bad:
            raise SystemExit(f"SAM differs from {gold}: records {bad[:5]}")
        golden_runs[name] = dict(rerun_s=seen[0][2], launches=launches)

    # ---- phase 4: the main path at bench size
    CH = CHUNK

    def mk_reads(arr, start):
        return [Read(name=str(start + i), seq=bytes(
            NT4_TO_ASCII[arr[i]]).decode(), qual=None, comment=None)
            for i in range(len(arr))]

    def mk_chunks():
        out = []
        for c in range(N_CHUNKS):
            s0 = (c * CH) % len(reads_arr)
            out.append(mk_reads(
                np.concatenate([reads_arr[s0:], reads_arr[:s0]])[:CH],
                c * CH))
        return out

    n_timed = N_CHUNKS * CH
    captured = []

    def tile_route(*a, **kw):
        """The fused program by the tile route: build_tiles, one launch of
        the DP kernel per band round, the acceptance in PyTorch."""
        return bsw._meta_dual_tiles(bsw_cuda.bsw_extend_tiles, *a, **kw)

    def main_path(tag, seeder, env, dual=None):
        """Counts to 0, build the engine, one warm-up stream and RUNS
        timed ones, read the counts.  ``dual`` replaces the runner's fused
        program for this window.  Returns (record, engine, tail, SAM of
        the last stream's reads)."""
        reset_counts()
        engine = engine_under(env, fm, seeder)
        tail = NativeTail(opt, fm)
        launch = bsw_cuda.bsw_meta_dual
        fused = bsw.bsw_meta_dual

        def capture(*a, **kw):
            if len(captured) < 2:
                captured.append(((a[0], a[1], a[2], a[3].clone()),
                                 {k: v for k, v in kw.items()
                                  if k != "state16"}))
            return launch(*a, **kw)

        bsw_cuda.bsw_meta_dual = capture
        if dual is not None:
            bsw.bsw_meta_dual = dual
        try:
            t0 = time.time()
            align_stream(opt, fm, iter(mk_chunks()), engine, seeder, tail,
                         on_done=lambda _: None, stats=SeedingStats())
            torch.cuda.synchronize()
            log(f"[4] {tag}: warm-up stream {time.time() - t0:.1f} s")
            bsw_cuda.bsw_meta_dual = launch
            return timed_streams(tag, seeder, engine, tail)
        finally:
            bsw_cuda.bsw_meta_dual = launch
            bsw.bsw_meta_dual = fused

    def timed_streams(tag, seeder, engine, tail):
        tail.prof.clear()
        engine.prof.clear()
        rates, seed_s, stats, done = [], [], None, []
        for run in range(RUNS):
            done = []
            st = SeedingStats()
            t0 = time.time()
            align_stream(opt, fm, iter(mk_chunks()), engine, seeder, tail,
                         on_done=done.extend, stats=st)
            torch.cuda.synchronize()
            dt = time.time() - t0
            if len(done) != n_timed or not all(r.sam for r in done):
                raise SystemExit(f"{tag}: main path lost reads")
            if seeder.last_overflow:
                raise SystemExit(f"{tag}: unexpected cap overflow")
            rates.append(n_timed / dt)
            seed_s.append(seeder.prof.get("device_s", 0.0))
            stats = st
            log(f"[4] {tag} run {run}: {n_timed / dt:.1f} reads/s")
        launches = dict(bsw_cuda.LAUNCHES)
        prof = {k: round(v * 1e3, 1) for k, v in tail.prof.items()}
        prof.update({k: round(v * 1e3, 1) for k, v in engine.prof.items()})
        rec = dict(
            reads_per_s=statistics.median(rates), runs=rates,
            engine_call_ms_per_stream=engine.prof.get("engine_call", 0.0)
            * 1e3 / RUNS,
            bwt_hit_pct=100.0 * (stats.bwt_queries - stats.bwt_calls)
            / max(stats.bwt_queries, 1),
            sal_merged_pct=100.0 * (stats.sal_queries - stats.sal_calls)
            / max(stats.sal_queries, 1),
            bwt_rounds=stats.rounds, seed_run_flat_s_last_chunk=seed_s,
            tail_profile_ms=prof, launches=launches,
            streams=RUNS + 1, card=smi)
        log(f"[4] {tag}: " + json.dumps(rec))
        return rec, engine, tail, [r.sam for r in done]

    def oracle_check(tag, engine, seeder, tail, ref_sams):
        port_reads = mk_reads(reads_arr[:ORACLE_READS], 0)
        align_chunk(opt, fm, port_reads, 0, engine=engine, seeder=seeder,
                    tail=tail)
        bad = [i for i, (a, b) in enumerate(zip(port_reads, ref_sams))
               if a.sam != b]
        log(f"[4] {tag}: {ORACLE_READS} reads vs host oracle: {len(bad)} "
            f"differ")
        if bad:
            raise SystemExit(f"{tag}: SAM differs from the host oracle: "
                             f"reads {bad[:5]}")

    seeder = device_seeder(opt, fm, dedup=True, device=dev)
    rec32, engine32, tail32, sams32 = main_path("int32", seeder, {})
    l32 = rec32["launches"]
    if l32["bsw_meta_dual_kernel"] <= 0 or l32["probe_add_one_kernel"] <= 0:
        raise SystemExit(f"int32 main path: a kernel was not launched: {l32}")
    if l32["bsw_meta_dual_kernel_i16"] or l32["bsw_extend_kernel_i16"]:
        raise SystemExit("an int16 kernel ran without COMPSEED_BSW_I16=1")
    if l32["bsw_meta_dual_kernel"] != 8 * (RUNS + 1):
        raise SystemExit(f"int32 main path: expected 8 fused launches per "
                         f"stream: {l32}")
    reuse = (round(rec32["bwt_hit_pct"], 4), round(rec32["sal_merged_pct"], 4))
    if reuse != EXPECT_REUSE:
        raise SystemExit(f"bwt_hit_pct / sal_merged_pct are {reuse}, "
                         f"expected {EXPECT_REUSE}")

    # the host oracle path once; both engines are held to it
    t0 = time.time()
    ref_reads = mk_reads(reads_arr[:ORACLE_READS], 0)
    align_chunk(opt, fm, ref_reads, 0, engine=None, seeder=None,
                tail=NativeTail(opt, fm))
    ref_sams = [r.sam for r in ref_reads]
    log(f"[4] host oracle path, {ORACLE_READS} reads: "
        f"{time.time() - t0:.1f} s")
    oracle_check("int32", engine32, seeder, tail32, ref_sams)

    # (a) the same with int16 DP state
    rec16, engine16, tail16, sams16 = main_path(
        "int16", seeder, {"COMPSEED_BSW_I16": "1"})
    l16 = rec16["launches"]
    if l16["bsw_meta_dual_kernel_i16"] <= 0 or \
            l16["probe_add_one_kernel"] <= 0:
        raise SystemExit(f"int16 main path: a kernel was not launched: {l16}")
    if l16["bsw_meta_dual_kernel"]:
        raise SystemExit(f"int16 main path: the int32 fused kernel ran: {l16}")
    if sams16 != sams32:
        raise SystemExit("SAM differs between int32 and int16 DP state")
    oracle_check("int16", engine16, seeder, tail16, ref_sams)

    # the tile route (what the engine ran before the fused kernel), then
    # int32 once more: the windows are timed in turns (a, b, c, a) so that
    # a drift of the host's launch rate is not read as a gain
    rec_tiles, _, _, sams_tiles = main_path("int32 by the tile route",
                                            seeder, {}, dual=tile_route)
    lt = rec_tiles["launches"]
    if lt["bsw_extend_kernel"] != 16 * (RUNS + 1) or \
            lt["bsw_meta_dual_kernel"]:
        raise SystemExit(f"tile route: expected 16 DP launches per stream "
                         f"and no fused one: {lt}")
    if sams_tiles != sams32:
        raise SystemExit("SAM differs between the fused kernel and the tile "
                         "route")
    rec32b = main_path("int32 again", seeder, {})[0]

    # (c) long reads through the host seeding path and the flat-pair
    # interface: their query-length class (Q = 2048) does not fit in
    # shared memory and takes the device-memory-scratch kernel
    lrng = np.random.default_rng(LONG_SEED)
    both = np.concatenate([ref_codes, 3 - ref_codes[::-1]])
    long_arr = []
    for _ in range(LONG_READS):
        g = int(lrng.integers(0, 2 * fm.l_pac - LONG_LEN))
        seq = both[g:g + LONG_LEN].copy()
        sub = lrng.random(LONG_LEN) < 0.01
        seq[sub] = lrng.integers(0, 4, int(sub.sum()))
        j = int(lrng.integers(200, LONG_LEN - 200))
        long_arr.append(np.concatenate([seq[:j], lrng.integers(0, 4, 3),
                                        seq[j:]]))
    t0 = time.time()
    want_long = mk_reads(long_arr, 0)
    align_chunk(opt, fm, want_long, 0, engine=None, seeder=None,
                tail=NativeTail(opt, fm))
    got_long = mk_reads(long_arr, 0)
    reset_counts()
    align_chunk(opt, fm, got_long, 0, engine=engine32, seeder=None,
                tail=NativeTail(opt, fm))
    torch.cuda.synchronize()
    llong = dict(bsw_cuda.LAUNCHES)
    bad = [i for i, (a, b) in enumerate(zip(got_long, want_long))
           if a.sam != b.sam or not a.sam]
    log(f"[4] long reads: {LONG_READS} x {LONG_LEN + 3} bp, host path and "
        f"device DP engine {time.time() - t0:.1f} s, launches {llong}; "
        f"{len(bad)} differ from the host DP")
    if bad:
        raise SystemExit(f"long reads: SAM differs from the host DP: {bad}")
    if llong["bsw_extend_kernel_gmem"] <= 0:
        raise SystemExit(f"long reads: the device-memory-scratch kernel was "
                         f"not launched: {llong}")

    # (b) forced overflow: two chunks on a seeder whose round-1 pool cap
    # is too small for this input
    forced = device_seeder(opt, fm, dedup=True, dfi=seeder.dfi, device=dev)
    forced.GP_F = FORCED_GP_F
    seen = watch_overflow(forced)
    done = []
    reset_counts()
    t0 = time.time()
    align_stream(opt, fm, iter(mk_chunks()[:2]), engine32, forced, tail32,
                 on_done=done.extend, stats=SeedingStats())
    torch.cuda.synchronize()
    forced_s = time.time() - t0
    lf = dict(bsw_cuda.LAUNCHES)
    log(f"[4] forced overflow (GP_F={FORCED_GP_F}): per chunk (overflow, "
        f"GP_F after, rerun s) = {seen}; both chunks {forced_s:.1f} s; "
        f"launches {lf}")
    if lf["bsw_extend_kernel"] <= 0:
        raise SystemExit(f"forced overflow: the DP kernel was not "
                         f"launched: {lf}")
    if len(seen) != 2 or not seen[0][0] or seen[1][0]:
        raise SystemExit("forced overflow: chunk 1 must overflow and "
                         "chunk 2 must not")
    if seen[0][1] != 2 * FORCED_GP_F:
        raise SystemExit(f"forced overflow: GP_F is {seen[0][1]}, expected "
                         f"{2 * FORCED_GP_F}")
    if [r.sam for r in done] != sams32[:2 * CH]:
        raise SystemExit("forced overflow: SAM differs from the unforced "
                         "run's")
    forced_rec = dict(gp_f=FORCED_GP_F, gp_f_after=seen[0][1],
                      rerun_s=seen[0][2], reads_per_chunk=CH,
                      both_chunks_s=forced_s, launches=lf,
                      goldens=golden_runs)

    # the main path's own pair tables through every kernel and every
    # plain version
    cap = capd = None
    for args, kw in captured:
        d = compare_dual(args, kw, gap)
        tiles = d.pop("tiles")
        r = compare(tiles, gap, state16=True)
        errsd32.append(d["err32"])
        errsd16.append(d["err16"])
        errs32.append(r["err32"])
        errs16.append(r["err16"])
        errsg.append(r["errg"])
        P, Q = tiles[1].shape
        r["bound_ms"], r["bound_by"] = dp_bound_ms(tiles, r["cells"])
        d["bound_ms"], d["bound_by"] = dual_bound_ms(args[3], d["cells"])
        # the engine's call by both routes, host and card time together,
        # in turns (tiles, fused, fused, tiles)
        wall = {}
        for name, fn in (("tiles", tile_route), ("fused", bsw.bsw_meta_dual),
                         ("fused", bsw.bsw_meta_dual), ("tiles", tile_route)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(*args, **kw)
            torch.cuda.synchronize()
            wall.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3 / 5)
        d["call_wall_ms"] = wall
        log(f"[4] captured pair table P={P} Q={Q} T={tiles[3].shape[1]} "
            f"w0={kw['w0']}: fused kernel max_abs_err int32 {d['err32']}, "
            f"int16 {d['err16']}; {d['k32_ms']:.3f} / {d['k16_ms']:.3f} ms "
            f"(plain {d['p32_ms']:.3f} / {d['p16_ms']:.3f}); "
            f"{d['rejected']} lanes to round 1, {d['cells']} band cells in "
            f"both rounds, bound {d['bound_ms']:.5f} ms by {d['bound_by']}; "
            f"one engine call, wall ms: {json.dumps(wall)}")
        log(f"[4] its tiles at round 0: DP kernel max_abs_err int32 "
            f"{r['err32']}, int16 {r['err16']}, scratch {r['errg']}; int32 "
            f"{r['k32_ms']:.3f} ms (scratch kernel {r['g32_ms']:.3f}, plain "
            f"{r['p32_ms']:.3f}), int16 {r['k16_ms']:.3f} ms (plain "
            f"{r['p16_ms']:.3f}); {r['cells']} band cells, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}")
        if d["err32"] or d["err16"] or r["err32"] or r["err16"] or r["errg"]:
            raise SystemExit("a kernel disagrees with its plain version on "
                             "the main path's pairs")
        if variants:
            variant_ms[f"captured P={P} Q={Q}"] = time_scratch(
                variants, tiles, gap)
            log(f"[4] scratch kernel builds in turns, ms: "
                f"{json.dumps(variant_ms)}")
        cap, capd = cap or r, capd or d
    if cap is None:
        raise SystemExit("no pair table was captured from the main path")

    probe_bytes = 2 * 8 * 128 * 4
    probe_bound = max(probe_bytes / HBM_BYTES_PER_S,
                      8 * 128 / INT32_OPS_PER_S) * 1e3
    print(json.dumps({"build_s": build_s, "synthetic_ms": synth,
                      "self_check_ms": self_check_ms, "main": rec32,
                      "main_int16": rec16, "main_tile_route": rec_tiles,
                      "main_again": rec32b, "forced_overflow": forced_rec,
                      "long_reads_launches": llong,
                      "probe_turns_ms": probe,
                      "captured_fused": capd, "captured_tiles": cap,
                      "block_threads": threads,
                      "scratch_variants_ms": variant_ms}))
    def row(name, replaces, launches, errs, ms, plain_ms, bound, **more):
        return dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=replaces, launches=launches, max_abs_err=errs,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"],
                    library_ms=more.pop("library_ms", None), **more)

    probe_row = dict(bound_ms=probe_bound, bound_by="bytes")
    print(json.dumps({"kernels": [
        # launches: forced-overflow run (flat-pair interface after a rerun)
        row("bsw_extend_kernel", "compseed_tpu/ops/bsw_pallas.py:96",
            lf["bsw_extend_kernel"], max(errs32), cap["k32_ms"],
            cap["p32_ms"], cap),
        # launches: reads.fq as one chunk under COMPSEED_BSW_I16=1
        row("bsw_extend_kernel_i16",
            "compseed_tpu/ops/bsw_pallas.py:96 (state16)",
            golden_runs["reads.fq (int16 DP state)"]["launches"]
            ["bsw_extend_kernel_i16"], max(errs16), cap["k16_ms"],
            cap["p16_ms"], cap),
        # launches: the long reads' Q = 2048 class; times on seeded pairs
        # of that class
        row("bsw_extend_kernel_gmem",
            "compseed_tpu/ops/bsw_pallas.py:96 (query-length classes "
            "beyond shared memory)", llong["bsw_extend_kernel_gmem"],
            max(errsg), gm["k32_ms"], gm["p32_ms"], gm),
        # launches: the int32 and the int16 window of the main path
        row("bsw_meta_dual_kernel", "compseed_tpu/ops/bsw.py:234",
            l32["bsw_meta_dual_kernel"], max(errsd32), capd["k32_ms"],
            capd["p32_ms"], capd),
        row("bsw_meta_dual_kernel_i16",
            "compseed_tpu/ops/bsw.py:234 (state16)",
            l16["bsw_meta_dual_kernel_i16"], max(errsd16), capd["k16_ms"],
            capd["p16_ms"], capd),
        row("probe_add_one_kernel", "compseed_tpu/ops/bsw.py:310",
            l32["probe_add_one_kernel"], probe_err, probe_ms, probe_plain_ms,
            probe_row, library_ms=probe_lib_ms, graph_ms=probe_graph_ms,
            library_graph_ms=probe_lib_graph_ms)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
