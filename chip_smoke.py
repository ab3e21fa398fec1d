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
                for this run alone.  The int16 and the tile-route window
                time one stream each.
  5. cli      — the command line, ``compseed_tpu_torch.cli.main``, at its
                defaults (device engine on the card).  ``index`` on
                tests/fixtures/tiny.fa must write the committed index
                byte for byte; ``mem -o`` on the seven golden inputs
                (single-end FASTQ, reordered raw reads, two-file
                paired-end, -p smart pairing, ALT contigs single-end,
                with -j and paired-end) must give every SAM line but @PG
                equal to its golden.  Then at full width: the bench
                reads as a raw-reads file through ``mem -K`` (16,384
                reads a chunk), SAM byte-equal to phase 4's stream and
                the exit report's reuse equal to the expected numbers,
                reads/s of the whole command and, in turns with it, of
                the same file through align_stream without the command;
                the bench genome indexed at
                interval 32 through ``mem --sa-intv 8`` against the index
                built at 8 (equal suffix-array sample, equal SAM);
                16,384 simulated pairs through ``mem r1 r2``, the first
                512 pairs equal to ``--engine oracle``; ``mem -y 0`` on
                1,024 reads against ``--engine oracle``.  The DP launch
                counts are set to 0 before every ``mem`` run and must be
                above 0 after it.
  6. engines  — every seeding engine of ``seeder2.ENGINES`` on the card.
                (a) The first 16,384 bench reads as one chunk through
                each: head and seed matrix equal the JAX package's,
                stored in compseed_tpu_torch/engine_heads.json.  (b) Two
                more runs of that chunk per engine, a fresh seeder a run:
                seeds equal the default engine's; device seconds, BWT
                hit and SAL merged shares, overflows and per-read
                splices recorded.  (c) Cell A'':
                a seeder under COMPSEED_ADAPTIVE_CAPS=0 with the memo
                round-3 pool forced to R (MEM3_F = 1) streams phase 4's
                4 x 16,384 reads: chunk 1 alone overflows, is rerun and
                switches the forward dedup off, chunks 2-4 run the
                fwd_off engine; SAM byte-equal to phase 4's.  (d) The two
                2,000-read goldens under the all_off engine, one chunk
                each, SAM byte-equal.

With --scratch-variants (and --old-source FILE, an earlier
csrc/bsw_extend.cu whose launcher has no pairs-per-block argument) the
source is also built with the scratch variant's hoisted loads off and on,
and the builds are timed in turns on the Q = 2048 pairs and on the main
path's captured tiles, each held to the plain version first.

Prints the CLI phase's and the engine phase's numbers and the kernel
table as one JSON line each, the card's nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  Imports torch, numpy and
compseed_tpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "compseed_tpu_torch/csrc/bsw_extend.cu"
CHUNK = 16384          # reads per chunk, the bench's default
N_CHUNKS = 4
RUNS = 3               # timed streams after one warm-up stream
ORACLE_READS = 1024
PE_PAIRS = 16384       # simulated pairs through ``mem r1 r2``
PE_ORACLE_PAIRS = 512  # of them against the host oracle path
PE_INSERT = "400,50"   # -I: both runs see one insert-size distribution
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
    """Record (last_overflow, GP_F, rerun seconds, device seconds,
    fwd_disabled) after every run_flat."""
    seen = []
    run_flat = seeder.run_flat

    def watched(queries, stats=None):
        out = run_flat(queries, stats)
        seen.append((bool(seeder.last_overflow), seeder.GP_F,
                     seeder.prof.get("rerun_s") if seeder.last_overflow
                     else None, seeder.prof["device_s"],
                     seeder.fwd_disabled))
        return out

    seeder.run_flat = watched
    return seen


def sam_lines(path):
    """A SAM file's lines without @PG (the one line that names the
    command)."""
    with open(path) as f:
        return [line for line in f if not line.startswith("@PG")]


def run_cli(argv, seed_s):
    """``cli.main(argv)`` with its stderr captured.  Returns a record:
    wall seconds, the kernels' launch counts of this run alone (set to 0
    just before it), the seconds of every ``DeviceSeeder.run_flat`` call
    (``seed_s``, filled by the caller's patch), the cap-overflow lines
    and what the exit report gives.  A non-zero return code or a run
    that launched no DP kernel ends the script."""
    import torch
    from compseed_tpu_torch import cli
    from compseed_tpu_torch.ops import bsw_cuda
    for k in bsw_cuda.LAUNCHES:
        bsw_cuda.LAUNCHES[k] = 0
    del seed_s[:]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"cli {argv} returned {rc}:\n{text[-2000:]}")
    launches = dict(bsw_cuda.LAUNCHES)
    rec = dict(wall_s=wall, launches=launches, seed_s=list(seed_s),
               overflows=text.count("cap overflow"))
    if "oracle" not in argv and \
            sum(v for k, v in launches.items() if k.startswith("bsw_")) <= 0:
        raise SystemExit(f"cli {argv}: no DP kernel was launched: {launches}")
    m = re.search(r"BWT-extend: +(\d+) queries, (\d+) calls", text)
    if m:
        q, c = int(m.group(1)), int(m.group(2))
        rec["bwt_hit_pct"] = 100.0 * (q - c) / q
    m = re.search(r"SA Lookup: +(\d+) queries, (\d+) calls", text)
    if m:
        q, c = int(m.group(1)), int(m.group(2))
        rec["sal_merged_pct"] = 100.0 * (q - c) / q
    m = re.findall(r"\[mem\] processed (\d+) reads \((\d+) reads/s\)", text)
    if m:
        rec["reads"], rec["align_reads_per_s"] = int(m[-1][0]), int(m[-1][1])
    m = re.search(r"densified .* in ([0-9.]+)s", text)
    if m:
        rec["densify_s"] = float(m.group(1))
    return rec


def bare_stream(dev, prefix, reads_path, k_bases, seed_s, want_sams):
    """What ``mem -K k_bases prefix reads_path`` runs, without the
    command around it: the index loaded from its files, a new seeder,
    engine and tail, the raw-reads file through ``align_stream``.  The
    SAM must equal ``want_sams``.  Returns reads/s over all of it and the
    seconds of every ``run_flat`` call."""
    import torch
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import read_reordered_chunks
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    del seed_s[:]
    t0 = time.perf_counter()
    opt = MemOptions()
    fm = FMIndex.load(prefix)
    seeder = device_seeder(opt, fm, dedup=True, device=dev)
    engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)
    done = []
    align_stream(opt, fm, read_reordered_chunks(reads_path, k_bases), engine,
                 seeder, NativeTail(opt, fm), on_done=done.extend,
                 stats=SeedingStats())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [r.sam for r in done] != want_sams:
        raise SystemExit("align_stream on the raw-reads file: SAM differs "
                         "from phase 4's")
    return dict(reads_per_s=len(done) / wall, wall_s=wall,
                seed_s=list(seed_s))


def phase_cli(dev, smi, fm, reads_arr, main_sams, main_rec):
    """Phase 5 (see the module docstring).  ``main_sams``: phase 4's SAM
    strings of one stream of N_CHUNKS x CHUNK reads; ``main_rec``: its
    record.  Returns the numbers of the ``cli`` JSON line; its
    ``launches`` are summed over every ``mem`` run of the phase."""
    import numpy as np
    import torch
    from compseed_tpu_torch import bench_input, cli
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.ops import seeder2
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    fx = os.path.join(ROOT, "tests", "fixtures")
    seed_s = []
    total = {}
    run_flat = seeder2.DeviceSeeder.run_flat

    def mem(argv):
        rec = run_cli(["mem"] + argv, seed_s)
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
        return rec

    def timed_run_flat(self, queries, stats=None):
        t0 = time.perf_counter()
        out = run_flat(self, queries, stats)     # ends in copies to the host
        seed_s.append(time.perf_counter() - t0)
        return out

    def text_of(arr):
        return [bytes(NT4_TO_ASCII[r]).decode() for r in arr]

    out = {"card": smi}
    seeder2.DeviceSeeder.run_flat = timed_run_flat
    try:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                prefix="chip_smoke_cli_",
                dir=os.path.join(ROOT, "build")) as tmp:
            def path(name):
                return os.path.join(tmp, name)

            # ---- index: the committed fixture index, byte for byte
            t0 = time.time()
            if cli.main(["index", "-p", path("tiny"),
                         os.path.join(fx, "tiny.fa")]) != 0:
                raise SystemExit("cli index failed")
            for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
                with open(path("tiny") + ext, "rb") as f, \
                        open(os.path.join(fx, "tiny" + ext), "rb") as g:
                    if f.read() != g.read():
                        raise SystemExit(f"cli index: tiny{ext} differs from "
                                         f"the committed file")
            log(f"[5] cli index: five files byte-equal to tests/fixtures/"
                f"tiny.* ({time.time() - t0:.1f} s)")

            # ---- the seven goldens at the CLI's defaults
            alt = os.path.join(fx, "tiny_alt")
            goldens = {}
            for gold, argv in (
                    ("golden_bwamem.sam", [path("tiny"), "reads.fq"]),
                    ("golden_compseed_reordered.sam",
                     [path("tiny"), "reads.reordered"]),
                    ("golden_bwamem_pe.sam",
                     [path("tiny"), "reads_1.fq", "reads_2.fq"]),
                    ("golden_bwamem_smartpe.sam",
                     ["-p", path("tiny"), "reads_mixed.fq"]),
                    ("golden_alt_se.sam", [alt, "reads_alt.fq"]),
                    ("golden_alt_j.sam", ["-j", alt, "reads_alt.fq"]),
                    ("golden_alt_pe.sam",
                     [alt, "reads_alt_1.fq", "reads_alt_2.fq"])):
                argv = [a if os.sep in a or a.startswith("-")
                        else os.path.join(fx, a) for a in argv]
                rec = mem(["-o", path(gold)] + argv)
                mine = sam_lines(path(gold))
                want = sam_lines(os.path.join(fx, gold))
                bad = [i for i, (m, g) in enumerate(zip(mine, want))
                       if m != g]
                log(f"[5] cli mem -> {gold}: {len(mine)} lines ({len(want)} "
                    f"in the golden), {len(bad)} differ; {rec['wall_s']:.1f} "
                    f"s, {rec['overflows']} cap overflow(s), launches "
                    f"{rec['launches']}")
                if len(mine) != len(want) or bad:
                    raise SystemExit(f"cli mem: SAM differs from {gold}: "
                                     f"lines {bad[:5]}")
                goldens[gold] = dict(wall_s=rec["wall_s"],
                                     launches=rec["launches"],
                                     overflows=rec["overflows"])
            out["goldens"] = goldens

            # ---- full width: the bench reads as a raw-reads file
            n_timed = N_CHUNKS * CHUNK
            k_bases = str(CHUNK * reads_arr.shape[1])
            seqs = text_of(reads_arr)
            with open(path("bench.reads"), "w") as f:
                for c in range(N_CHUNKS):
                    s0 = (c * CHUNK) % len(seqs)
                    f.write("\n".join((seqs[s0:] + seqs[:s0])[:CHUNK]) + "\n")
            prefix8 = bench_input.index_prefix(8)
            runs = []
            for run in range(RUNS + 1):            # the first warms up
                rec = mem(["-K", k_bases, "-o", path("bench.sam"), prefix8,
                           path("bench.reads")])
                rec["reads_per_s"] = n_timed / rec["wall_s"]
                log(f"[5] cli mem -K {k_bases}, run {run}: "
                    f"{rec['reads_per_s']:.1f} reads/s for the whole command "
                    f"({rec['wall_s']:.2f} s), {rec['align_reads_per_s']} "
                    f"reads/s in its own report; seeding s per chunk "
                    f"{[round(x, 3) for x in rec['seed_s']]}")
                runs.append(rec)
            with open(path("bench.sam")) as f:
                body = "".join(l for l in f if not l.startswith("@"))
            if body != "".join(main_sams):
                raise SystemExit("cli mem at full width: SAM differs from "
                                 "phase 4's align_stream")
            last = runs[-1]
            reuse = (round(last["bwt_hit_pct"], 4),
                     round(last["sal_merged_pct"], 4))
            if reuse != EXPECT_REUSE or last["reads"] != n_timed:
                raise SystemExit(f"cli mem at full width: exit report gives "
                                 f"{reuse} over {last['reads']} reads, "
                                 f"expected {EXPECT_REUSE} over {n_timed}")
            if last["launches"]["bsw_meta_dual_kernel"] != 2 * N_CHUNKS:
                raise SystemExit(f"cli mem at full width: expected "
                                 f"{2 * N_CHUNKS} fused launches: "
                                 f"{last['launches']}")
            # the same file through align_stream alone (what the command
            # runs, without its reader and writer threads), set up from
            # the index files like the command, in turns with it
            timed = runs[1:]
            bare = []
            for turn in ("bare", "bare", "cli"):
                if turn == "cli":
                    rec = mem(["-K", k_bases, "-o", path("bench.sam"),
                               prefix8, path("bench.reads")])
                    rec["reads_per_s"] = n_timed / rec["wall_s"]
                    timed.append(rec)
                else:
                    rec = bare_stream(dev, prefix8, path("bench.reads"),
                                      int(k_bases), seed_s, main_sams)
                    bare.append(rec)
                log(f"[5] in turns, {turn}: {rec['reads_per_s']:.1f} reads/s "
                    f"with its set-up; seeding s per chunk "
                    f"{[round(x, 3) for x in rec['seed_s']]}")
            out["full_width"] = dict(
                reads=n_timed, k_bases=int(k_bases),
                reads_per_s=statistics.median(r["reads_per_s"]
                                              for r in timed),
                runs=[r["reads_per_s"] for r in timed],
                align_reads_per_s=[r["align_reads_per_s"] for r in timed],
                warm_up_reads_per_s=runs[0]["reads_per_s"],
                stream_reads_per_s=main_rec["reads_per_s"],
                bare_in_turns_reads_per_s=[r["reads_per_s"] for r in bare],
                bare_in_turns_seed_s_per_chunk=[r["seed_s"] for r in bare],
                seed_s_per_chunk=[r["seed_s"] for r in timed],
                bwt_hit_pct=last["bwt_hit_pct"],
                sal_merged_pct=last["sal_merged_pct"],
                launches=last["launches"], sam_equals_stream=True)
            log(f"[5] cli at full width: "
                f"{out['full_width']['reads_per_s']:.1f} reads/s (median of {len(timed)}; phase 4's bare stream "
                f"{main_rec['reads_per_s']:.1f}, align_stream on the same "
                f"file in turns "
                f"{[round(r['reads_per_s'], 1) for r in bare]}), SAM "
                f"byte-equal to the stream's, reuse {reuse}")

            # ---- --sa-intv: interval 32 densified to 8 on the card
            t0 = time.time()
            prefix32 = bench_input.index_prefix(32)
            build32_s = time.time() - t0
            n_half = 2 * CHUNK
            with open(path("half.reads"), "w") as f:
                f.write("\n".join((seqs + seqs)[:n_half]) + "\n")
            sa = {}
            for tag, argv in (("8", [prefix8]), ("32", [prefix32]),
                              ("32->8", ["--sa-intv", "8", prefix32]),
                              ("8 again", [prefix8])):
                rec = mem(["-K", k_bases, "-o", path("half.sam")] + argv
                          + [path("half.reads")])
                with open(path("half.sam")) as f:
                    body = "".join(l for l in f if not l.startswith("@"))
                if body != "".join(main_sams[:n_half]):
                    raise SystemExit(f"cli mem on the interval-{tag} index: "
                                     f"SAM differs from phase 4's")
                sa[tag] = dict(seed_s_per_chunk=rec["seed_s"],
                               wall_s=rec["wall_s"],
                               densify_s=rec.get("densify_s"),
                               overflows=rec["overflows"])
                log(f"[5] cli mem, index at interval {tag}: seeding s per "
                    f"chunk {[round(x, 3) for x in rec['seed_s']]}, whole "
                    f"command {rec['wall_s']:.2f} s, densify_sa "
                    f"{rec.get('densify_s')} s; SAM equal")
            if sa["32->8"]["densify_s"] is None:
                raise SystemExit("cli mem --sa-intv 8 did not densify")
            # the densified sample itself against the direct build, and
            # densify_sa timed alone
            from compseed_tpu_torch.ops.device_index import (densify_sa,
                                                             to_device)
            dfi32 = to_device(FMIndex.load(prefix32), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dfi8 = densify_sa(dfi32, 8)
            torch.cuda.synchronize()
            densify_s = time.perf_counter() - t0
            want = torch.from_numpy(fm.sa_sampled.astype(np.int64)).to(dev)
            if dfi8.sa_sampled.dtype != dfi32.sa_sampled.dtype or \
                    not torch.equal(dfi8.sa_sampled.to(torch.int64), want):
                raise SystemExit("densify_sa(32 -> 8) differs from the index "
                                 "built at interval 8")
            out["sa_intv"] = dict(runs=sa, densify_s=densify_s,
                                  samples=int(want.numel()),
                                  build32_s=build32_s, reads=n_half)
            log(f"[5] densify_sa 32 -> 8 on the card: {densify_s:.3f} s for "
                f"{want.numel()} samples, equal to the direct build "
                f"(interval-32 index built in {build32_s:.1f} s)")

            # ---- paired-end at full width
            t0 = time.time()
            r1, r2 = bench_input.pe_pairs(PE_PAIRS)
            for name, arr in (("pe_1.fq", r1), ("pe_2.fq", r2)):
                qual = "I" * arr.shape[1]
                with open(path(name), "w") as f:
                    f.write("".join(f"@p{i}\n{s}\n+\n{qual}\n"
                                    for i, s in enumerate(text_of(arr))))
                with open(path(name)) as f, open(path("o" + name), "w") as g:
                    for _ in range(4 * PE_ORACLE_PAIRS):
                        g.write(f.readline())
            log(f"[5] {PE_PAIRS} pairs simulated and written in "
                f"{time.time() - t0:.1f} s")
            pe_runs = []
            for run in range(RUNS + 1):
                rec = mem(["-I", PE_INSERT, "-K", k_bases, "-o",
                           path("pe.sam"), prefix8, path("pe_1.fq"),
                           path("pe_2.fq")])
                rec["reads_per_s"] = 2 * PE_PAIRS / rec["wall_s"]
                log(f"[5] cli mem r1 r2, run {run}: {rec['reads_per_s']:.1f} "
                    f"reads/s for the whole command, "
                    f"{rec['align_reads_per_s']} in its own report; seeding "
                    f"s per chunk {[round(x, 3) for x in rec['seed_s']]}; "
                    f"{rec['overflows']} cap overflow(s); launches "
                    f"{rec['launches']}")
                pe_runs.append(rec)
            t0 = time.time()
            mem(["--engine", "oracle", "-I", PE_INSERT, "-o",
                 path("pe_oracle.sam"), prefix8, path("ope_1.fq"),
                 path("ope_2.fq")])
            oracle_s = time.time() - t0
            want = sam_lines(path("pe_oracle.sam"))
            mine = sam_lines(path("pe.sam"))
            n_hdr = sum(l.startswith("@") for l in want)
            names = {f"p{i}" for i in range(PE_ORACLE_PAIRS)}
            head = [l for l in mine if l.startswith("@")
                    or l.split("\t", 1)[0] in names]
            bad = [i for i, (m, g) in enumerate(zip(head, want)) if m != g]
            flags = [int(l.split("\t")[1]) for l in mine[n_hdr:]]
            proper = sum(1 for f in flags if f & 0x2 and not f & 0x900)
            log(f"[5] paired-end: {len(mine) - n_hdr} records for "
                f"{2 * PE_PAIRS} reads, {proper} primary records properly "
                f"paired; first {PE_ORACLE_PAIRS} pairs vs --engine oracle "
                f"({oracle_s:.1f} s): {len(bad)} of {len(want)} lines differ")
            if len(head) != len(want) or bad:
                raise SystemExit(f"paired-end: SAM differs from the host "
                                 f"oracle path: lines {bad[:5]}")
            if proper < PE_PAIRS:
                raise SystemExit(f"paired-end: only {proper} of "
                                 f"{2 * PE_PAIRS} reads properly paired")
            out["paired_end"] = dict(
                pairs=PE_PAIRS, insert=PE_INSERT,
                reads_per_s=statistics.median(r["reads_per_s"]
                                              for r in pe_runs[1:]),
                runs=[r["reads_per_s"] for r in pe_runs[1:]],
                align_reads_per_s=[r["align_reads_per_s"]
                                   for r in pe_runs[1:]],
                seed_s_per_chunk=[r["seed_s"] for r in pe_runs[1:]],
                launches=pe_runs[-1]["launches"],
                overflows=[r["overflows"] for r in pe_runs],
                properly_paired=proper, oracle_pairs=PE_ORACLE_PAIRS,
                oracle_s=oracle_s)

            # ---- -y 0: the lockstep round 3 in the seeder
            with open(path("y0.reads"), "w") as f:
                f.write("\n".join(seqs[:ORACLE_READS]) + "\n")
            rec = mem(["-y", "0", "-o", path("y0.sam"), prefix8,
                       path("y0.reads")])
            t0 = time.time()
            mem(["-y", "0", "--engine", "oracle", "-o",
                 path("y0_oracle.sam"), prefix8, path("y0.reads")])
            mine, want = sam_lines(path("y0.sam")), \
                sam_lines(path("y0_oracle.sam"))
            bad = [i for i, (m, g) in enumerate(zip(mine, want)) if m != g]
            log(f"[5] cli mem -y 0: {ORACLE_READS} reads, seeding "
                f"{[round(x, 3) for x in rec['seed_s']]} s, launches "
                f"{rec['launches']}; vs --engine oracle "
                f"({time.time() - t0:.1f} s): {len(bad)} lines differ")
            if len(mine) != len(want) or bad:
                raise SystemExit(f"-y 0: SAM differs from the host oracle "
                                 f"path: lines {bad[:5]}")
            out["y0"] = dict(reads=ORACLE_READS, seed_s=rec["seed_s"],
                             launches=rec["launches"],
                             overflows=rec["overflows"])
            out["launches"] = total
    finally:
        seeder2.DeviceSeeder.run_flat = run_flat
    return out


@contextlib.contextmanager
def engine_env(knobs):
    """The env knobs that select a seeding engine, set for the block."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def head_record(head, seedpk):
    """A seeder head's 28 scalars and digests of the whole head and seed
    matrix, as ``compseed_tpu_torch/engine_heads.json`` stores them."""
    import hashlib
    import numpy as np
    return dict(
        scalars=[int(x) for x in head[:28]],
        head_sha256=hashlib.sha256(
            np.ascontiguousarray(head, np.int32).tobytes()).hexdigest(),
        seedpk_sha256=hashlib.sha256(
            np.ascontiguousarray(seedpk, np.int32).tobytes()).hexdigest())


def reuse_of(head):
    """(bwt_hit_pct, sal_merged_pct) of one chunk from its head."""
    q = int(head[18]) + int(head[20]) + sum(int(x) for x in head[22:28:2])
    c = int(head[19]) + int(head[21]) + sum(int(x) for x in head[23:28:2])
    return 100.0 * (q - c) / q, 100.0 * (int(head[1]) - int(head[2])) / \
        int(head[1])


def phase_engines(dev, smi, opt, fm, fm_t, reads_arr, dfi, engine, tail,
                  chunks, main_sams):
    """Phase 6 (see the module docstring).  ``chunks``: phase 4's stream
    of N_CHUNKS x CHUNK reads; ``main_sams`` its SAM.  Returns the numbers
    of the ``engines`` JSON line."""
    import numpy as np
    import torch
    from compseed_tpu_torch.io.fastq import (read_fastq_chunks,
                                             read_reordered_chunks)
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.engine import device_engine
    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats

    with open(os.path.join(ROOT, "compseed_tpu_torch",
                           "engine_heads.json")) as f:
        stored = json.load(f)
    n_head = stored["chunk"]["reads"]
    out = {"card": smi, "heads_from": stored["command"]}

    def seeder_for(dedup, fm_=fm, dfi_=dfi):
        return DeviceSeeder(opt, fm_, dev, dfi=dfi_, dedup=dedup)

    # ---- (a) the first chunk through each engine: head and seed matrix
    # against the JAX package's constants; (b) then, on a fresh seeder a
    # run (an overflow switches the next run's engine), two timed runs
    # whose seeds must equal the default engine's
    if n_head != CHUNK:
        raise SystemExit(f"engine_heads.json holds a {n_head}-read chunk, "
                         f"phase 6 runs {CHUNK}")
    queries = list(reads_arr[:CHUNK])
    want = None
    full = {}
    for name, (dedup, env) in ENGINES.items():
        runs, spliced, overflows, rerun_s = [], [], [], []
        with engine_env(env):
            sd = seeder_for(dedup)
            R, L, qd, rd = sd._upload(queries)
            t0 = time.time()
            _, _, head, seedpk = sd._run(sd._build(R, L), qd, rd)
            head, seedpk = head.cpu().numpy(), seedpk.cpu().numpy()
            first_s = time.time() - t0
            rec = head_record(head, seedpk)
            if rec != stored["engines"][name]:
                raise SystemExit(f"engine {name}: the head of the first "
                                 f"chunk differs from the JAX package's: "
                                 f"{rec} vs {stored['engines'][name]}")
            for _ in range(2):
                sd = seeder_for(dedup)
                orig = sd._splice_oracle

                def splice(qs, bad, *a, orig=orig):
                    spliced.append(len(bad))
                    return orig(qs, bad, *a)

                sd._splice_oracle = splice
                got = sd.run_flat(queries)
                runs.append(sd.prof["device_s"])
                overflows.append(bool(sd.last_overflow))
                if sd.last_overflow:
                    rerun_s.append(sd.prof["rerun_s"])
        if want is None:
            want = got
        if any(not np.array_equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"engine {name}: (lrep, sflat, soff) of the "
                             f"first chunk differ from the default engine's")
        hit, merged = reuse_of(head)
        full[name] = dict(device_s=statistics.median(runs), runs=runs,
                          first_run_s=first_s, bwt_hit_pct=hit,
                          sal_merged_pct=merged, scalars=rec["scalars"],
                          overflow=overflows, rerun_s=rerun_s,
                          splice_reads=spliced)
        log(f"[6] {name}: {CHUNK} reads, head and seed matrix equal the JAX "
            f"package's; device_s {[round(x, 4) for x in runs]} (first run "
            f"{first_s:.3f} s), BWT hit {hit:.4f} %, SAL merged "
            f"{merged:.4f} %, overflow flags {rec['scalars'][3:14]}, rerun "
            f"{rerun_s}, splice {spliced}; seeds equal the default engine's")
    out["full_width"] = full

    # ---- (c) cell A'': COMPSEED_ADAPTIVE_CAPS=0 and one forced switch
    with engine_env({"COMPSEED_ADAPTIVE_CAPS": "0"}):
        sd = seeder_for(True)
    sd.MEM3_F = 1
    seen = watch_overflow(sd)
    done = []
    for k in bsw_cuda.LAUNCHES:
        bsw_cuda.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    align_stream(opt, fm, iter(chunks), engine, sd, tail,
                 on_done=done.extend, stats=SeedingStats())
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(bsw_cuda.LAUNCHES)
    log(f"[6] (c) A'': per chunk (overflow, GP_F, rerun s, device s, "
        f"fwd_disabled) = {seen}; {len(done) / wall:.1f} reads/s; launches "
        f"{launches}")
    if [s[0] for s in seen] != [True] + [False] * (len(chunks) - 1):
        raise SystemExit("A'': chunk 1 alone must overflow")
    if not all(s[4] for s in seen) or sd.bwd_disabled or not sd.r2_dedup \
            or sd._cap_raises:
        raise SystemExit("A'': the overflow must switch the forward dedup "
                         "off and nothing else")
    if [r.sam for r in done] != main_sams:
        raise SystemExit("A'': SAM differs from phase 4's stream")
    if launches["bsw_meta_dual_kernel"] <= 0:
        raise SystemExit(f"A'': the fused DP kernel was not launched: "
                         f"{launches}")
    out["a2"] = dict(reads=len(done), reads_per_s=len(done) / wall,
                     wall_s=wall, rerun_s=seen[0][2],
                     device_s_per_chunk=[s[3] for s in seen],
                     overflow_flags=sd.prof["overflow_flags"],
                     launches=launches, sam_equals_stream=True)

    # ---- (d) the two 2,000-read goldens under all_off, one chunk each
    goldens = {}
    for name, reader, gold in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam"),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam")):
        reads = load_reads(reader, name)
        sd = seeder_for(False, fm_t, None)
        spliced = []
        orig = sd._splice_oracle

        def splice(qs, bad, *a, orig=orig):
            spliced.append(len(bad))
            return orig(qs, bad, *a)

        sd._splice_oracle = splice
        seen = watch_overflow(sd)
        eng = device_engine(opt, fm_t, dfi=sd.dfi, device=dev)
        done = []
        t0 = time.time()
        align_stream(opt, fm_t, iter([reads]), eng, sd, NativeTail(opt, fm_t),
                     on_done=done.extend, stats=SeedingStats())
        mine = "".join(r.sam for r in done).splitlines(keepends=True)
        want_g = golden(gold)
        bad = [i for i, (m, g) in enumerate(zip(mine, want_g)) if m != g]
        log(f"[6] (d) {name} under all_off: one chunk of {len(reads)} reads, "
            f"(overflow, GP_F, rerun s, device s, fwd_disabled) {seen}, "
            f"flags {sd.prof.get('overflow_flags')}, splice {spliced}; "
            f"{len(bad)} of {len(want_g)} records differ from {gold} "
            f"({time.time() - t0:.1f} s)")
        if len(mine) != len(want_g) or bad:
            raise SystemExit(f"all_off: SAM differs from {gold}: {bad[:5]}")
        goldens[name] = dict(overflow=seen[0][0], rerun_s=seen[0][2],
                             overflow_flags=sd.prof.get("overflow_flags"),
                             splice_reads=spliced)
    out["goldens_all_off"] = goldens
    return out


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
        # named from 1, as the raw-reads reader names a compressor's output
        return [Read(name=str(start + i + 1), seq=bytes(
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

    def main_path(tag, seeder, env, dual=None, runs=RUNS):
        """Counts to 0, build the engine, one warm-up stream and ``runs``
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
            return timed_streams(tag, seeder, engine, tail, runs)
        finally:
            bsw_cuda.bsw_meta_dual = launch
            bsw.bsw_meta_dual = fused

    def timed_streams(tag, seeder, engine, tail, runs):
        tail.prof.clear()
        engine.prof.clear()
        rates, seed_s, stats, done = [], [], None, []
        for run in range(runs):
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
            * 1e3 / runs,
            bwt_hit_pct=100.0 * (stats.bwt_queries - stats.bwt_calls)
            / max(stats.bwt_queries, 1),
            sal_merged_pct=100.0 * (stats.sal_queries - stats.sal_calls)
            / max(stats.sal_queries, 1),
            bwt_rounds=stats.rounds, seed_run_flat_s_last_chunk=seed_s,
            tail_profile_ms=prof, launches=launches,
            streams=runs + 1, card=smi)
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
        "int16", seeder, {"COMPSEED_BSW_I16": "1"}, runs=1)
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
                                            seeder, {}, dual=tile_route,
                                            runs=1)
    lt = rec_tiles["launches"]
    if lt["bsw_extend_kernel"] != 16 * 2 or \
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

    # ---- phase 5: the command line
    cli_rec = phase_cli(dev, smi, fm, reads_arr, sams32, rec32)

    # ---- phase 6: the seeding engines
    t0 = time.time()
    eng_rec = phase_engines(dev, smi, opt, fm, fm_t, reads_arr, seeder.dfi,
                            engine32, tail32, mk_chunks(), sams32)
    eng_rec["phase_s"] = time.time() - t0
    log(f"[6] engines: {eng_rec['phase_s']:.1f} s")

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
    print(json.dumps({"cli": cli_rec}))
    print(json.dumps({"engines": eng_rec}))

    def row(name, replaces, launches, errs, ms, plain_ms, bound, **more):
        return dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=replaces, launches=launches, max_abs_err=errs,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"],
                    library_ms=more.pop("library_ms", None),
                    cli_launches=cli_rec["launches"][name],
                    a2_launches=eng_rec["a2"]["launches"][name], **more)

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
