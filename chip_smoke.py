"""Smoke run of compseed_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  0. device   — a CUDA card must be present; prints its nvidia-smi
                name and power limit.
  1. build    — compiles csrc/bsw_extend.cu with nvcc for sm_90a (and,
                beside it, the host tail with g++), loads the library
                and runs its launch self-check: the probe kernel against
                its plain version; a wrong tile is fatal.
  2. kernels  — the DP kernel against its plain PyTorch version on the
                card, exactly, on seeded random pairs at the main path's
                shapes (z-drop breaks, band shrink, h0 near the bound,
                empty queries, tlen=0 lanes); on a second set whose h0
                keeps the int16 gate, three ways: int16 kernel == plain
                int16 version == int32 kernel.
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
                byte-equal to the host oracle path; the DP tiles
                captured from the first chunk go through the int32
                kernel, the int16 kernel and their plain versions once
                more.  Then a forced overflow: a fresh seeder with
                GP_F=18 takes two chunks; the first must overflow, be
                rerun on the lockstep seeder and double GP_F, the second
                must not overflow, the SAM of both must equal the
                unforced run's, and the DP kernel's launches are counted
                for this run alone.

Prints the kernel table as one JSON line, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Imports torch,
numpy and compseed_tpu_torch only.
"""

from __future__ import annotations

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


def random_pairs(rng, P: int, Q: int, T: int, big_h0: bool = True):
    """Extension-like pairs with the DP's corner cases mixed in."""
    import numpy as np
    qlens = rng.integers(1, 102, P).astype(np.int32)
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


def dp_bound_ms(tiles, cells: int):
    """(bound_ms, bound_by) of one DP launch: each input read once and
    the output written once over the HBM rate, against the band cells
    this data needs times the operations per cell over the int32 peak."""
    mat, q, ql, t, tl, h0, ws = tiles
    P = q.shape[0]
    nbytes = sum(x.numel() * x.element_size() for x in tiles) + P * 8 * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = cells * OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def compare(tiles, gap, state16: bool):
    """One set of DP tiles through the int32 kernel and its plain
    version and, with state16, also the int16 kernel and its plain
    version.  Returns a dict of max_abs_err and times per variant plus
    the band cells counted by the plain version's loop bounds."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core
    mat, q, ql, t, tl, h0, ws = tiles

    def kern(s16):
        return lambda: bsw_cuda.bsw_extend_tiles(mat, q, ql, t, tl, h0, ws,
                                                 **gap, state16=s16)

    def plain(s16, count=False):
        return lambda: _extend_core(
            gap["o_del"], gap["e_del"], gap["o_ins"], gap["e_ins"],
            gap["zdrop"], mat, ws[:, 0], q, ql[:, 0], t, tl[:, 0], h0[:, 0],
            state16=s16, count_cells=count)

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    p32, cells = plain(False, count=True)()
    k32 = kern(False)()[:, :6]
    torch.cuda.synchronize()
    out = dict(cells=int(cells), err32=err(k32, p32.T),
               k32_ms=cuda_time_ms(kern(False), 5),
               p32_ms=cuda_time_ms(plain(False), 2))
    if state16:
        k16 = kern(True)()[:, :6]
        p16 = plain(True)().T
        torch.cuda.synchronize()
        out.update(err16=max(err(k16, p16), err(k16, k32)),
                   k16_ms=cuda_time_ms(kern(True), 5),
                   p16_ms=cuda_time_ms(plain(True), 2))
    return out


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
    from compseed_tpu_torch.ops import bsw_cuda
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
    probe_ms = cuda_time_ms(lambda: bsw_cuda.probe_add_one(x), 20)
    probe_plain_ms = cuda_time_ms(lambda: bsw_cuda._probe_plain(x), 20)
    probe_lib_ms = cuda_time_ms(lambda: torch.add(x, 1), 20)
    t0 = time.perf_counter()
    bsw_cuda.self_check(dev)
    self_check_ms = (time.perf_counter() - t0) * 1e3
    log(f"[1] self-check passed: probe max_abs_err {probe_err}; kernel "
        f"{probe_ms:.4f} ms, plain {probe_plain_ms:.4f} ms, torch.add "
        f"{probe_lib_ms:.4f} ms; one "
        f"self_check() {self_check_ms:.3f} ms of wall time")
    if probe_err:
        raise SystemExit("probe kernel disagrees with its plain version")

    # ---- phase 2: kernels vs plain versions, synthetic pairs
    rng = np.random.default_rng(2024)
    errs32, errs16 = [], []
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
            tag = f"T={T} {'h0 near bound' if big_h0 else 'h0 < 120'}"
            msg = (f"[2] P=4096 Q=128 {tag}: int32 kernel vs plain "
                   f"max_abs_err {r['err32']}; kernel {r['k32_ms']:.3f} ms, "
                   f"plain {r['p32_ms']:.3f} ms")
            if not big_h0:
                errs16.append(r["err16"])
                msg += (f"; int16 kernel vs plain int16 vs int32 kernel "
                        f"max_abs_err {r['err16']}; kernel "
                        f"{r['k16_ms']:.3f} ms, plain {r['p16_ms']:.3f} ms")
            log(msg)
            synth[tag] = {k: v for k, v in r.items() if k.endswith("_ms")}
            if r["err32"] or r.get("err16"):
                raise SystemExit(f"a kernel disagrees with its plain "
                                 f"version ({tag})")

    # ---- phase 3: goldens on the card, each file as one chunk
    fm_t = FMIndex.from_built(build_index(
        os.path.join(ROOT, "tests", "fixtures", "tiny.fa")))
    golden_runs = {}
    for name, reader, gold in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam"),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam")):
        reads = load_reads(reader, name)
        seeder = device_seeder(opt, fm_t, dedup=True, device=dev)
        engine = device_engine(opt, fm_t, dfi=seeder.dfi, device=dev)
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
        if launches["bsw_extend_kernel"] <= 0:
            raise SystemExit(f"{name}: the overflow path did not launch "
                             f"the DP kernel: {launches}")
        if len(mine) != len(want) or bad:
            raise SystemExit(f"SAM differs from {gold}: records {bad[:5]}")
        golden_runs[name] = dict(rerun_s=seen[0][2], launches=launches)

    # ---- phase 4: the main path at bench size
    t0 = time.time()
    fm, reads_arr = bench_input.setup()
    log(f"[4] bench input ready in {time.time() - t0:.1f} s: genome "
        f"{fm.l_pac} bp, {len(reads_arr)} reads, sa_intv {fm.sa_intv}")
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

    def main_path(tag, seeder, env):
        """Counts to 0, build the engine, one warm-up stream and RUNS
        timed ones, read the counts.  Returns (record, engine, SAM of
        the last stream's reads)."""
        reset_counts()
        os.environ.update(env)
        try:
            engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)
        finally:
            for k in env:
                del os.environ[k]
        tail = NativeTail(opt, fm)
        launch = bsw_cuda.bsw_extend_tiles

        def capture(*a, **kw):
            if len(captured) < 2 and a[1].device.type == dev.type:
                captured.append(tuple(x.clone() for x in a))
            return launch(*a, **kw)

        bsw_cuda.bsw_extend_tiles = capture
        try:
            t0 = time.time()
            align_stream(opt, fm, iter(mk_chunks()), engine, seeder, tail,
                         on_done=lambda _: None, stats=SeedingStats())
            torch.cuda.synchronize()
        finally:
            bsw_cuda.bsw_extend_tiles = launch
        log(f"[4] {tag}: warm-up stream {time.time() - t0:.1f} s")
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
    if l32["bsw_extend_kernel"] <= 0 or l32["probe_add_one_kernel"] <= 0:
        raise SystemExit(f"int32 main path: a kernel was not launched: {l32}")
    if l32["bsw_extend_kernel_i16"]:
        raise SystemExit("the int16 kernel ran without COMPSEED_BSW_I16=1")
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
    if l16["bsw_extend_kernel_i16"] <= 0 or l16["probe_add_one_kernel"] <= 0:
        raise SystemExit(f"int16 main path: a kernel was not launched: {l16}")
    if sams16 != sams32:
        raise SystemExit("SAM differs between int32 and int16 DP state")
    oracle_check("int16", engine16, seeder, tail16, ref_sams)

    # int32 once more, so the two states are timed in turns (a, b, a)
    # and a drift of the host's launch rate is not read as a gain
    rec32b = main_path("int32 again", seeder, {})[0]

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

    # the main path's own DP tiles through every variant
    cap = None
    for tiles in captured:
        r = compare(tiles, gap, state16=True)
        errs32.append(r["err32"])
        errs16.append(r["err16"])
        P, Q = tiles[1].shape
        bound_ms, bound_by = dp_bound_ms(tiles, r["cells"])
        r.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"[4] captured tiles P={P} Q={Q} T={tiles[3].shape[1]}: "
            f"max_abs_err int32 {r['err32']}, int16 {r['err16']}; int32 "
            f"kernel {r['k32_ms']:.3f} ms (plain {r['p32_ms']:.3f}), int16 "
            f"kernel {r['k16_ms']:.3f} ms (plain {r['p16_ms']:.3f}); "
            f"{r['cells']} band cells, bound {bound_ms:.5f} ms by "
            f"{bound_by}")
        if r["err32"] or r["err16"]:
            raise SystemExit("a kernel disagrees with its plain version on "
                             "the main path's tiles")
        cap = cap or r
    if cap is None:
        raise SystemExit("no DP tiles were captured from the main path")

    probe_bytes = 2 * 8 * 128 * 4
    probe_bound = max(probe_bytes / HBM_BYTES_PER_S,
                      8 * 128 / INT32_OPS_PER_S) * 1e3
    print(json.dumps({"build_s": build_s, "synthetic_ms": synth,
                      "self_check_ms": self_check_ms, "main": rec32,
                      "main_int16": rec16, "main_again": rec32b,
                      "forced_overflow": forced_rec}))
    print(json.dumps({"kernels": [
        {"name": "bsw_extend_kernel", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "compseed_tpu/ops/bsw_pallas.py:96",
         "launches": l32["bsw_extend_kernel"], "max_abs_err": max(errs32),
         "ms": cap["k32_ms"], "plain_ms": cap["p32_ms"],
         "bound_ms": cap["bound_ms"], "bound_by": cap["bound_by"],
         "library_ms": None},
        {"name": "bsw_extend_kernel_i16", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "compseed_tpu/ops/bsw_pallas.py:96 (state16)",
         "launches": l16["bsw_extend_kernel_i16"],
         "max_abs_err": max(errs16), "ms": cap["k16_ms"],
         "plain_ms": cap["p16_ms"], "bound_ms": cap["bound_ms"],
         "bound_by": cap["bound_by"], "library_ms": None},
        {"name": "probe_add_one_kernel", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": "compseed_tpu/ops/bsw.py:310",
         "launches": l32["probe_add_one_kernel"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms,
         "bound_ms": probe_bound, "bound_by": "bytes",
         "library_ms": probe_lib_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
