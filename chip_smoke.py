"""Smoke run of compseed_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  0. device   — a CUDA card must be present; prints its nvidia-smi
                name and power limit.
  1. build    — compiles csrc/bsw_extend.cu with nvcc for sm_90a.
  2. kernel   — the DP kernel against its plain PyTorch version on the
                card, exactly, on seeded random pairs at the main path's
                shapes (z-drop breaks, band shrink, h0 near the bound,
                empty queries, tlen=0 lanes).
  3. goldens  — tests/fixtures reads through align_stream with the
                port's seeder, DP engine and the native tail: SAM must be
                byte-equal to the committed bwamem / CompSeed goldens.
  4. main     — bench.py's input (2 Mbp repeat-structured genome,
                sa_intv=8, 30x layout-ordered 101 bp reads): 4 chunks of
                16,384 reads through align_stream, one warm-up stream and
                3 timed ones; the DP kernel must have launched; the
                first 1,024 reads must give SAM byte-equal to the host
                oracle path; the DP tiles captured from the first chunk
                go through kernel and plain version once more.

Prints the kernel table as one JSON line, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "compseed_tpu_torch/csrc/bsw_extend.cu"
KERNEL_REPLACES = "compseed_tpu/ops/bsw_pallas.py:96"
CHUNK = 16384          # reads per chunk, bench.py's default
N_CHUNKS = 4
RUNS = 3               # timed streams after one warm-up stream
ORACLE_READS = 1024


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


def random_pairs(rng, P: int, Q: int, T: int):
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
    h0[::13] = rng.integers(400, 1 << 14, len(h0[::13]))  # h0 near bound
    ws = rng.choice([1, 5, 50, 100], P).astype(np.int32)
    return queries, qlens, targets, tlens, h0, ws


def compare(tiles, gap):
    """Kernel vs plain version on one set of DP tiles; returns
    (max_abs_err, kernel_ms, plain_ms)."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core
    mat, q, ql, t, tl, h0, ws = tiles

    def kern():
        return bsw_cuda.bsw_extend_tiles(mat, q, ql, t, tl, h0, ws, **gap)

    def plain():
        return _extend_core(gap["o_del"], gap["e_del"], gap["o_ins"],
                            gap["e_ins"], gap["zdrop"], mat, ws[:, 0], q,
                            ql[:, 0], t, tl[:, 0], h0[:, 0])

    k = kern()[:, :6]
    p = plain().T
    torch.cuda.synchronize()
    err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
    return err, cuda_time_ms(kern, 5), cuda_time_ms(plain, 2)


def load_reads(reader, name):
    reads = []
    for chunk in reader(os.path.join(ROOT, "tests", "fixtures", name),
                        10_000_000):
        reads.extend(chunk)
    return reads


def golden(name):
    with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
        return [line for line in f if not line.startswith("@")]


def main() -> None:
    # ---- phase 0: device
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this needs a "
            "CUDA card")
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import numpy as np

    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder

    from compseed_tpu.index.build import build_index
    from compseed_tpu.index.fmindex import FMIndex
    from compseed_tpu.io.fastq import (Read, read_fastq_chunks,
                                       read_reordered_chunks)
    from compseed_tpu.native import NativeTail
    from compseed_tpu.options import MemOptions
    from compseed_tpu.pipeline.align import align_chunk, align_stream
    from compseed_tpu.pipeline.seeding import SeedingStats
    from compseed_tpu.utils import NT4_TO_ASCII

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[0] device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    opt = MemOptions()
    gap = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
               e_ins=opt.e_ins, zdrop=opt.zdrop)
    mat = torch.tensor(np.array(opt.mat, np.int32).reshape(5, 5),
                       device=dev)

    # ---- phase 1: build
    t0 = time.time()
    bsw_cuda.build_library(force=True)
    build_s = time.time() - t0
    log(f"[1] build: {build_s:.2f} s")

    # ---- phase 2: kernel vs plain version, synthetic pairs
    rng = np.random.default_rng(2024)
    errs = []
    synth = {}
    for T in (128, 256):
        q, ql, t, tl, h0, ws = random_pairs(rng, 4096, 128, T)
        tiles = (mat,) + tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (q, ql[:, None], t, tl[:, None], h0[:, None],
                      ws[:, None]))
        err, k_ms, p_ms = compare(tiles, gap)
        errs.append(err)
        synth[T] = (k_ms, p_ms)
        log(f"[2] kernel vs plain, P=4096 Q=128 T={T}: max_abs_err {err}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if err:
            raise SystemExit(f"kernel disagrees with plain version (T={T})")

    # ---- phase 3: goldens on the card
    fm_t = FMIndex.from_built(build_index(
        os.path.join(ROOT, "tests", "fixtures", "tiny.fa")))
    for name, reader, gold in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam"),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam")):
        reads = load_reads(reader, name)
        seeder = device_seeder(opt, fm_t, dedup=True, device=dev)
        engine = device_engine(opt, fm_t, dfi=seeder.dfi, device=dev)
        tail = NativeTail(opt, fm_t)
        # 100-read chunks: larger ones trip sa_batch_compact's stage caps
        # on this sa_intv=32 index, where the exact rerun is not ported
        chunks = [reads[s:s + 100] for s in range(0, len(reads), 100)]
        done = []
        align_stream(opt, fm_t, iter(chunks), engine, seeder, tail,
                     on_done=done.extend, stats=SeedingStats())
        mine = "".join(r.sam for r in done).splitlines(keepends=True)
        want = golden(gold)
        bad = [i for i, (m, g) in enumerate(zip(mine, want)) if m != g]
        log(f"[3] {name}: {len(mine)} records vs {gold} ({len(want)}): "
            f"{len(bad)} differ")
        if len(mine) != len(want) or bad:
            raise SystemExit(f"SAM differs from {gold}: records {bad[:5]}")

    # ---- phase 4: the main path at bench size
    import bench
    t0 = time.time()
    fm, reads_arr = bench._setup()
    log(f"[4] bench input ready in {time.time() - t0:.1f} s: genome "
        f"{fm.l_pac} bp, {len(reads_arr)} reads, sa_intv {fm.sa_intv}")
    seeder = device_seeder(opt, fm, dedup=True, device=dev)
    engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)
    tail = NativeTail(opt, fm)
    CH = CHUNK

    def mk_reads(arr, start):
        return [Read(name=str(start + i), seq=bytes(
            NT4_TO_ASCII[arr[i]]).decode(), qual=None, comment=None)
            for i in range(len(arr))]

    chunks_ro = []
    for c in range(N_CHUNKS):
        s0 = (c * CH) % len(reads_arr)
        chunks_ro.append(mk_reads(
            np.concatenate([reads_arr[s0:], reads_arr[:s0]])[:CH], c * CH))

    # capture the first chunk's DP tiles (inputs of its first calls)
    captured = []
    launch = bsw_cuda.bsw_extend_tiles

    def capture(*a, **kw):
        if len(captured) < 2 and a[1].is_cuda:
            captured.append(tuple(x.clone() for x in a))
        return launch(*a, **kw)

    bsw_cuda.bsw_extend_tiles = capture
    t0 = time.time()
    align_stream(opt, fm, iter(list(chunks_ro)), engine, seeder, tail,
                 on_done=lambda _: None, stats=SeedingStats())
    torch.cuda.synchronize()
    bsw_cuda.bsw_extend_tiles = launch
    log(f"[4] warm-up stream: {time.time() - t0:.1f} s")
    tail.prof.clear()
    engine.prof.clear()

    n_timed = N_CHUNKS * CH
    rates, seed_s = [], []
    stats = None
    bsw_cuda.LAUNCHES = 0
    for run in range(RUNS):
        done = []
        st = SeedingStats()
        t0 = time.time()
        align_stream(opt, fm, iter(list(chunks_ro)), engine, seeder, tail,
                     on_done=done.extend, stats=st)
        torch.cuda.synchronize()
        dt = time.time() - t0
        if len(done) != n_timed or not all(r.sam for r in done):
            raise SystemExit("main path lost reads")
        rates.append(n_timed / dt)
        seed_s.append(seeder.prof.get("device_s", 0.0))
        stats = st
        log(f"[4] run {run}: {n_timed / dt:.1f} reads/s")
    launches = bsw_cuda.LAUNCHES
    if launches <= 0:
        raise SystemExit("the DP kernel was not launched on the main path")
    bwt_hit = 100.0 * (stats.bwt_queries - stats.bwt_calls) / \
        max(stats.bwt_queries, 1)
    sal_merged = 100.0 * (stats.sal_queries - stats.sal_calls) / \
        max(stats.sal_queries, 1)
    prof = {k: round(v * 1e3, 1) for k, v in tail.prof.items()}
    prof.update({k: round(v * 1e3, 1) for k, v in engine.prof.items()})
    main_rec = dict(
        reads_per_s=statistics.median(rates), runs=rates,
        bwt_hit_pct=bwt_hit, sal_merged_pct=sal_merged,
        bwt_rounds=stats.rounds, seed_run_flat_s_last_chunk=seed_s,
        tail_profile_ms=prof, launches=launches, card=smi)
    log("[4] main path: " + json.dumps(main_rec))

    # 1,024 reads through the port and the host oracle path
    n_or = ORACLE_READS
    port_reads = mk_reads(reads_arr[:n_or], 0)
    ref_reads = mk_reads(reads_arr[:n_or], 0)
    t0 = time.time()
    align_chunk(opt, fm, port_reads, 0, engine=engine, seeder=seeder,
                tail=tail)
    align_chunk(opt, fm, ref_reads, 0, engine=None, seeder=None,
                tail=NativeTail(opt, fm))
    bad = [i for i, (a, b) in enumerate(zip(port_reads, ref_reads))
           if a.sam != b.sam]
    log(f"[4] {n_or} reads vs host oracle: {len(bad)} differ "
        f"({time.time() - t0:.1f} s)")
    if bad:
        raise SystemExit(f"SAM differs from the host oracle: reads {bad[:5]}")

    # the main path's own DP tiles, kernel vs plain version
    kern_ms = plain_ms = None
    for tiles in captured:
        err, k_ms, p_ms = compare(tiles, gap)
        errs.append(err)
        P, Q = tiles[1].shape
        log(f"[4] captured tiles P={P} Q={Q} T={tiles[3].shape[1]}: "
            f"max_abs_err {err}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if err:
            raise SystemExit("kernel disagrees with plain version on the "
                             "main path's tiles")
        if kern_ms is None:
            kern_ms, plain_ms = k_ms, p_ms
    if kern_ms is None:
        raise SystemExit("no DP tiles were captured from the main path")

    print(json.dumps({"build_s": build_s, "synthetic_ms": {
        str(T): v for T, v in synth.items()}, "main": main_rec}))
    print(json.dumps({"kernels": [{
        "name": "bsw_extend_kernel", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max(errs),
        "ms": kern_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
