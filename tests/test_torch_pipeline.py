"""compseed_tpu_torch's slice end to end: align_stream with the port's
seeder, DP engine and the native tail gives SAM byte-equal to the
bwamem golden and to compseed_tpu's device path (with equal seeding
counters); the package imports no JAX; chip_smoke.py refuses to run
without a CUDA card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from compseed_tpu.io.fastq import read_fastq_chunks, read_reordered_chunks
from compseed_tpu.native import NativeTail
from compseed_tpu.options import MemOptions
from compseed_tpu.pipeline.align import align_stream
from compseed_tpu.pipeline.seeding import SeedingStats
from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.engine import device_engine, device_seeder

from tests.conftest import FIXTURES

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(FIXTURES))
# 100-read chunks: at larger ones this sa_intv=32 fixture index trips
# the seeder's SAL stage caps, whose exact rerun is not ported
CHUNK = 100


def _reads(name, n):
    reader = read_fastq_chunks if name.endswith(".fq") else \
        read_reordered_chunks
    reads = []
    for chunk in reader(os.path.join(FIXTURES, name), 10_000_000):
        reads.extend(chunk)
    return reads[:n]


def _golden(name, n):
    with open(os.path.join(FIXTURES, name)) as f:
        return [line for line in f if not line.startswith("@")][:n]


def _stream(opt, fm, reads, seeder, engine):
    """align_stream over CHUNK-read chunks -> (SAM lines, SeedingStats)."""
    chunks = [reads[s:s + CHUNK] for s in range(0, len(reads), CHUNK)]
    done, stats = [], SeedingStats()
    n = align_stream(opt, fm, iter(chunks), engine, seeder,
                     NativeTail(opt, fm), on_done=done.extend, stats=stats)
    assert n == len(reads) == len(done)
    assert [r.name for r in done] == [r.name for r in reads]
    return "".join(r.sam for r in done).splitlines(keepends=True), stats


def _port(opt, fm):
    seeder = device_seeder(opt, fm, dedup=True, device=CPU)
    return seeder, device_engine(opt, fm, dfi=seeder.dfi, device=CPU)


def test_align_stream_golden_subset(tiny_fm):
    """First 300 reads of reads.fq through the port's main path: SAM
    byte-equal to golden_bwamem.sam; the DP went through the fused
    dual-round metadata path, on its plain version (CPU tensors)."""
    opt = MemOptions()
    seeder, engine = _port(opt, tiny_fm)
    n0 = bsw_cuda.LAUNCHES
    mine, stats = _stream(opt, tiny_fm, _reads("reads.fq", 300), seeder,
                          engine)
    want = _golden("golden_bwamem.sam", 300)
    assert len(mine) == len(want)
    for i, (m, g) in enumerate(zip(mine, want)):
        assert m == g, f"record {i} differs:\nMINE: {m}\nGOLD: {g}"
    assert engine.prof.get("engine_fetch"), "dual path was not exercised"
    assert bsw_cuda.LAUNCHES == n0                   # no kernel on the CPU
    assert stats.bwt_calls < stats.bwt_queries        # compressive reuse


def test_align_stream_vs_jax_device_path_reordered(tiny_fm):
    """A reordered subset through both packages' device paths: the same
    SAM and the same BWT/SAL counters, per round."""
    from compseed_tpu.ops.engine import device_engine as jax_engine
    from compseed_tpu.ops.engine import device_seeder as jax_seeder
    opt = MemOptions()
    js = jax_seeder(opt, tiny_fm, dedup=True)
    want, wstats = _stream(opt, tiny_fm, _reads("reads.reordered", 200), js,
                           jax_engine(opt, tiny_fm, dfi=js.dfi))
    seeder, engine = _port(opt, tiny_fm)
    mine, stats = _stream(opt, tiny_fm, _reads("reads.reordered", 200),
                          seeder, engine)
    assert mine == want
    assert mine == _golden("golden_compseed_reordered.sam", 200)
    for key in ("bwt_queries", "bwt_calls", "sal_queries", "sal_calls",
                "rounds"):
        assert getattr(stats, key) == getattr(wstats, key), key
    assert stats.rounds["n2"] > 0


def test_package_imports_no_jax():
    """Importing compseed_tpu_torch and every module under it, in a fresh
    interpreter, leaves jax (and compseed_tpu.ops, which turns on JAX's
    x64 mode) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import compseed_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'jax' "
        "or k.startswith(('compseed_tpu.ops', 'compseed_tpu.parallel')))\n"
        "print(len(mods), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 9 and bad.strip() == "[]", r.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """chip_smoke.py exits non-zero, quickly and with no result line,
    where torch sees no CUDA card (here), from the repo and from a
    directory that holds nothing else."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "CUDA" in r.stderr
