"""compseed_tpu_torch's slice end to end, on its own host layers: the
port's align_stream with its seeder, DP engine and native tail gives SAM
byte-equal to the goldens and to compseed_tpu's device path (with equal
seeding counters) — also with a golden's reads fed as ONE chunk, which
overflows the seeder's caps and takes the exact rerun; the package and
chip_smoke.py import nothing of JAX or of compseed_tpu; chip_smoke.py
refuses to run without a CUDA card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import compseed_tpu.native as jax_native
import compseed_tpu.pipeline.align as jax_align
from compseed_tpu.options import MemOptions as JaxOptions
from compseed_tpu.pipeline.seeding import SeedingStats as JaxStats
from compseed_tpu_torch import convert
from compseed_tpu_torch.io.fastq import (read_fastq_chunks,
                                         read_reordered_chunks)
from compseed_tpu_torch.native import NativeTail
from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.engine import device_engine, device_seeder
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.pipeline.align import align_stream
from compseed_tpu_torch.pipeline.seeding import SeedingStats

from tests.conftest import FIXTURES

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(FIXTURES))
# 100-read chunks stay inside the seeder's caps on this sa_intv=32
# fixture index; larger ones overflow and take the exact rerun
CHUNK = 100
N_ONE = 256           # one full R=256 chunk


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


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


def _stream(opt, fm, reads, seeder, engine, chunk=CHUNK, jax_side=False):
    """align_stream over chunk-read chunks -> (SAM lines, SeedingStats),
    through the port's own pipeline and native tail, or the JAX
    package's."""
    chunks = [reads[s:s + chunk] for s in range(0, len(reads), chunk)]
    done = []
    if jax_side:
        stats, tail = JaxStats(), jax_native.NativeTail(opt, fm)
        run = jax_align.align_stream
    else:
        stats, tail, run = SeedingStats(), NativeTail(opt, fm), align_stream
    n = run(opt, fm, iter(chunks), engine, seeder, tail,
            on_done=done.extend, stats=stats)
    assert n == len(reads) == len(done)
    assert [r.name for r in done] == [r.name for r in reads]
    return "".join(r.sam for r in done).splitlines(keepends=True), stats


def _port(opt, fm):
    seeder = device_seeder(opt, fm, dedup=True, device=CPU)
    return seeder, device_engine(opt, fm, dfi=seeder.dfi, device=CPU)


def test_align_stream_golden_subset(port_fm):
    """First 300 reads of reads.fq through the port's main path: SAM
    byte-equal to golden_bwamem.sam; the DP went through the fused
    dual-round metadata path, on its plain version (CPU tensors)."""
    opt = MemOptions()
    seeder, engine = _port(opt, port_fm)
    n0 = dict(bsw_cuda.LAUNCHES)
    mine, stats = _stream(opt, port_fm, _reads("reads.fq", 300), seeder,
                          engine)
    want = _golden("golden_bwamem.sam", 300)
    assert len(mine) == len(want)
    for i, (m, g) in enumerate(zip(mine, want)):
        assert m == g, f"record {i} differs:\nMINE: {m}\nGOLD: {g}"
    assert engine.prof.get("engine_fetch"), "dual path was not exercised"
    assert bsw_cuda.LAUNCHES == n0                   # no kernel on the CPU
    assert stats.bwt_calls < stats.bwt_queries        # compressive reuse


def test_host_seeded_batch_drops_a_stale_query_context(port_fm):
    """An engine that has served a device-seeded chunk keeps that chunk's
    read matrix; a batch seeded on the host afterwards (no device seeder)
    must not be sliced from it: align_chunk clears the context and the
    SAM equals the host DP's."""
    from compseed_tpu_torch.pipeline.align import align_chunk
    opt = MemOptions()
    seeder, engine = _port(opt, port_fm)
    _stream(opt, port_fm, _reads("reads.fq", 64), seeder, engine)
    assert engine.supports_meta_dual                  # context left behind
    want = _reads("reads.fq", 96)[64:]
    align_chunk(opt, port_fm, want, 64, engine=None, seeder=None,
                tail=NativeTail(opt, port_fm))
    got = _reads("reads.fq", 96)[64:]
    align_chunk(opt, port_fm, got, 64, engine=engine, seeder=None,
                tail=NativeTail(opt, port_fm))
    assert not engine.supports_meta_dual
    assert [r.sam for r in got] == [r.sam for r in want]
    assert all(r.sam for r in got)


def _jax_stream(tiny_fm, reads, chunk=CHUNK):
    from compseed_tpu.ops.engine import device_engine as jax_engine
    from compseed_tpu.ops.engine import device_seeder as jax_seeder
    opt = JaxOptions()
    js = jax_seeder(opt, tiny_fm, dedup=True)
    return _stream(opt, tiny_fm, reads, js,
                   jax_engine(opt, tiny_fm, dfi=js.dfi), chunk=chunk,
                   jax_side=True)


def test_align_stream_vs_jax_device_path_reordered(tiny_fm, port_fm):
    """A reordered subset through both packages' device paths: the same
    SAM and the same BWT/SAL counters, per round."""
    opt = MemOptions()
    want, wstats = _jax_stream(tiny_fm, _reads("reads.reordered", 200))
    seeder, engine = _port(opt, port_fm)
    mine, stats = _stream(opt, port_fm, _reads("reads.reordered", 200),
                          seeder, engine)
    assert mine == want
    assert mine == _golden("golden_compseed_reordered.sam", 200)
    for key in ("bwt_queries", "bwt_calls", "sal_queries", "sal_calls",
                "rounds"):
        assert getattr(stats, key) == getattr(wstats, key), key
    assert stats.rounds["n2"] > 0


@pytest.mark.parametrize("name,gold", [
    ("reads.fq", "golden_bwamem.sam"),
    ("reads.reordered", "golden_compseed_reordered.sam")])
def test_align_stream_one_chunk_takes_overflow_path(tiny_fm, port_fm, name,
                                                    gold):
    """A golden's first 256 reads as ONE chunk (a full R=256 bucket: the
    merged-SAL stage caps overflow on this sa_intv=32 index, where a
    300-read chunk, 59 % of R=512, does not): the chunk is rerun exactly
    on the lockstep seeder and the seed and SAL cap factors double; SAM
    is byte-equal to the golden and to the JAX package's device path on
    the same single chunk."""
    opt = MemOptions()
    seeder, engine = _port(opt, port_fm)
    f0 = (seeder.SEED_F, seeder.U_F)
    mine, stats = _stream(opt, port_fm, _reads(name, N_ONE), seeder, engine,
                          chunk=N_ONE)
    assert seeder.last_overflow and seeder._cap_raises == 2
    assert (seeder.SEED_F, seeder.U_F) == (2 * f0[0], 2 * f0[1])
    assert mine == _golden(gold, N_ONE)
    want, wstats = _jax_stream(tiny_fm, _reads(name, N_ONE), chunk=N_ONE)
    assert mine == want
    assert (stats.sal_queries, stats.sal_calls) == \
        (wstats.sal_queries, wstats.sal_calls)


def test_package_imports_no_jax():
    """Importing compseed_tpu_torch, every module under it and
    chip_smoke, in a fresh interpreter, leaves jax, bench, compseed_tpu
    and everything under compseed_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import compseed_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'bench', 'compseed_tpu'))\n"
        "print(len(mods), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 35 and bad.strip() == "[]", r.stdout


def test_sources_name_no_jax_package():
    """No import statement in the port or chip_smoke.py names jax, bench
    or compseed_tpu (lazy imports inside functions included)."""
    import re
    pat = re.compile(r"^\s*(from|import) +(jax|jaxlib|bench|compseed_tpu)\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "compseed_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 40
    for path in files:
        with open(path) as f:
            hits = [ln for ln in f if pat.match(ln)]
        assert not hits, (path, hits)


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
