"""The port's own host layers: each copied module equals the JAX
package's file once the package name is mapped back (apart from an
allow-list, written out here with a reason per entry); the port's index
build writes the fixture index byte for byte; the port's benchmark
input equals bench.py's byte for byte at a reduced size; and the port's
native tail is its own build of the shared C++ sources."""

import os
import re

import numpy as np
import pytest

import bench
from compseed_tpu_torch import bench_input, convert
from compseed_tpu_torch import native as port_native
from compseed_tpu_torch.index import build_index
from compseed_tpu_torch.index.fmindex import FMIndex, unpack_pac_range
from compseed_tpu_torch.index.io import save_index
from compseed_tpu_torch.options import MemOptions

from tests.conftest import FIXTURES

ROOT = os.path.dirname(os.path.dirname(FIXTURES))

COPIED = [
    "utils.py", "options.py",
    "index/__init__.py", "index/suffix.py", "index/build.py",
    "index/fmindex.py", "index/io.py", "index/shm.py",
    "io/__init__.py", "io/kopen.py", "io/fastq.py", "io/reorder.py",
    "io/sam.py",
    "cpu/__init__.py", "cpu/fm_oracle.py", "cpu/ksw.py", "cpu/sort.py",
    "pipeline/__init__.py", "pipeline/types.py", "pipeline/seeding.py",
    "pipeline/chain.py", "pipeline/cigar.py", "pipeline/extension.py",
    "pipeline/finalize.py", "pipeline/align.py",
    "native/__init__.py",
]

# file -> [(text in the JAX package's file, text in the port's, reason)]
ALLOWED = {
    "index/shm.py": [
        ("TPU-host equivalent:", "Accelerator-host equivalent:",
         "the port's device is a GPU")],
    "index/build.py": [
        ("from compseed_tpu.index.suffix import suffix_array\n", "",
         "the numpy build is no longer a fallback here"),
        ("    # native SA-IS when available (linear time, 64-bit \u2014 "
         "whole-genome\n"
         "    # scale); the numpy prefix-doubling build" "er is the "
         "pure-python\n"
         "    # fallback and the differential oracle\n"
         "    try:\n"
         "        from compseed_tpu.native import suffix_array_native\n"
         "        sa_full = suffix_array_native(both)\n"
         "    except Exception:\n"
         "        sa_full = suffix_array(both)\n",
         "    # native SA-IS (linear time, 64-bit \u2014 whole-genome scale); "
         "a failed\n"
         "    # g++ build of the native library raises here.  The numpy\n"
         "    # prefix-doubling build (index.suffix) is the differential "
         "oracle\n"
         "    from compseed_tpu.native import suffix_array_native\n"
         "    sa_full = suffix_array_native(both)\n",
         "a failed g++ build of the port's native library is loud, not "
         "swallowed into the numpy build"),
    ],
    "pipeline/align.py": [
        ('"""End-to-end batch alignment driv' 'er.',
         '"""End-to-end batch alignment.', "wording"),
        ("seeding/SAL/extension on TPU (compseed_tpu.ops), host tail.",
         "seeding/SAL/extension on the card (compseed_tpu.ops), host tail.",
         "the port's device is a GPU")],
    "pipeline/extension.py": [
        ("exactly what the TPU DP kernel wants.",
         "exactly what the device DP kernel wants.",
         "the port's device is a GPU")],
    "native/__init__.py": [
        ("The library is built on demand with g++ and cached under build/."
         "  It owns\n",
         "The library is built on demand with g++ from the C++ sources at "
         "the\nrepository root and cached under build/compseed_tpu/.  It "
         "owns\n",
         "docstring names the port's own build directory"),
        ("rounds in the middle run on the TPU through",
         "rounds in the middle run on the card through",
         "the port's device is a GPU"),
        ('_BUILD = os.path.join(_ROOT, "build")\n',
         '_BUILD = os.path.join(_ROOT, "build", "compseed_tpu")\n',
         "the port builds its own library, never the JAX package's"),
        ("        subprocess.run(cmd, check=True, capture_output=True)\n",
         "        r = subprocess.run(cmd, capture_output=True, text=True)\n"
         "        if r.returncode != 0:\n"
         "            raise RuntimeError(f\"g++ failed ({' '.join(cmd)}):\\n\""
         "\n"
         "                               f\"{r.stdout}{r.stderr}\")\n",
         "a failed build shows the compiler's output"),
        ("    # exact bug behind the round-2 TPU SAM corruption, where the "
         "Pallas\n    # engine returned res[:, j] views while the XLA path "
         "returned copies\n",
         "    # bug behind a SAM corruption seen when a DP engine returned\n"
         "    # res[:, j] views instead of copies\n",
         "history of another device"),
    ],
}


def _map_back(text: str) -> str:
    return re.sub(r"compseed_tpu_torch", "compseed_tpu", text)


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_is_a_copy(rel):
    with open(os.path.join(ROOT, "compseed_tpu", rel)) as f:
        want = f.read()
    with open(os.path.join(ROOT, "compseed_tpu_torch", rel)) as f:
        got = _map_back(f.read())
    for old, new, reason in ALLOWED.get(rel, []):
        assert want.count(old) == 1, (rel, old, reason)
        want = want.replace(old, new)
    assert got == want


def test_allow_list_names_copied_files_only():
    assert set(ALLOWED) <= set(COPIED)
    assert all(reason for subs in ALLOWED.values() for _, _, reason in subs)


def test_build_index_writes_fixture_index(tmp_path):
    built = build_index(os.path.join(FIXTURES, "tiny.fa"))
    prefix = str(tmp_path / "idx")
    save_index(prefix, built)
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        with open(prefix + ext, "rb") as f, \
                open(os.path.join(FIXTURES, "tiny" + ext), "rb") as g:
            assert f.read() == g.read(), ext


def test_fmindex_from_jax_package(tiny_fm):
    """convert.fmindex_from_jax_package carries every field across, and
    the result equals the port's own load of the fixture index."""
    got = convert.fmindex_from_jax_package(tiny_fm)
    want = FMIndex.load(os.path.join(FIXTURES, "tiny"))
    assert isinstance(got, FMIndex) and not isinstance(tiny_fm, FMIndex)
    for k in ("primary", "seq_len", "sa_intv", "l_pac"):
        assert getattr(got, k) == getattr(want, k) == getattr(tiny_fm, k), k
    for k in ("L2", "bwt_words", "cp_occ", "sa_sampled", "pac"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert getattr(got, k) is not getattr(tiny_fm, k), k
    assert got.bns == want.bns
    assert type(got.bns) is type(want.bns)


def test_bench_input_equals_bench_py(monkeypatch, tmp_path):
    """The same genome and reads from the same seeds, byte for byte: the
    genome at full length (its repeat features sit at fixed offsets) with
    reduced N_READS, then both at a reduced GENOME_LEN / N_READS patched
    into both modules, where setup() builds and caches an index whose
    reference is that genome."""
    assert (bench_input.GENOME_LEN, bench_input.N_READS,
            bench_input.READ_LEN, bench_input.COVERAGE) == \
        (bench.GENOME_LEN, bench.N_READS, bench.READ_LEN, bench.COVERAGE)
    for mod in (bench, bench_input):
        monkeypatch.setattr(mod, "N_READS", 64)
    g_want = bench._make_genome(np.random.default_rng(2024))
    g_got = bench_input._make_genome(
        np.random.default_rng(bench_input.GENOME_SEED))
    assert g_got.tobytes() == g_want.tobytes() and len(g_got) == 2_000_000
    assert bench_input._simulate_reads(
        np.random.default_rng(bench_input.READS_SEED), g_got).tobytes() == \
        bench._simulate_reads(np.random.default_rng(7), g_want).tobytes()
    for mod in (bench, bench_input):
        monkeypatch.setattr(mod, "GENOME_LEN", 40_000)
        monkeypatch.setattr(mod, "N_READS", 96)
    g_want = bench._make_genome(np.random.default_rng(2024))
    g_got = bench_input._make_genome(
        np.random.default_rng(bench_input.GENOME_SEED))
    assert g_got.tobytes() == g_want.tobytes() and len(g_got) == 40_000
    r_want = bench._simulate_reads(np.random.default_rng(7), g_want)
    r_got = bench_input._simulate_reads(
        np.random.default_rng(bench_input.READS_SEED), g_got)
    assert r_got.shape == (96, 101) and r_got.tobytes() == r_want.tobytes()
    monkeypatch.setattr(bench_input, "CACHE", str(tmp_path / "cache"))
    fm, reads = bench_input.setup()
    assert fm.sa_intv == 8 and fm.l_pac == 40_000
    assert unpack_pac_range(fm.pac, 0, fm.l_pac).tobytes() == g_got.tobytes()
    assert reads.tobytes() == r_got.tobytes()
    fm2, reads2 = bench_input.setup()                 # from the cache
    assert np.array_equal(fm2.sa_sampled, fm.sa_sampled)
    assert reads2.tobytes() == reads.tobytes()


def test_native_library_is_the_ports_own_build():
    import compseed_tpu.native as jax_native
    so = port_native.build_library()
    assert so == os.path.join(ROOT, "build", "compseed_tpu_torch",
                              "libcompseed_host.so")
    assert so != jax_native._SO and os.path.exists(so)
    assert port_native._SRC == jax_native._SRC        # the shared C++ source
    port_native.NativeTail(MemOptions(), FMIndex.load(
        os.path.join(FIXTURES, "tiny")))


def test_native_build_fails_loudly(monkeypatch, tmp_path):
    """A failed g++ build raises, also through build_index: the index
    build does not carry on with the numpy suffix array."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "_SRC", str(bad))
    monkeypatch.setattr(port_native, "_SO", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        port_native.build_library(force=True)
    monkeypatch.setattr(port_native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        build_index(os.path.join(FIXTURES, "tiny.fa"))
