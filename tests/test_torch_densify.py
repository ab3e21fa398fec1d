"""compseed_tpu_torch's densify_sa, exactly: the resampled suffix array
equals the JAX package's densify_sa on the same index (carried across by
convert.from_jax_index) and the directly built denser sample, word for
word with the -1 sentinel at [0], at int32 and forced int64; the port's
seeder over a densified index equals the scalar oracle; bad intervals
raise ValueError with both values (mirrors tests/test_ops_fm.py and
tests/test_seeder2.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from compseed_tpu.cpu import fm_oracle as fo
from compseed_tpu.index.build import build_index
from compseed_tpu.index.fmindex import FMIndex as JaxFMIndex
from compseed_tpu.ops import device_index as jdi
from compseed_tpu.options import MemOptions as JaxOptions
from compseed_tpu.pipeline import seeding
from compseed_tpu.utils import NT4_TO_ASCII
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import device_index as tdi
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
from compseed_tpu_torch.options import MemOptions

from tests.test_ops_smem import _fixture_queries

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _carry(jd):
    arrays = {k: np.asarray(getattr(jd, k)) for k in convert.ARRAY_FIELDS}
    meta = {k: getattr(jd, k) for k in convert.META_FIELDS}
    return convert.from_jax_index(arrays, meta, CPU)


@pytest.fixture(scope="module")
def direct(micro, tmp_path_factory):
    """new_intv -> sa_sampled of the index built at that interval."""
    seq = micro[0]
    path = str(tmp_path_factory.mktemp("densify") / "micro.fa")
    with open(path, "w") as f:
        f.write(">micro\n" + bytes(NT4_TO_ASCII[seq]).decode() + "\n")
    return {i: JaxFMIndex.from_built(build_index(path, sa_intv=i)).sa_sampled
            for i in (8, 4)}


@pytest.mark.parametrize("force", [None, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("new_intv", [8, 4])
def test_densify_sa_vs_jax_and_direct_build(micro, direct, new_intv, force):
    _, _, fm = micro
    assert fm.sa_intv == 32
    jd = jdi.to_device(fm, force_dtype=force)
    td = _carry(jd)
    got = tdi.densify_sa(td, new_intv, chunk=64)      # several chunks
    assert got.sa_intv == new_intv
    assert got.sa_sampled.dtype == td.dtype == (
        torch.int64 if force else torch.int32)
    assert int(got.sa_sampled[0]) == -1
    want_jax = np.asarray(jdi.densify_sa(jd, new_intv, chunk=64).sa_sampled)
    assert got.sa_sampled.numpy().dtype == want_jax.dtype
    assert np.array_equal(got.sa_sampled.numpy(), want_jax)
    want = direct[new_intv].astype(np.int64).astype(jd.idx_dtype)
    assert np.array_equal(got.sa_sampled.numpy(), want)
    # every other field is the input's own
    for f in dataclasses.fields(td):
        if f.name not in ("sa_sampled", "sa_intv"):
            assert getattr(got, f.name) is getattr(td, f.name), f.name
    # one wide chunk gives the same words
    assert torch.equal(tdi.densify_sa(td, new_intv).sa_sampled,
                       got.sa_sampled)
    # and sa_batch stays oracle-exact on the densified index
    ks = torch.arange(0, fm.seq_len + 1, 7)
    sa = tfm.sa_batch(got, ks).numpy()
    for i, k in enumerate(ks.tolist()):
        assert sa[i] == fo.sa_lookup(fm, k), (new_intv, k)


@pytest.mark.parametrize("new_intv", [0, -8, 12, 3, 32, 64])
def test_densify_sa_rejects_bad_intervals(micro, new_intv):
    td = tdi.to_device(convert.fmindex_from_jax_package(micro[2]), CPU)
    with pytest.raises(ValueError) as e:
        tdi.densify_sa(td, new_intv)
    assert str(new_intv) in str(e.value) and "32" in str(e.value)


def test_seeder_over_densified_index_vs_oracle(tiny_fm):
    """The port's full seeder over densify_sa(8) gives the oracle's
    matches and seeds: SAL depth is the only thing that changes."""
    port_fm = convert.fmindex_from_jax_package(tiny_fm)
    opt = MemOptions()
    queries = _fixture_queries(16)
    dfi8 = tdi.densify_sa(tdi.to_device(port_fm, CPU), 8)
    assert dfi8.sa_intv == 8
    sd = DeviceSeeder(opt, port_fm, CPU, dfi=dfi8, dedup=True)
    got = sd(port_fm, opt, queries)
    jopt = JaxOptions()
    want_m = [seeding.collect_matches(tiny_fm, jopt, q) for q in queries]
    want_s = [seeding.sample_seeds(jopt, m) for m in want_m]
    seeding.resolve_sal(tiny_fm, want_s)
    for r in range(len(queries)):
        assert got[r][0] == want_m[r], f"read {r}"
        assert [(s.rbeg, s.qbeg, s.len) for s in got[r][1]] == \
            [(s.rbeg, s.qbeg, s.len) for s in want_s[r]], f"read {r}"
    # run_flat too, against the seeder over the index as loaded
    base = DeviceSeeder(opt, port_fm, CPU, dedup=True)
    for g, w in zip(sd.run_flat(queries), base.run_flat(queries)):
        assert np.array_equal(g, w)
    assert not sd.last_overflow and not base.last_overflow


def test_densified_tiny_index_equals_direct_build(tiny_fm):
    """32 -> 8 on the fixture genome equals the interval-8 build."""
    fa = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.fa")
    want = JaxFMIndex.from_built(build_index(fa, sa_intv=8)).sa_sampled
    port_fm = convert.fmindex_from_jax_package(tiny_fm)
    got = tdi.densify_sa(tdi.to_device(port_fm, CPU), 8, chunk=4096)
    assert np.array_equal(got.sa_sampled.numpy().astype(np.uint64), want)
