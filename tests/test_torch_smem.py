"""compseed_tpu_torch's lockstep seeder (ops/smem.py) vs compseed_tpu's,
exactly (everything is integer, tolerance 0): the batched collect and
round-3 programs against the JAX vmapped per-read programs on the same
seeded inputs — overflow flags included, with the caps forced small —
and BatchSeeder against the JAX BatchSeeder and the scalar oracle."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compseed_tpu.io.fastq import read_fastq_chunks
from compseed_tpu.ops import smem as jsmem
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu.options import MemOptions
from compseed_tpu.pipeline import seeding
from compseed_tpu.pipeline.align import encode_read
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import smem as tsmem
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.pipeline.seeding import SeedingStats

from tests.conftest import FIXTURES

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
L = 128
P = 64


def _queries(n):
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


@pytest.fixture(scope="module")
def lanes():
    """Seeded lane inputs: fixture reads with Ns sprinkled in, pivots
    over the whole read (0, on an N, at the last base), min_hits 1..3,
    a few inactive lanes."""
    rng = np.random.default_rng(11)
    qs = _queries(P)
    qarr = np.full((P, L), 4, np.uint8)
    for i, q in enumerate(qs):
        qarr[i, :len(q)] = q
    qarr[rng.random((P, L)) < 0.01] = 4
    piv = rng.integers(0, 101, P).astype(np.int32)
    piv[:8] = 0
    piv[8] = 100
    qarr[9, piv[9]] = 4
    mh = rng.integers(1, 4, P).astype(np.int32)
    act = np.ones(P, bool)
    act[-3:] = False
    return qarr, piv, mh, act


def _jax_collect(dfi, qarr, piv, mh, act):
    f = jax.jit(jax.vmap(lambda fm_, q, p, h, a: jsmem._collect_one(
        fm_, L, q, p, h, a), in_axes=(None, 0, 0, 0, 0)))
    return np.asarray(f(dfi, jnp.asarray(qarr), jnp.asarray(piv),
                        jnp.asarray(mh), jnp.asarray(act)))


def _jax_round3(dfi, qarr, act, min_len, max_intv):
    f = jax.jit(jax.vmap(lambda fm_, q, a: jsmem._seed_strategy_one(
        fm_, L, min_len, max_intv, q, a), in_axes=(None, 0, 0)))
    return np.asarray(f(dfi, jnp.asarray(qarr), jnp.asarray(act)))


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("idx", [np.int32, np.int64], ids=["i32", "i64"])
def test_collect_one_vs_jax(tiny_fm, port_fm, lanes, idx):
    qarr, piv, mh, act = lanes
    want = _jax_collect(jax_to_device(tiny_fm, force_dtype=idx), *lanes)
    got = tsmem._collect_one(to_device(port_fm, CPU, force_dtype=idx), L,
                             _t(qarr), _t(piv), _t(mh), _t(act)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got[:, tsmem.MMEM * 5] > 1).any()         # several SMEMs a lane
    assert not got[:, tsmem.MMEM * 5 + 2].any()       # no overflow here


def test_collect_one_overflow_flags_vs_jax(tiny_fm, port_fm, lanes,
                                           monkeypatch):
    """MLEP and MMEM forced small in both packages: the same lanes flag
    an overflow and every packed word is still equal."""
    qarr, piv, mh, act = lanes
    for name, val in (("MLEP", 2), ("MMEM", 1)):
        monkeypatch.setattr(jsmem, name, val)
        monkeypatch.setattr(tsmem, name, val)
        want = _jax_collect(jax_to_device(tiny_fm), *lanes)
        got = tsmem._collect_one(to_device(port_fm, CPU), L, _t(qarr),
                                 _t(piv), _t(mh), _t(act)).numpy()
        assert np.array_equal(got, want), name
        assert got[:, -1].any(), name                  # overflow really hit
        monkeypatch.undo()


@pytest.mark.parametrize("mmem3", [32, 1])
def test_seed_strategy_one_vs_jax(tiny_fm, port_fm, lanes, monkeypatch,
                                  mmem3):
    """Round 3 (with max_intv raised so that hits occur), also with the
    per-read cap forced to 1 so the overflow flag is set."""
    qarr, _, _, act = lanes
    monkeypatch.setattr(jsmem, "MMEM3", mmem3)
    monkeypatch.setattr(tsmem, "MMEM3", mmem3)
    want = _jax_round3(jax_to_device(tiny_fm), qarr, act, 19, 200)
    got = tsmem._seed_strategy_one(to_device(port_fm, CPU), L, 19, 200,
                                   _t(qarr), _t(act)).numpy()
    assert np.array_equal(got, want)
    assert got[:, mmem3 * 5].any()                     # hits occurred
    assert bool(got[:, -1].any()) == (mmem3 == 1)


@pytest.fixture(scope="module")
def seeders(tiny_fm, port_fm):
    opt = MemOptions()
    return (jsmem.BatchSeeder(opt, tiny_fm),
            tsmem.BatchSeeder(opt, port_fm, CPU))


def test_batch_seeder_run_flat_vs_jax(seeders):
    js, ts = seeders
    queries = _queries(80)
    wstats, stats = seeding.SeedingStats(), SeedingStats()
    want = js.run_flat(queries, wstats)
    got = ts.run_flat(queries, stats)
    for g, w, nm in zip(got, want, ("lrep", "sflat", "soff")):
        assert g.dtype == w.dtype and np.array_equal(g, w), nm
    assert (stats.sal_queries, stats.sal_calls) == \
        (wstats.sal_queries, wstats.sal_calls)
    assert stats.sal_calls < stats.sal_queries


def test_batch_seeder_call_vs_jax_and_oracle(seeders, tiny_fm):
    """Per-read interface on reads with Ns, an all-N read and short
    reads: equal to the JAX BatchSeeder and to the scalar oracle."""
    js, ts = seeders
    opt = MemOptions()
    rng = np.random.default_rng(41)
    base = _queries(24)
    queries = []
    for q in base:
        q = q.copy()
        for _ in range(2):
            q[int(rng.integers(0, len(q)))] = 4
        queries.append(q)
    queries.append(np.full(50, 4, dtype=np.uint8))
    queries.append(base[0][:37].copy())
    queries.append(base[1][:19].copy())
    want = js(tiny_fm, opt, queries)
    got = ts(ts.fm, opt, queries)
    want_seeds = []
    for r, q in enumerate(queries):
        m = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == want[r][0] == m, r
        want_seeds.append(seeding.sample_seeds(opt, m))
    seeding.resolve_sal(tiny_fm, want_seeds)
    for r in range(len(queries)):
        g = [(s.rbeg, s.qbeg, s.len, s.score) for s in got[r][1]]
        assert g == [(s.rbeg, s.qbeg, s.len, s.score) for s in want[r][1]]
        assert g == [(s.rbeg, s.qbeg, s.len, s.score)
                     for s in want_seeds[r]], r


def test_batch_seeder_per_read_fallbacks(port_fm, tiny_fm, monkeypatch):
    """With the per-read caps forced small every round falls back to the
    scalar oracle for the overflowing reads: still oracle-exact."""
    for name, val in (("MLEP", 2), ("MMEM", 1)):
        monkeypatch.setattr(tsmem, name, val)
    opt = MemOptions()
    queries = _queries(16)
    got = tsmem.BatchSeeder(opt, port_fm, CPU)(port_fm, opt, queries)
    for r, q in enumerate(queries):
        assert got[r][0] == seeding.collect_matches(tiny_fm, opt, q), r


def test_batch_seeder_int64_and_blocks(port_fm, seeders, monkeypatch):
    """The int64 index path, and a chunk split over several SEED_BLOCKs,
    give the int32 single-block result."""
    _, ts = seeders
    queries = _queries(48)
    want = ts.run_flat(queries)
    opt = MemOptions()
    dfi64 = to_device(port_fm, CPU, force_dtype=np.int64)
    s64 = tsmem.BatchSeeder(opt, port_fm, CPU, dfi=dfi64)
    monkeypatch.setattr(tsmem.BatchSeeder, "SEED_BLOCK", 20)
    got = s64.run_flat(queries)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
