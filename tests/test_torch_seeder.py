"""compseed_tpu_torch's DeviceSeeder(dedup=True) vs compseed_tpu's, exactly:
every stage output (chain_scan in its LEP, round-2-task and r3 modes,
walk_pool_chain, reconstruct, merge, seeds), the packed head — and with
it every BWT/SAL counter — and the seed matrix; plus the scalar oracle
(mirrors tests/test_seeder2.py)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.io.fastq import read_fastq_chunks, read_reordered_chunks
from compseed_tpu.options import MemOptions
from compseed_tpu.pipeline import seeding
from compseed_tpu.pipeline.align import encode_read
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.engine import device_seeder
from compseed_tpu_torch.ops.seeder2 import DeviceSeeder, SeederCapOverflow

from tests.conftest import FIXTURES

CPU = torch.device("cpu")
N_READS = 96          # one R=256 chunk (larger fills trip the SAL caps)


def _queries(name, n):
    reader = read_fastq_chunks if name.endswith(".fq") else \
        read_reordered_chunks
    reads = []
    for chunk in reader(os.path.join(FIXTURES, name), 10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_tree_equal(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (where, g.shape, w.shape)
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), where


@pytest.fixture(scope="module")
def stages(tiny_fm):
    """Stage outputs of both packages on both fixture inputs, at one
    (R, L) so the JAX programs compile once."""
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    opt = MemOptions()
    js = JaxSeeder(opt, tiny_fm, dedup=True)
    ts = DeviceSeeder(opt, tiny_fm, CPU, dedup=True)
    out = {}
    for name in ("reads.fq", "reads.reordered"):
        queries = _queries(name, N_READS)
        R, L, qd, rd = ts._upload(queries)
        jq, jr = jnp.asarray(qd.numpy()), jnp.asarray(rd.numpy())
        jf, tf = js._build(R, L), ts._build(R, L)
        j1 = jf["r1"](js.dfi, jq, jr)
        t1 = tf["r1"](qd, rd)
        j2 = jf["r2"](js.dfi, jq, jr, *(j1[i] for i in (1, 2, 3, 5, 6, 7)),
                      j1[16])
        t2 = tf["r2"](qd, rd, *(t1[i] for i in (1, 2, 3, 5, 6, 7)), t1[16])
        j3 = jf["r3"](js.dfi, jq, jr, j2[15])
        t3 = tf["r3"](qd, rd, t2[15])
        jh, jp = jf["whole"](js.dfi, jq, jr)
        _, _, th, tp = ts._run(tf, qd, rd)
        out[name] = dict(queries=queries, R=R, L=L, qd=qd, rd=rd,
                         jax=(j1, j2, j3, np.asarray(jh), np.asarray(jp)),
                         port=(t1, t2, t3, th.numpy(), tp.numpy()))
    return out


INPUTS = ["reads.fq", "reads.reordered"]
R1_NAMES = ("pool", "ok", "rid", "k", "l", "s", "beg", "end", "flags", "bad",
            "n_pool", "n_u", "fq1", "fc1", "bq1", "bc1", "memo")
R2_NAMES = ("ok", "rid", "k", "l", "s", "beg", "end", "flags", "bad", "fq2",
            "fc2", "n2", "n_u2", "bq2", "bc2", "memo")
R3_NAMES = ("ok", "rid", "k", "l", "s", "beg", "end", "bad", "ovf", "fq3",
            "fc3")


@pytest.mark.parametrize("name", INPUTS)
def test_head_and_seedpk_equal_jax(stages, name):
    """The packed head (every per-round BWT counter, SAL counts, l_rep,
    per-read seed counts) and the seed matrix, bit for bit."""
    st = stages[name]
    jh, jp = st["jax"][3], st["jax"][4]
    th, tp = st["port"][3], st["port"][4]
    assert th.dtype == np.int32 and tp.dtype == np.int32
    assert np.array_equal(th, jh)
    assert np.array_equal(tp, jp)
    assert not th[3:14].any()                 # no cap overflow
    assert th[22] > th[23] and th[18] >= th[19]   # real forward reuse


@pytest.mark.parametrize("name", INPUTS)
def test_round1_chain_scan_lep_and_walk_pool_chain(stages, name):
    """Round 1: chain_scan (LEP mode) pool + memo, walk_pool_chain deaths
    and counters, reconstruct."""
    j1, t1 = stages[name]["jax"][0], stages[name]["port"][0]
    for nm, g, w in zip(R1_NAMES, t1, j1):
        _assert_tree_equal(g, w, nm)


@pytest.mark.parametrize("name", INPUTS)
def test_round2_chain_scan_tasks(stages, name):
    """Round 2: task extraction, chain_scan with min_hits/pivots0/rids/
    active, walk_pool_chain with per-row min_hits."""
    j2, t2 = stages[name]["jax"][1], stages[name]["port"][1]
    for nm, g, w in zip(R2_NAMES, t2, j2):
        _assert_tree_equal(g, w, nm)
    assert int(_np(t2[11])) > 0               # tasks really ran


@pytest.mark.parametrize("name", INPUTS)
def test_round3_chain_scan_r3(stages, name):
    j3, t3 = stages[name]["jax"][2], stages[name]["port"][2]
    for nm, g, w in zip(R3_NAMES, t3, j3):
        _assert_tree_equal(g, w, nm)


def test_chain_scan_lossy_memo_and_rep_cap_vs_jax(tiny_fm):
    """chain_scan called directly with a tiny memo (slot evictions, a
    full store) and a small rep cap (groups deferred to later rounds):
    pool, counters and memo equal JAX's."""
    from compseed_tpu.ops import seedscan as jss
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    queries = _queries("reads.fq", 32)
    queries += [queries[2].copy(), queries[3][7:80].copy()]
    R, L = len(queries), 128
    qarr = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rl[i] = len(q)
    qarr[0, 10:12] = 4
    GP = 48 * R
    jd = jax_to_device(tiny_fm)
    td = to_device(tiny_fm, CPU)
    jmemo = jss.make_chain_memo(32, 16, 5, jd.dtype)
    tmemo = tss.make_chain_memo(32, 16, 5, td.dtype, CPU)
    want = jss.chain_scan(jd, jnp.asarray(qarr), jnp.asarray(rl), GP, jmemo,
                          W=5, u_cap=8)
    got = tss.chain_scan(td, torch.from_numpy(qarr), torch.from_numpy(rl),
                         GP, tmemo, W=5, u_cap=8)
    for nm, g, w in zip(("pool", "n", "ovf", "fq", "fc", "memo"), got, want):
        _assert_tree_equal(g, w, nm)
    assert int(_np(got[5]["cur"])) == 16          # the store filled up


def test_walk_pool_chain_narrow_caps_vs_jax(stages, tiny_fm):
    """walk_pool_chain on round 1's pool with a narrow lane cap (segment
    compaction, deferred groups) and random min_hits, vs JAX's."""
    from compseed_tpu.ops import seedscan as jss
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    st = stages["reads.reordered"]
    pool = _np(st["port"][0][0])
    n_valid = int((pool[:, 6] != 0).sum())
    CAPW = 1 << (n_valid - 1).bit_length()
    mh = np.random.default_rng(3).integers(1, 4, pool.shape[0])
    rw = tss.packed_rev_windows(st["qd"])
    got = tss.walk_pool_chain(to_device(tiny_fm, CPU), rw, st["L"],
                              torch.from_numpy(pool), CAPW,
                              mh=torch.from_numpy(mh))
    want = jss.walk_pool_chain(
        jax_to_device(tiny_fm),
        jss.packed_rev_windows(jnp.asarray(st["qd"].numpy())), st["L"],
        jnp.asarray(pool), CAPW, mh=jnp.asarray(mh))
    for nm, g, w in zip(("death", "fk", "fl", "fs", "ovf", "calls", "ngrp"),
                        got, want):
        _assert_tree_equal(g, w, nm)
    assert not bool(got[4])


def test_packed_windows_and_next_nonamb_vs_jax():
    from compseed_tpu.ops import seedscan as jss
    rng = np.random.default_rng(4)
    qarr = rng.integers(0, 5, (8, 64)).astype(np.uint8)
    qarr[2, :20] = 4
    t, j = torch.from_numpy(qarr), jnp.asarray(qarr)
    for W in (5, 8, 10):
        _assert_tree_equal(tss.packed_windows(t, W), jss.packed_windows(j, W),
                           f"win{W}")
    _assert_tree_equal(tss.packed_rev_windows(t), jss.packed_rev_windows(j),
                       "rev")
    _assert_tree_equal(tss.next_nonamb(t), jss.next_nonamb(j), "nxt")


def test_int64_index_path(stages, tiny_fm):
    """The int64 device index (hg19-scale genomes) through the whole
    seeder: the same head and seed matrix as at int32 (which the JAX
    int32 path is held to above), and oracle-exact matches."""
    opt = MemOptions()
    st = stages["reads.fq"]
    dfi64 = to_device(tiny_fm, CPU, force_dtype=np.int64)
    assert dfi64.dtype == torch.int64
    sd = DeviceSeeder(opt, tiny_fm, CPU, dfi=dfi64, dedup=True)
    fns = sd._build(st["R"], st["L"])
    _, _, th, tp = sd._run(fns, st["qd"], st["rd"])
    assert np.array_equal(th.numpy(), st["jax"][3])
    assert np.array_equal(tp.numpy(), st["jax"][4])
    queries = st["queries"][:24]
    got = sd(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        assert got[r][0] == seeding.collect_matches(tiny_fm, opt, q), r


def test_seeder_matches_oracle_sorted_batch(tiny_fm):
    """Reordered-style (sorted) batch: matches and resolved seeds per read
    equal the scalar oracle; run_flat's counters show reuse."""
    from compseed_tpu.pipeline.seeding import SeedingStats
    opt = MemOptions()
    queries = sorted(_queries("reads.fq", 64), key=lambda q: q.tobytes())
    sd = device_seeder(opt, tiny_fm, dedup=True, device=CPU)
    got = sd(tiny_fm, opt, queries)
    want_seeds = []
    for r, q in enumerate(queries):
        m = seeding.collect_matches(tiny_fm, opt, q)
        assert got[r][0] == m, r
        want_seeds.append(seeding.sample_seeds(opt, m))
    seeding.resolve_sal(tiny_fm, want_seeds)
    for r in range(len(queries)):
        assert [(s.rbeg, s.qbeg, s.len) for s in got[r][1]] == \
            [(s.rbeg, s.qbeg, s.len) for s in want_seeds[r]], r
    stats = SeedingStats()
    lrep, sflat, soff = sd.run_flat(queries, stats)
    assert len(soff) == len(queries) + 1 and sflat.shape[1] == 3
    assert stats.bwt_calls < stats.bwt_queries
    assert sd.last_qd is not None and sd.last_L == 128


def test_seeder_edge_cases_vs_oracle(tiny_fm):
    """Ns, all-N, short reads, N at both ends."""
    opt = MemOptions()
    rng = np.random.default_rng(41)
    base = _queries("reads.fq", 6)
    queries = []
    for q in base:
        q = q.copy()
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = 4
        queries.append(q)
    queries.append(np.full(50, 4, dtype=np.uint8))
    queries.append(base[0][:37].copy())
    queries.append(base[1][:19].copy())
    queries.append(base[2][:5].copy())
    qq = base[3].copy()
    qq[0] = qq[-1] = 4
    queries.append(qq)
    got = DeviceSeeder(opt, tiny_fm, CPU)(tiny_fm, opt, queries)
    for r, q in enumerate(queries):
        assert got[r][0] == seeding.collect_matches(tiny_fm, opt, q), r


@pytest.mark.parametrize("knob", ["COMPSEED_FWD_MEMO=0", "COMPSEED_BWD_CHAIN=0",
                                  "COMPSEED_R2_DEDUP=0", "COMPSEED_SEEDER=v1",
                                  "dedup=False"])
def test_unported_engines_raise(tiny_fm, monkeypatch, knob):
    """Knobs that select an engine outside the ported path raise and name
    the ROADMAP item; nothing silently runs the default path instead."""
    kw = {"dedup": True}
    if knob == "dedup=False":
        kw["dedup"] = False
    else:
        monkeypatch.setenv(*knob.split("="))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        device_seeder(MemOptions(), tiny_fm, device=CPU, **kw)


def test_cap_overflow_raises(tiny_fm):
    """A chunk-global cap overflow raises (the JAX package's exact rerun
    on the lockstep seeder is not ported) instead of returning results."""
    sd = DeviceSeeder(MemOptions(), tiny_fm, CPU)
    sd.SEED_F = 1
    with pytest.raises(SeederCapOverflow, match="ROADMAP"):
        sd.run_flat(_queries("reads.fq", 200))
    assert sd.last_overflow and sd.last_qd is None
