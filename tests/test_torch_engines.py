"""compseed_tpu_torch's seeding engines vs compseed_tpu's, exactly.

Every engine that ``DeviceSeeder._build`` can select (the matrix in
``compseed_tpu_torch.ops.seeder2.ENGINES``): the whole head (overflow
flags and every BWT/walk counter) and the seed matrix on three inputs;
the engines' building blocks function by function (the lockstep LEP scan
and ``build_pool``, the staged backward walks, the whole-walk and the
content-window backward dedup, the staged forward dedup in its round-1,
round-2-task and round-3 forms, the prefix hashes); mirrors of the JAX
package's tests of these engines; the cap-overflow response under
``COMPSEED_ADAPTIVE_CAPS=0``, chunk for chunk; and the JAX constants that
``chip_smoke.py`` holds the card's heads to.

Regenerate those constants (the JAX package on the CPU, about 6 min):
    JAX_PLATFORMS=cpu python -m tests.test_torch_engines --write-heads
"""

import ast
import contextlib
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.io.fastq import read_fastq_chunks, read_reordered_chunks
from compseed_tpu.options import MemOptions as JaxOptions
from compseed_tpu.ops import seedscan as jss
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu.pipeline import seeding
from compseed_tpu.pipeline.align import encode_read
from compseed_tpu.pipeline.chain import l_rep_one
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.engine import device_seeder
from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
from compseed_tpu_torch.options import MemOptions

from tests.conftest import FIXTURES

# one intra-op thread: as fast for these many small operations, and test
# workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS_JSON = os.path.join(ROOT, "compseed_tpu_torch", "engine_heads.json")
HEAD_READS = 16384         # chip_smoke.py phase 6's chunk
ENGINE_INPUTS = ["reads.fq", "reads.reordered", "shifted"]


@contextlib.contextmanager
def engine_env(knobs: dict):
    """Set env knobs for the block, restoring what was there."""
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


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


def _queries(name, n):
    reader = read_fastq_chunks if name.endswith(".fq") else \
        read_reordered_chunks
    reads = []
    for chunk in reader(os.path.join(FIXTURES, name), 10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


def _shifted_queries(tiny_fm):
    """The shifted-coverage batch of tests/test_seeder2.py
    (test_bwd_chain_rounds_bit_exact): 256 reads of 101 bp from one 900 bp
    window, 30 % with a substitution, 5 % with an N, one with a 40-N
    prefix."""
    from compseed_tpu.index.build import unpack_pac
    g = unpack_pac(tiny_fm.pac, tiny_fm.l_pac)
    rng = np.random.default_rng(13)
    base = int(rng.integers(0, len(g) - 4000))
    out = []
    for _ in range(256):
        p = base + int(rng.integers(0, 800))
        r = g[p: p + 101].copy()
        if rng.random() < 0.3:
            r[int(rng.integers(0, 101))] = int(rng.integers(0, 4))
        if rng.random() < 0.05:
            r[int(rng.integers(0, 101))] = 4
        out.append(r.astype(np.uint8))
    out[3][:40] = 4
    return out


def _edge_queries():
    """Fixture reads plus adjacent Ns, a short read, an exact duplicate,
    a shifted overlap, an all-N read and an empty one."""
    q = _queries("reads.reordered", 56)
    a = q[0].copy()
    a[10:12] = 4
    return q + [a, q[1][:23].copy(), q[2].copy(), q[2][7:80].copy(),
                np.full(30, 4, np.uint8), np.zeros(0, np.uint8)]


def _qarr(queries, L=128):
    R = len(queries)
    qarr = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rl[i] = len(q)
    return qarr, rl


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_equal(got, want, where):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (where, g.shape, w.shape)
    if w.dtype == np.uint64:          # the port holds uint64 as int64 bits
        w = w.view(np.int64)
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), where


def _assert_all(got, want, names):
    assert len(got) == len(want) == len(names)
    for nm, g, w in zip(names, got, want):
        _assert_equal(g, w, nm)


def head_record(head: np.ndarray, seedpk: np.ndarray) -> dict:
    """A seeder head's 28 scalars and digests of the whole head and seed
    matrix (int32 words) — the form the constants are stored in."""
    return dict(
        scalars=[int(x) for x in head[:28]],
        head_sha256=hashlib.sha256(
            np.ascontiguousarray(head, np.int32).tobytes()).hexdigest(),
        seedpk_sha256=hashlib.sha256(
            np.ascontiguousarray(seedpk, np.int32).tobytes()).hexdigest())


# ----------------------------------------------------------------------
# engine by engine: head and seed matrix
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_runs(tiny_fm, port_fm):
    """(JAX head, JAX seed matrix, port head, port seed matrix) per engine
    and input, all at R=256, L=128 (one JAX compile per engine)."""
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    inputs = {n: _queries(n, 96) for n in ENGINE_INPUTS[:2]}
    inputs["shifted"] = _shifted_queries(tiny_fm)
    out = {}
    for name, (dedup, env) in ENGINES.items():
        with engine_env(env):
            js = JaxSeeder(JaxOptions(), tiny_fm, dedup=dedup)
            ts = DeviceSeeder(MemOptions(), port_fm, CPU, dedup=dedup)
            for inp, queries in inputs.items():
                R, L, qd, rd = ts._upload(queries)
                jh, jp = js._build(R, L)["whole"](
                    js.dfi, jnp.asarray(qd.numpy()), jnp.asarray(rd.numpy()))
                _, _, th, tp = ts._run(ts._build(R, L), qd, rd)
                out[name, inp] = (np.asarray(jh), np.asarray(jp),
                                  th.numpy(), tp.numpy())
    return out


@pytest.mark.parametrize("inp", ENGINE_INPUTS)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_head_and_seeds_equal_jax(engine_runs, engine, inp):
    jh, jp, th, tp = engine_runs[engine, inp]
    assert th.dtype == np.int32 and tp.dtype == np.int32
    assert np.array_equal(th[:28], jh[:28]), (th[:28].tolist(),
                                              jh[:28].tolist())
    assert np.array_equal(th, jh)
    assert np.array_equal(tp, jp)


def test_engines_differ_where_they_should(engine_runs):
    """The knobs really select other engines: the walk volumes and step
    counters move as each engine's sharing says."""
    h = {e: engine_runs[e, "shifted"][2] for e in ENGINES}
    # n_u == n_pool and bc1 == bq1 for the plain round-1 walk
    for e in ("bwd_off", "all_off"):
        assert h[e][15] == h[e][14] and h[e][19] == h[e][18]
    # whole-walk keying shares only exact duplicates: none here
    assert h["bwd_whole"][19] == h["bwd_whole"][18]
    for e in ("default", "bwd_win", "fwd_off", "r2_off"):
        assert h[e][19] < h[e][18], e                     # bc1 < bq1
    for e in ("fwd_off", "all_off"):
        assert not h[e][22:28].any(), e                   # no fwd counters
    assert h["fwd_staged"][23] < h["fwd_staged"][22]      # fc1 < fq1


@pytest.mark.parametrize("engine", ["all_off", "fwd_staged", "bwd_whole"])
def test_int64_index_path(engine_runs, port_fm, engine):
    """Mirror of test_seeder2_int64_index_path: the int64 device index
    (hg19-scale genomes) gives the head and seed matrix of the int32 JAX
    run, hashes over 64-bit l/s included."""
    dfi64 = to_device(port_fm, CPU, force_dtype=np.int64)
    dedup, env = ENGINES[engine]
    with engine_env(env):
        sd = DeviceSeeder(MemOptions(), port_fm, CPU, dfi=dfi64, dedup=dedup)
        R, L, qd, rd = sd._upload(_queries("reads.fq", 96))
        _, _, th, tp = sd._run(sd._build(R, L), qd, rd)
    jh, jp = engine_runs[engine, "reads.fq"][:2]
    assert np.array_equal(th.numpy(), jh)
    assert np.array_equal(tp.numpy(), jp)


# ----------------------------------------------------------------------
# function by function
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def idx(tiny_fm, port_fm):
    return jax_to_device(tiny_fm), to_device(port_fm, CPU)


@pytest.fixture(scope="module")
def edge():
    qarr, rl = _qarr(_edge_queries())
    return qarr, rl, torch.from_numpy(qarr), torch.from_numpy(rl)


def _scan_args(case, rl):
    R = len(rl)
    rng = np.random.default_rng(5)
    if case == "task":
        piv = (rng.random(R) * np.maximum(rl, 1)).astype(np.int32)
        mh = rng.integers(1, 5, R).astype(np.int32)
        act = (rng.random(R) < 0.8) & (rl > 0)
        return piv, mh, act
    return np.zeros(R, np.int32), np.ones(R, np.int32), rl > 0


SCAN_CASES = {"r1": (tss.CAPL, True), "r1_capl6": (6, True),
              "task": (tss.CAPL2, False)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_make_scan_and_build_pool_vs_jax(idx, edge, case):
    """The lockstep LEP scan (LEP buffers, counts, per-read overflow;
    ``r1_capl6`` overflows most reads) and build_pool at a roomy and at an
    overflowing pool cap."""
    capl, advance = SCAN_CASES[case]
    jd, td = idx
    qarr, rl, tq, trl = edge
    piv, mh, act = _scan_args(case, rl)
    L = qarr.shape[1]
    want = jss.make_scan(jd, L, capl, advance)(
        jnp.asarray(qarr), jnp.asarray(rl), jnp.asarray(piv),
        jnp.asarray(mh), jnp.asarray(act))
    got = tss.make_scan(td, L, capl, advance)(
        tq, trl, torch.from_numpy(piv), torch.from_numpy(mh),
        torch.from_numpy(act))
    _assert_all(got, want, ("lep", "cnt", "ovf"))
    assert _np(got[2]).any() == (case == "r1_capl6")
    R = len(rl)
    for GP in (48 * R, 4 * R):
        _assert_all(tss.build_pool(got[0], got[1], GP),
                    jss.build_pool(want[0], want[1], GP),
                    (f"pool{GP}", f"n{GP}", f"ovf{GP}"))
    assert bool(tss.build_pool(got[0], got[1], 4 * R)[2])


@pytest.fixture(scope="module")
def r1_pool(idx, edge):
    """Round 1's LEP pool of the edge batch (JAX's make_scan + build_pool)."""
    jd, _ = idx
    qarr, rl = edge[:2]
    R, L = qarr.shape
    lep, cnt, _ = jss.make_scan(jd, L, jss.CAPL, True)(
        jnp.asarray(qarr), jnp.asarray(rl), jnp.zeros(R, jnp.int32),
        jnp.ones(R, jnp.int32), jnp.asarray(rl) > 0)
    return np.array(jss.build_pool(lep, cnt, 48 * R)[0])


def _stages(kind, GP, L):
    MAXW = L + 2
    if kind == "stages1":
        return [(GP, 8), (GP // 2, 16), (GP // 8, 48), (GP // 16, MAXW)]
    if kind == "stages2":
        return [(GP, 8), (GP // 2, 24), (GP // 8, MAXW)]
    return [(GP, 8), (GP // 2, 16), (GP // 4, 32), (GP // 8, 72),
            (GP // 16, MAXW)]


@pytest.mark.parametrize("kind,mh,rw", [
    ("stages1", False, True), ("stages_u", True, True),
    ("stages2", True, False)])
def test_walk_pool_vs_jax(idx, edge, r1_pool, kind, mh, rw):
    """The staged backward walks: fit-gated stage exits, the step budget
    carried across stages, the steps counter (calls), with per-row
    min_hits and with the per-step char gather instead of windows."""
    jd, td = idx
    qarr = edge[0]
    L = qarr.shape[1]
    pool = r1_pool
    GP = pool.shape[0]
    mhv = np.random.default_rng(9).integers(1, 4, GP) if mh else None
    stages = _stages(kind, GP, L)
    jq = jnp.asarray(qarr)
    want = jss.walk_pool(jd, jq.reshape(-1), L, jnp.asarray(pool), stages,
                         mh=None if mhv is None else jnp.asarray(mhv),
                         rwflat=jss.packed_rev_windows(jq) if rw else None)
    got = tss.walk_pool(td, edge[2].reshape(-1), L, torch.from_numpy(pool),
                        stages, mh=None if mhv is None else
                        torch.from_numpy(mhv),
                        rwflat=tss.packed_rev_windows(edge[2]) if rw
                        else None)
    _assert_all(got, want, ("death", "fk", "fl", "fs", "ovf", "calls"))
    assert int(got[5]) > 0 and not bool(got[4])


def test_prefix_hashes_and_padded_prefix_state_vs_jax():
    rng = np.random.default_rng(4)
    qarr = rng.integers(0, 5, (9, 70)).astype(np.uint8)
    qarr[2, :20] = 4
    t, j = torch.from_numpy(qarr), jnp.asarray(qarr)
    _assert_equal(tss.prefix_hashes(t), jss.prefix_hashes(j), "ph")
    for pad in (8, 72):
        for g, w, nm in zip(tss.padded_prefix_state(t, pad),
                            jss.padded_prefix_state(j, pad), ("A1", "A2")):
            _assert_equal(g, w, f"{nm} pad {pad}")


@pytest.mark.parametrize("mh,cap", [(False, 0), (True, 0), (True, 64)])
def test_dedup_pool_vs_jax(edge, r1_pool, mh, cap):
    """Whole-walk keying: representatives, row -> group map, count and
    overflow (``cap`` 64 overflows)."""
    qarr = edge[0]
    pool = r1_pool
    cap = cap or pool.shape[0] // 2
    mhv = np.random.default_rng(2).integers(1, 3, pool.shape[0]) \
        .astype(np.int32) if mh else None
    want = jss.dedup_pool(jnp.asarray(pool),
                          jss.prefix_hashes(jnp.asarray(qarr)), cap,
                          mh=None if mhv is None else jnp.asarray(mhv))
    got = tss.dedup_pool(torch.from_numpy(pool),
                         tss.prefix_hashes(edge[2]), cap,
                         mh=None if mhv is None else torch.from_numpy(mhv))
    _assert_all(got, want, ("rep_pool", "group", "n_u", "ovf", "rep_take"))
    assert bool(got[3]) == (cap == 64)


@pytest.mark.parametrize("Wb,mh,capdiv", [(8, False, 2), (5, True, 2),
                                          (8, True, 64)])
def test_walk_pool_dedup_vs_jax(idx, edge, r1_pool, Wb, mh, capdiv):
    """The content-window backward dedup: probe, adoption, survivors
    through dedup_pool + walk_pool (``capdiv`` 64 overflows its caps)."""
    jd, td = idx
    qarr = edge[0]
    L = qarr.shape[1]
    pool = r1_pool
    GP = pool.shape[0]
    stages = _stages("stages_u", GP // capdiv, L)
    mhv = np.random.default_rng(8).integers(1, 3, GP).astype(np.int32) \
        if mh else None
    jq = jnp.asarray(qarr)
    want = jss.walk_pool_dedup(
        jd, jq.reshape(-1), jss.prefix_hashes(jq), L, jnp.asarray(pool),
        stages, Wb=Wb, mh=None if mhv is None else jnp.asarray(mhv),
        rwflat=jss.packed_rev_windows(jq))
    got = tss.walk_pool_dedup(
        td, edge[2].reshape(-1), tss.prefix_hashes(edge[2]), L,
        torch.from_numpy(pool), stages, Wb=Wb,
        mh=None if mhv is None else torch.from_numpy(mhv),
        rwflat=tss.packed_rev_windows(edge[2]))
    _assert_all(got, want, ("death", "fk", "fl", "fs", "ovf", "calls",
                            "n_groups"))
    assert bool(got[4]) == (capdiv == 64)


def _fwd_kw(case, R, L, rl):
    rng = np.random.default_rng(6)
    if case == "task":
        T = 2 * R
        rids = rng.integers(0, R, T).astype(np.int32)
        piv = (rng.random(T) * np.maximum(rl[rids], 1)).astype(np.int32)
        mh = rng.integers(1, 5, T).astype(np.int32)
        act = rng.random(T) < 0.9
        return [(T, 8), (T, 24), (T, L + 2)], dict(
            min_hits=mh, pivots0=piv, rids=rids, advance=False,
            record_lane_index=True, active=act)
    # rep caps of R: fwd_stages_for's caps overflow on this low-sharing
    # batch (the seeder then reruns the chunk)
    stages = [(R, 8), (R, 8), (R, 16), (R, 32), (R, 64), (R, L + 2),
              (R, L + 2)]
    if case == "r1_small":
        return jss.fwd_stages_for(R, L), {}
    if case == "r3":
        return stages, dict(mode="r3", min_len=19, max_intv=20)
    return stages, {}


@pytest.fixture(scope="module")
def lockstep_twin(tmp_path_factory):
    """compseed_tpu_torch/csrc/lockstep.cu built with g++ into its host
    loops (the forward stage kernel's lane code among them)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    from compseed_tpu_torch.ops import lockstep_cases
    return lockstep_cases.HostTwin(
        str(tmp_path_factory.mktemp("lockstep") / "liblockstep_host.so"))


@pytest.mark.parametrize("case", ["r1", "r1_small", "task", "r3"])
def test_forward_scan_dedup_vs_jax(idx, edge, case, lockstep_twin,
                                   monkeypatch):
    """The staged forward dedup in its round-1 form (and with the
    seeder's rep caps, which overflow here), its round-2 task form and
    its greedy round-3 form:
    the pool, its row count, the overflow flag and fq / fc; on the plain
    route and with every stage on the kernel route, fwd_stage_kernel's
    lane code by its host loop (the twin at lockstep_cuda._launch)."""
    from compseed_tpu_torch.ops import lockstep_cuda
    jd, td = idx
    qarr, rl = edge[:2]
    R, L = qarr.shape
    stages, kw = _fwd_kw(case, R, L, rl)
    GP = 48 * R
    want = jss.forward_scan_dedup(
        jd, jnp.asarray(qarr), jnp.asarray(rl), GP, stages,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = tss.forward_scan_dedup(td, edge[2], edge[3], GP, stages, **tkw)
    _assert_all(got, want, ("pool", "n", "ovf", "fq", "fc"))
    assert bool(got[2]) == (case == "r1_small")
    assert int(got[1]) > 0 and int(got[4]) <= int(got[3])
    monkeypatch.setattr(tss, "_fwd_route",
                        lambda dev: tss._fwd_stage_walk_kernel)
    monkeypatch.setattr(lockstep_cuda, "_launch", lockstep_twin.launch)
    got = tss.forward_scan_dedup(td, edge[2], edge[3], GP, stages, **tkw)
    _assert_all(got, want, ("pool", "n", "ovf", "fq", "fc"))


def test_forward_scan_dedup_matches_lockstep_pool(idx, edge):
    """As test_forward_scan_dedup_exact: the staged forward dedup's pool
    is the lockstep scan's, row for row, with real sharing (fc < fq)."""
    _, td = idx
    R, L = edge[0].shape
    lep, cnt, ovf = tss.make_scan(td, L, tss.CAPL, True)(
        edge[2], edge[3], torch.zeros(R, dtype=torch.int32),
        torch.ones(R, dtype=torch.int32), edge[3] > 0)
    assert not ovf.any()
    a = tss.build_pool(lep, cnt, 48 * R)[0].numpy()
    pool, n, ovf, fq, fc = tss.forward_scan_dedup(
        td, edge[2], edge[3], 48 * R, _fwd_kw("r1", R, L, edge[1])[0])
    b = pool.numpy()
    assert not bool(ovf) and int(fc) < int(fq)
    assert np.array_equal(a[a[:, 6] != 0], b[b[:, 6] != 0])


# ----------------------------------------------------------------------
# mirrors of the JAX package's engine tests (tests/test_seeder2.py)
# ----------------------------------------------------------------------

def test_seeder2_per_read_fallback(tiny_fm, port_fm):
    """A 480 bp read pushes more LEPs than the lockstep scan's cap: under
    the all-off engine (the JAX default) it is marked bad, recomputed on
    the host and spliced in; the chunk keeps its device results."""
    opt = MemOptions()
    queries = _queries("reads.fq", 8)
    long_read = np.random.default_rng(3).integers(0, 4, 480).astype(np.uint8)
    queries.insert(3, long_read)
    sd = DeviceSeeder(opt, port_fm, CPU)
    assert not sd.dedup
    R, L, qd, rd = sd._upload(queries)
    head = sd._run(sd._build(R, L), qd, rd)[2].numpy()
    bad = np.nonzero(head[28:28 + len(queries)] >> 24)[0]
    assert bad.tolist() == [3]
    l2, s2, so2 = sd.run_flat(queries)
    assert not sd.last_overflow
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, JaxOptions(), q)
        wrep = l_rep_one([(b, e, s) for (_, _, s, b, e) in want],
                         opt.max_occ)
        assert int(l2[r]) == wrep, r
        wseeds = seeding.sample_seeds(JaxOptions(), want)
        seeding.resolve_sal(tiny_fm, [wseeds])
        got = [tuple(int(x) for x in row) for row in s2[so2[r]:so2[r + 1]]]
        assert got == [(x.rbeg, x.qbeg, x.len) for x in wseeds], r


def test_forward_scan_dedup_overflow_flag(idx):
    """Rep caps below the unique-group count raise the overflow flag, as
    in both packages."""
    jd, td = idx
    qarr, rl = _qarr(_queries("reads.fq", 64))
    R, L = qarr.shape
    stages = [(R // 8, 8), (R // 8, L + 2), (R // 8, L + 2), (R // 8, L + 2)]
    got = tss.forward_scan_dedup(td, torch.from_numpy(qarr),
                                 torch.from_numpy(rl), 48 * R, stages)
    want = jss.forward_scan_dedup(jd, jnp.asarray(qarr), jnp.asarray(rl),
                                  48 * R, stages)
    assert bool(got[2]) and bool(want[2])
    _assert_all(got, want, ("pool", "n", "ovf", "fq", "fc"))


def test_forward_dedup_adaptive_disable(tiny_fm, port_fm, monkeypatch):
    """COMPSEED_FWD_MEMO=0 with one-lane rep caps: the first chunk
    overflows, is rerun exactly and switches the forward path off; the
    next chunk runs the lockstep scan with no overflow — in both packages
    alike, with the same outputs and counters."""
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    monkeypatch.setenv("COMPSEED_FWD_MEMO", "0")
    tiny_stages = lambda R, L: [(1, 8), (1, L + 2), (1, L + 2)]  # noqa
    monkeypatch.setattr(jss, "fwd_stages_for", tiny_stages)
    monkeypatch.setattr(tss, "fwd_stages_for", tiny_stages)
    queries = _queries("reads.fq", 48)
    js = JaxSeeder(JaxOptions(), tiny_fm, dedup=True)
    ts = DeviceSeeder(MemOptions(), port_fm, CPU, dedup=True)
    outs = []
    for _ in range(2):
        wst, gst = seeding.SeedingStats(), seeding.SeedingStats()
        want = js.run_flat(queries, wst)
        got = ts.run_flat(queries, gst)
        assert ts.last_overflow == js.last_overflow
        assert ts.fwd_disabled == js.fwd_disabled
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert (gst.bwt_queries, gst.bwt_calls, gst.rounds) == \
            (wst.bwt_queries, wst.bwt_calls, wst.rounds)
        outs.append((ts.last_overflow, ts.fwd_disabled, got))
    assert outs[0][:2] == (True, True) and outs[1][:2] == (False, True)
    for g, w in zip(outs[0][2], outs[1][2]):
        assert np.array_equal(g, w)
    for r, q in enumerate(queries):
        want = seeding.collect_matches(tiny_fm, JaxOptions(), q)
        assert int(outs[1][2][0][r]) == l_rep_one(
            [(b, e, s) for (_, _, s, b, e) in want], MemOptions().max_occ)


def test_adaptive_caps_off_forced_switch_vs_jax(tiny_fm, port_fm,
                                                monkeypatch, capsys):
    """The whole-genome setting, COMPSEED_ADAPTIVE_CAPS=0, with the memo
    round-3 pool forced to R (MEM3_F = 1, slot 10): chunk 1 overflows, is
    rerun exactly and switches the forward dedup off; chunks 2 and 3 run
    the fwd_off engine with no overflow.  Both packages agree chunk for
    chunk: outputs, flags, counters and stderr."""
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    monkeypatch.setenv("COMPSEED_ADAPTIVE_CAPS", "0")
    js = JaxSeeder(JaxOptions(), tiny_fm, dedup=True)
    ts = DeviceSeeder(MemOptions(), port_fm, CPU, dedup=True)
    js.MEM3_F = ts.MEM3_F = 1
    reads = _queries("reads.reordered", 288)
    seen = []
    for c in range(3):
        queries = reads[96 * c: 96 * (c + 1)]
        wst, gst = seeding.SeedingStats(), seeding.SeedingStats()
        want = js.run_flat(queries, wst)
        werr = capsys.readouterr().err
        got = ts.run_flat(queries, gst)
        assert capsys.readouterr().err == werr
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert (gst.bwt_queries, gst.bwt_calls, gst.sal_calls,
                gst.rounds) == (wst.bwt_queries, wst.bwt_calls,
                                wst.sal_calls, wst.rounds)
        assert ts.prof.get("overflow_flags") == js.prof.get("overflow_flags")
        seen.append((ts.last_overflow, ts.fwd_disabled, ts._cap_raises))
    assert seen == [(True, True, 0), (False, True, 0), (False, True, 0)]
    assert ts.prof["overflow_flags"][10] == 1
    assert sum(ts.prof["overflow_flags"]) == 1


def test_default_engine_is_the_jax_default(tiny_fm, port_fm):
    """DeviceSeeder(opt, fm, device) and device_seeder() select the JAX
    package's default engine (dedup off: the lockstep scan and plain
    staged walks)."""
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    js = JaxSeeder(JaxOptions(), tiny_fm)
    for ts in (DeviceSeeder(MemOptions(), port_fm, CPU),
               device_seeder(MemOptions(), port_fm, device=CPU)):
        for a in ("dedup", "r2_dedup", "fwd_disabled", "fwd_memo",
                  "bwd_disabled", "adaptive_caps", "chain_w"):
            assert getattr(ts, a) == getattr(js, a), a
    assert ENGINES["all_off"] == (js.dedup, {})


KNOBS = sorted({k for _, env in ENGINES.values() for k in env} |
               {"COMPSEED_BWD_WIN", "COMPSEED_BWD_W", "COMPSEED_CAPU2_F"})


def test_seeder2_source_scan():
    """No NotImplementedError is left on the seeding side, and the engine
    knobs are read only in DeviceSeeder.__init__ / _build."""
    src = os.path.join(ROOT, "compseed_tpu_torch", "ops", "seeder2.py")
    tree = ast.parse(open(src).read())
    assert "NotImplementedError" not in open(src).read()
    reads = []

    class Scan(ast.NodeVisitor):
        stack: list = []

        def visit_FunctionDef(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        def visit_Constant(self, node):
            if node.value in KNOBS:
                reads.append((node.value, tuple(self.stack)))

    Scan().visit(tree)
    inside = {k for k, where in reads if where[:1] in (("__init__",),
                                                       ("_build",))}
    assert inside == set(KNOBS)
    # outside the two, the names appear only in the ENGINES table
    outside = [(k, w) for k, w in reads if w[:1] not in (("__init__",),
                                                         ("_build",))]
    assert all(w == () for _, w in outside), outside
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "compseed_tpu_torch")):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py") and path != src:
                text = open(path).read()
                assert not [k for k in KNOBS if f'"{k}"' in text], path


# ----------------------------------------------------------------------
# the constants chip_smoke.py holds the card's heads to
# ----------------------------------------------------------------------

def jax_engine_heads(n: int = HEAD_READS) -> dict:
    """Each engine's head record for the first ``n`` bench reads as one
    chunk, from the JAX package's DeviceSeeder on the CPU."""
    from compseed_tpu.index.fmindex import FMIndex as JaxFMIndex
    from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
    from compseed_tpu_torch import bench_input
    _, reads = bench_input.setup()
    fm = JaxFMIndex.load(bench_input.index_prefix(8))
    dfi = jax_to_device(fm)
    qarr, rl = _qarr(list(reads[:n]))
    out = {}
    for name, (dedup, env) in ENGINES.items():
        with engine_env(env):
            js = JaxSeeder(JaxOptions(), fm, dfi=dfi, dedup=dedup)
            head, seedpk = js._build(n, qarr.shape[1])["whole"](
                dfi, jnp.asarray(qarr), jnp.asarray(rl))
        out[name] = head_record(np.asarray(head), np.asarray(seedpk))
    return out


def test_engine_heads_json_covers_the_matrix():
    with open(HEADS_JSON) as f:
        stored = json.load(f)
    assert stored["chunk"]["reads"] == HEAD_READS
    assert set(stored["engines"]) == set(ENGINES)
    for rec in stored["engines"].values():
        assert len(rec["scalars"]) == 28
        assert rec["scalars"][1] > 0


@pytest.mark.slow
def test_engine_heads_regenerate():
    """The stored constants equal a fresh JAX run (about 6 min on the
    CPU: eight engine programs at R = 16,384), and the port on the CPU
    reproduces them (about 2 min)."""
    from compseed_tpu_torch import bench_input
    with open(HEADS_JSON) as f:
        stored = json.load(f)["engines"]
    assert jax_engine_heads() == stored
    fm, reads = bench_input.setup()
    dfi = to_device(fm, CPU)
    for name, (dedup, env) in ENGINES.items():
        with engine_env(env):
            sd = DeviceSeeder(MemOptions(), fm, CPU, dfi=dfi, dedup=dedup)
            R, L, qd, rd = sd._upload(list(reads[:HEAD_READS]))
            _, _, head, seedpk = sd._run(sd._build(R, L), qd, rd)
        assert head_record(head.numpy(), seedpk.numpy()) == stored[name], \
            name


if __name__ == "__main__" and sys.argv[1:] == ["--write-heads"]:
    with open(HEADS_JSON, "w") as f:
        json.dump(dict(
            source="compseed_tpu.ops.seeder2.DeviceSeeder on the CPU, each "
                   "engine of compseed_tpu_torch.ops.seeder2.ENGINES, "
                   "program 'whole' on one chunk",
            command="JAX_PLATFORMS=cpu python -m tests.test_torch_engines "
                    "--write-heads",
            chunk=dict(reads=HEAD_READS, R=HEAD_READS, L=128,
                       input="the first reads of "
                             "compseed_tpu_torch.bench_input.setup()"),
            engines=jax_engine_heads()), f, indent=1)
        f.write("\n")
