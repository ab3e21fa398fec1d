"""The lockstep engines' loops on the card, held on the CPU, exactly
(everything is integer, tolerance 0), at int32 and int64 index types:

  scan_lanes_kernel        csrc/lockstep.cu built with g++ into its host
                           loop (ops/lockstep_cases.HostTwin.scan) against
                           the plain version (seedscan._scan_lanes_plain)
                           and the JAX package's make_scan: round-1 lanes,
                           round-2 task lanes (a pivot, min_hits and active
                           a lane), lanes of rlen 0 and N bases, and capl 2
                           (every read overflows); cnt, ovf and the rows <
                           cnt, the kernel's contract (the rows past cnt
                           unspecified: poisoned); build_pool on such rows
                           against the JAX package's build_pool;
  walk_stage_kernel and    walk_stage through its loop as a card runs it
  walk_stage_entry_kernel  (cuda_lib.run_loop's CPU branch, the host loops
                           at lockstep_cuda._launch) against the plain
                           version and the JAX package's walk_stage: a fit
                           stop mid-stage and a t0 carry, max_steps 13, a
                           first test already false, rwflat and qflat,
                           steps present and absent, fill_oob garbage
                           lanes; the kernel's schedule (and the striding
                           one it was measured against) over a stage of
                           several tiles or passes; walk_pool and
                           walk_pool_dedup (the entry
                           compacting between stages) against the JAX
                           package's;
  sa_batch's loop          through the suffix-array walk's host twins
                           (csrc/fm_walk.cu: the stage entry, which runs
                           the first test, and the walk with its folded
                           test) against the JAX package's sa_batch:
                           lanes of several rounds, and no live lane;
  the call graph           each engine that now takes it (fwd_off,
                           bwd_win, bwd_whole, bwd_off, r2_off, all_off):
                           its _run under cuda_lib.NoHostReads (what a
                           capture refuses) with every loop as the card
                           runs it, head and seed matrix equal to its plain
                           _run on the first 96 reads of reads.fq, which
                           tests/test_torch_engines.py (test_engine_head_
                           and_seeds_equal_jax) holds to the JAX package's
                           program on the same reads.

The JAX programs run once, at int32 (a module cache): the int64 index's
results equal them as integers, as test_torch_engines.py's int64 tests
hold; the garbage lanes, whose arithmetic wraps with the type, are held
to the JAX package at their own type.  The kernels themselves are held
to their plain versions on the card in tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compseed_tpu.ops import fm as jfm
from compseed_tpu.ops import seedscan as jss
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import cuda_lib, lockstep_cases, lockstep_cuda
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops import seeder2
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
from compseed_tpu_torch.options import MemOptions

from tests.test_torch_call_graph import (all_on_host, fm_host,  # noqa: F401
                                         host_launches, sa_on_host)
from tests.test_torch_engines import (_assert_all, _edge_queries, _qarr,
                                      _queries, _stages, engine_env)
from tests.test_torch_loop_graph import hosts  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
L = 128
GRAPHED = ("fwd_off", "bwd_win", "bwd_whole", "bwd_off", "r2_off",
           "all_off")


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """csrc/lockstep.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    return lockstep_cases.HostTwin(
        str(tmp_path_factory.mktemp("lockstep") / "liblockstep_host.so"))


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def idx(request, tiny_fm, port_fm):
    """(JAX index, port index on the CPU) at one dtype."""
    return (jax_to_device(tiny_fm, force_dtype=request.param),
            to_device(port_fm, CPU, force_dtype=request.param))


@pytest.fixture(scope="module")
def jd32(tiny_fm):
    """The JAX index at int32, which the cached JAX programs run on."""
    return jax_to_device(tiny_fm)


_JAX: dict = {}


def _jax(key, run):
    """The JAX program's outputs for ``key``, run once a module."""
    if key not in _JAX:
        _JAX[key] = jax.tree_util.tree_map(np.asarray, run())
    return _JAX[key]


@pytest.fixture
def on_twin(twin, monkeypatch):
    """_scan_lanes and walk_stage / walk_pool through their kernel routes,
    every launch by the host loops (the walk's loop by run_loop's CPU
    branch)."""
    monkeypatch.setattr(tss, "_scan_route",
                        lambda dev: lambda fm, *a: twin.scan(fm, *a))
    monkeypatch.setattr(tss, "_walk_route",
                        lambda dev: tss._walk_stage_kernels)
    monkeypatch.setattr(lockstep_cuda, "_launch", twin.launch)
    return twin


@pytest.fixture(scope="module")
def edge():
    """The fixture reads with Ns, a short read, duplicates, an all-N read
    and an empty one (rlen 0), as numpy and torch."""
    qarr, rl = _qarr(_edge_queries())
    return qarr, rl, torch.from_numpy(qarr), torch.from_numpy(rl)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the scan

def _scan_lanes(case, rl):
    """(pivot0, min_hits, active) of a case: round 1 (pivot 0, min_hits
    1, rlen > 0 active, and one rlen-0 lane active too), a round-2 task
    (a pivot, min_hits 2-40 and active a lane)."""
    R = len(rl)
    if case == "round2":
        rng = np.random.default_rng(21)
        piv = (rng.random(R) * np.maximum(rl, 1)).astype(np.int32)
        mh = rng.integers(2, 41, R).astype(np.int32)
        act = rng.random(R) < 0.8
        return piv, mh, act
    act = rl > 0
    act[-1] = True                                # the empty read
    return np.zeros(R, np.int32), np.ones(R, np.int32), act


SCAN_CASES = {"round1": (tss.CAPL, True), "round2": (tss.CAPL2, False),
              "capl2": (2, True)}


def _scan_want(case, jd32, edge):
    """The JAX package's make_scan on a case: (lep, cnt, ovf) as numpy."""
    capl, advance = SCAN_CASES[case]
    qarr, rl, _, _ = edge
    piv, mh, act = _scan_lanes(case, rl)
    return _jax(("scan", case), lambda: jss.make_scan(
        jd32, L, capl, advance)(jnp.asarray(qarr), jnp.asarray(rl),
                                jnp.asarray(piv), jnp.asarray(mh),
                                jnp.asarray(act)))


def _pushed(lep, cnt):
    """lep with each lane's rows past cnt zeroed (the rows a scan pushed),
    as numpy in lep's dtype."""
    lep, cnt = np.asarray(lep), np.asarray(cnt)
    keep = np.arange(lep.shape[1])[None, :] < cnt[:, None]
    return np.where(keep[..., None], lep, 0).astype(lep.dtype)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_twin_equals_plain_and_jax(idx, jd32, edge, twin, case):
    """scan_lanes_kernel's lane code equals the JAX package's make_scan on
    cnt, ovf and each lane's rows < cnt (a full buffer's last row written
    again; capl 2 overflows, and there every row is held); the rows past
    cnt are unspecified (the twin's lep holds the poison value there, not
    zeros).  The plain version equals JAX whole (its rows past cnt
    zero)."""
    capl, advance = SCAN_CASES[case]
    _, td = idx
    _, rl, tq, trl = edge
    piv, mh, act = _scan_lanes(case, rl)
    want = _scan_want(case, jd32, edge)
    args = (tq, trl, _t(piv), _t(mh), _t(act))
    plain = tss._scan_lanes_plain(td, L, capl, advance, *args)
    got = twin.scan(td, L, capl, advance, *args)
    _assert_all(plain, want, ("lep", "cnt", "ovf"))
    _assert_all((_pushed(got[0].numpy(), got[1].numpy()),) + got[1:],
                (_pushed(want[0], want[1]),) + tuple(want[1:]),
                ("lep rows < cnt", "cnt", "ovf"))
    assert got[0].dtype == td.dtype and got[1].dtype == td.dtype
    assert bool(got[2].any()) == (case == "capl2")
    assert int(got[1].max()) <= capl
    full = got[1].numpy() == capl
    if case == "capl2":                   # every row held at overflow
        assert full.any()
        _assert_all((got[0].numpy()[full],), (want[0][full],),
                    ("lep at overflow",))
    else:                                  # unwritten rows: not zeroed
        assert (got[0].numpy() == cuda_lib.sentinel(td.dtype)).any()


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_build_pool_on_unwritten_rows_equals_jax(idx, jd32, edge, case):
    """build_pool reads no row past cnt: on the scan's lep with those rows
    poisoned (what scan_lanes_kernel leaves there) it equals the JAX
    package's build_pool on the JAX scan's lep (zeros there), every pool
    row, with GP = R * capl (the invalid rows after n_valid all taken)
    and with a GP below the valid rows (n_valid > GP: the overflow)."""
    capl, _ = SCAN_CASES[case]
    _, td = idx
    want = _scan_want(case, jd32, edge)
    lep_np, cnt_np = want[0].astype(np.int64), want[1].astype(np.int64)
    keep = np.arange(capl)[None, :] < cnt_np[:, None]
    poisoned = np.where(keep[..., None], lep_np,
                        cuda_lib.sentinel(td.dtype))
    lep = _t(poisoned).to(td.dtype)
    cnt = _t(cnt_np).to(td.dtype)
    R = lep.shape[0]
    n_valid = int(cnt_np.sum())
    for GP in (R * capl, max(n_valid // 2, 1)):
        got = tss.build_pool(lep, cnt, GP)
        exp = _jax(("build_pool", case, GP), lambda: jss.build_pool(
            jnp.asarray(want[0]), jnp.asarray(want[1]), GP))
        _assert_all(got, exp, ("pool", "n_valid", "overflow"))
        assert bool(got[2]) == (n_valid > GP)
        if GP == R * capl:
            assert n_valid < GP              # invalid rows in the pool


def test_scan_dispatch_takes_the_plain_version_for_cpu_tensors(idx, edge,
                                                               monkeypatch):
    """_scan_lanes runs the plain version for CPU tensors and the kernel's
    launcher only for any other (which refuses a CPU tensor)."""
    _, td = idx
    assert tss._scan_route(CPU) is tss._scan_lanes_plain
    assert tss._scan_route(torch.device("cuda", 0)) is tss._scan_lanes_kernel
    qarr, rl, tq, trl = edge
    piv, mh, act = _scan_lanes("round1", rl)
    with pytest.raises(ValueError, match="CUDA"):
        lockstep_cuda.scan(td, L, 4, True, tq, trl, _t(piv), _t(mh), _t(act))


# ---------------------------------------------------------------------------
# the walk

@pytest.fixture(scope="module")
def pools(edge, port_fm):
    """Round 1's pool of the edge batch (the plain scan and build_pool at
    48 R) as numpy, per index type."""
    qarr, rl, tq, trl = edge
    out = {}
    for dt in (torch.int32, torch.int64):
        td = to_device(port_fm, CPU, force_dtype=np.int64 if
                       dt == torch.int64 else None)
        R = len(rl)
        lep, cnt, _ = tss._scan_lanes_plain(
            td, L, tss.CAPL, True, tq, trl, torch.zeros(R, dtype=torch.int32),
            torch.ones(R, dtype=torch.int32), trl > 0)
        out[dt] = tss.build_pool(lep, cnt, 48 * R)[0].numpy()
    return out


def _walk_state(pool, dt, steps=True, mh=None, garbage=0):
    """walk_pool's first state over the pool rows (numpy), as torch and
    JAX dicts; ``garbage`` live lanes get k and l far outside the table."""
    GP = pool.shape[0]
    valid = pool[:, 6] != 0
    k, l = pool[:, 0].copy(), pool[:, 1].copy()
    if garbage:
        live = np.flatnonzero(valid)[:garbage]
        big = np.iinfo(np.int32).max // 3
        k[live] = big + np.arange(len(live))
        l[live] = -big
    st = dict(k=k, l=l, s=pool[:, 2].copy(),
              rid=pool[:, 5].astype(np.int32),
              i=pool[:, 4].astype(np.int32) - 1,
              death=np.full(GP, -2, np.int32),
              mh=np.ones(GP, pool.dtype) if mh is None else
              np.maximum(mh, 1).astype(pool.dtype),
              alive=valid,
              slot=np.where(valid, np.arange(GP), -1).astype(np.int32))
    if steps:
        st["steps"] = np.zeros(GP, np.int32)
    return ({n: _t(x) for n, x in st.items()},
            {n: jnp.asarray(x) for n, x in st.items()})


# name -> (max_steps, t0, fit (a fraction of the live lanes, or a count),
# rwflat, steps, garbage lanes)
WALK_CASES = {
    "fit_stop": (L + 2, 0, 0.25, True, True, 0),
    "odd_max_steps": (13, 2, 0, False, False, 0),
    "t0_at_max": (8, 8, 0, True, True, 0),
    "fit_above_live": (L + 2, 0, 10 ** 6, True, True, 0),
    "garbage_oob": (L + 2, 0, 0, True, True, 7),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_stage_by_the_loop_equals_plain_and_jax(idx, jd32, edge, pools,
                                                     on_twin, case):
    """walk_stage through its loop (the entry's first test, a segment
    kernel a round with the loop's test after it) equals the plain
    version and the JAX package's walk_stage: every lane word and t; with
    ``fit_stop`` the loop stops mid-stage and a second call carries t on
    (t0 a device word) to the end."""
    max_steps, t0, fit, rw, steps, garbage = WALK_CASES[case]
    jd, td = idx
    if garbage:                      # the JAX package's gather rule
        td = dataclasses.replace(td, fill_oob=True)
    else:
        jd = jd32
    key = ("walk", case, str(td.dtype) if garbage else "")
    qarr, _, tq, _ = edge
    pool = pools[td.dtype]
    st, jst = _walk_state(pool, td.dtype, steps=steps, garbage=garbage)
    n_live = int(st["alive"].sum())
    fit = int(fit * n_live) if isinstance(fit, float) else fit
    qflat, jq = tq.reshape(-1), jnp.asarray(qarr)
    rwt = tss.packed_rev_windows(tq) if rw else None
    rwj = jss.packed_rev_windows(jq) if rw else None
    calls = [(max_steps, t0, fit)]
    if case == "fit_stop":
        calls.append((max_steps, None, 0))
    got_t = plain_t = None

    def jax_walk():
        out, s_, t_ = [], jst, None
        for ms, t, ft in calls:
            s_, t_ = jss.walk_stage(
                jd, jq.reshape(-1), L, ms, s_,
                t0=jnp.asarray(t if t is not None else t_, jnp.int32),
                fit=ft, rwflat=rwj)
            out.append((s_, t_))
        return out

    wants = _jax(key, jax_walk)
    plain, got = st, st
    for (ms, t, ft), (want, want_t) in zip(calls, wants):
        plain, plain_t = tss._walk_stage_plain(
            td, qflat, L, ms, plain, t if t is not None else plain_t, ft,
            rwt)
        got, got_t = tss.walk_stage(td, qflat, L, ms, got,
                                    t if t is not None else got_t, ft, rwt)
        assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.int32
        assert set(got) == set(want) == set(plain)
        for n in want:
            _assert_all((got[n], plain[n]), (want[n], want[n]),
                        (f"{n} by the loop", f"{n} plain"))
        assert int(got_t) == int(plain_t) == int(want_t)
    if case == "fit_stop":
        assert 0 < int(plain_t) < max_steps or not bool(plain["alive"].any())
    if case in ("t0_at_max", "fit_above_live"):
        assert torch.equal(got["alive"], st["alive"])      # no segment ran
        assert int(got_t) == t0


# stage widths against walk_stage_kernel's tiles of 64 lanes, a thread a
# lane: just over one tile, and several tiles and a part of one
WALK_WIDTHS = {"tile_and_one": 64 + 1, "tiles_and_part": 3 * 64 + 2}


@pytest.mark.parametrize("width", list(WALK_WIDTHS))
@pytest.mark.parametrize("rw", [True, False], ids=["rwflat", "qflat"])
def test_walk_stage_wider_than_a_tile(idx, edge, pools, on_twin, width,
                                      rw):
    """walk_stage on the kernel route through its host loop (the kernel's
    lane code): a stage of w lanes, w wider than a tile of the kernel's
    and a multiple of none, live and dead lanes mixed (the pool's rows
    shuffled; a dead lane reads its alive byte alone) and a few mh deaths,
    equals the plain version on every lane word and t, segment by segment
    to max_steps."""
    _, td = idx
    w = WALK_WIDTHS[width]
    _, _, tq, _ = edge
    pool = pools[td.dtype]
    assert pool.shape[0] >= w
    rows = np.random.default_rng(5).permutation(pool.shape[0])[:w]
    mh = np.random.default_rng(6).integers(1, 6, pool.shape[0])
    st, _ = _walk_state(pool[rows], td.dtype, mh=mh[rows])
    assert 0 < int(st["alive"].sum()) < w
    rwt = tss.packed_rev_windows(tq) if rw else None
    qflat = tq.reshape(-1)
    got, got_t = tss.walk_stage(td, qflat, L, L + 2, st, 0, 0, rwt)
    plain, plain_t = tss._walk_stage_plain(td, qflat, L, L + 2, st, 0, 0,
                                           rwt)
    assert int(got_t) == int(plain_t) > 0
    for n in plain:
        assert torch.equal(got[n], plain[n]), n
    assert bool((got["steps"] > 0).any()) and not bool(got["alive"].any())


@pytest.mark.parametrize("kind,mh,rw", [("stages1", False, True),
                                        ("stages2", True, False)])
def test_walk_pool_by_the_loop_equals_jax(idx, jd32, edge, pools, on_twin,
                                          kind, mh, rw):
    """walk_pool on the kernel route (one loop a stage sharing t on the
    card, each later stage's entry compacting the previous stage's live
    lanes) equals the JAX package's walk_pool and the plain route."""
    _, td = idx
    qarr, _, tq, _ = edge
    pool = pools[td.dtype]
    GP = pool.shape[0]
    mhv = np.random.default_rng(9).integers(1, 4, GP) if mh else None
    stages = _stages(kind, GP, L)
    jq = jnp.asarray(qarr)
    want = _jax(("walk_pool", kind), lambda: jax.jit(
        lambda fm, q, p, m: jss.walk_pool(
            fm, q.reshape(-1), L, p, stages, mh=m,
            rwflat=jss.packed_rev_windows(q) if rw else None))(
        jd32, jq, jnp.asarray(pools[torch.int32]),
        None if mhv is None else jnp.asarray(mhv)))
    args = (td, tq.reshape(-1), L, _t(pool), stages)
    kw = dict(mh=None if mhv is None else _t(mhv),
              rwflat=tss.packed_rev_windows(tq) if rw else None)
    got = tss.walk_pool(*args, **kw)
    names = ("death", "fk", "fl", "fs", "ovf", "calls")
    _assert_all(got, want, names)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tss, "_walk_route", lambda dev: tss._walk_stage_plain)
        _assert_all(tss.walk_pool(*args, **kw), want, names)
    assert int(got[5]) > 0


def test_walk_pool_dedup_by_the_loop_equals_jax(idx, jd32, edge, pools,
                                                on_twin):
    """walk_pool_dedup on the kernel route (its probe a walk_stage loop,
    then walk_pool) equals the JAX package's, with per-row min_hits."""
    _, td = idx
    qarr, _, tq, _ = edge
    pool = pools[td.dtype]
    GP = pool.shape[0]
    stages = _stages("stages_u", GP // 2, L)
    mhv = np.random.default_rng(8).integers(1, 3, GP).astype(np.int32)
    jq = jnp.asarray(qarr)
    want = _jax(("walk_pool_dedup",), lambda: jax.jit(
        lambda fm, q, p, m: jss.walk_pool_dedup(
            fm, q.reshape(-1), jss.prefix_hashes(q), L, p, stages, Wb=8,
            mh=m, rwflat=jss.packed_rev_windows(q)))(
        jd32, jq, jnp.asarray(pools[torch.int32]), jnp.asarray(mhv)))
    got = tss.walk_pool_dedup(
        td, tq.reshape(-1), tss.prefix_hashes(tq), L, _t(pool), stages,
        Wb=8, mh=_t(mhv), rwflat=tss.packed_rev_windows(tq))
    _assert_all(got, want, ("death", "fk", "fl", "fs", "ovf", "calls",
                            "n_groups"))


def test_walk_words_are_checked(idx, edge, pools, twin):
    """The host loops refuse what the launchers refuse: no lanes, a SEG
    past a window, a source narrower than the stage or without steps;
    the struct's size is WALK_ARGS'."""
    _, td = idx
    assert twin.lib.lockstep_walk_args_words() == \
        len(lockstep_cuda.WALK_ARGS)
    tq = edge[2]
    st, _ = _walk_state(pools[td.dtype], td.dtype)
    lp = lockstep_cuda.WalkLoop(td, L, L + 2, tq.reshape(-1),
                                tss.packed_rev_windows(tq), 0, 4096)
    lanes = lp.lanes(st)
    lp._point(lanes, 0, None)
    at = lp.AT
    for field, value in (("w", 0), ("seg", 9), ("L", 0)):
        bad = (type(lp.args))(*lp.args)
        bad[at[field]] = value
        assert twin.lib.walk_stage_host(bad) == -1, field
        assert twin.lib.walk_stage_entry_host(bad) == -1, field
    bad = (type(lp.args))(*lp.args)
    bad[at["src_w"]] = 5                      # narrower than the stage
    assert twin.lib.walk_stage_entry_host(bad) == -1
    assert twin.lib.walk_stage_host(lp.args) == 0


# ---------------------------------------------------------------------------
# sa_batch's loop

def test_sa_batch_by_the_loop_equals_jax(idx, jd32, fm_host,  # noqa: F811
                                         monkeypatch):
    """sa_batch through its loop on the kernel route (the stage entry that
    runs the first test, then the walk with its folded test a round, a
    last stage entry; the loop kept for the shape, so that the second call
    takes it again), every launch by its twin, equals the JAX package's
    sa_batch: 400 rows with the 8 longest walks of 1,500 (several rounds
    of 2 sa_intv steps), and the same rows sampled (no live lane: no
    round)."""
    _, td = idx
    rng = np.random.default_rng(31)
    pick = torch.from_numpy(rng.integers(0, td.seq_len, 1500)).to(td.dtype)
    _, steps, _ = tfm._sa_loop_plain(td, pick, torch.zeros_like(pick),
                                     (pick & (td.sa_intv - 1)) != 0)
    order = torch.argsort(steps, descending=True, stable=True)
    k = pick[:400].clone()
    k[100:108] = pick[order[:8]]
    rounds = -(-int(steps.max()) // (2 * td.sa_intv))
    assert rounds >= 3
    calls = host_launches(fm_host, monkeypatch)
    monkeypatch.setattr(tfm, "_sa_loop", lambda dev: tfm._sa_loop_kernels)
    kept = tfm._SA_KEPT.by_thread.get(threading.get_ident(), {})
    n_kept = len(kept)
    for lanes, n_rounds in ((k, rounds), (k - (k & (td.sa_intv - 1)), 0)):
        before = dict(calls)
        with cuda_lib.NoHostReads():
            got = tfm.sa_batch(td, lanes)
        want = _jax(("sa_batch", n_rounds), lambda: jfm.sa_batch(
            jd32, jnp.asarray(lanes.numpy().astype(np.int32))))
        assert np.array_equal(got.numpy().astype(np.int64),
                              want.astype(np.int64))
        ran = {c: calls[c] - before[c] for c in calls}
        assert ran == {"sa_stage_entry_kernel": 2,
                       "fm_inv_psi_walk_kernel": n_rounds,
                       "loop_walks": n_rounds}
    # one loop kept for the shape, which the second call took again
    kept = tfm._SA_KEPT.by_thread[threading.get_ident()]
    assert len(kept) == min(n_kept + 1, tfm.SA_KEPT)
    assert (CPU, id(td), 400) in kept


def test_sa_batch_dispatch(idx):
    """sa_batch's loop: the plain version for CPU tensors, the kernels
    for any other."""
    assert tfm._sa_loop(CPU) is tfm._sa_loop_plain
    assert tfm._sa_loop(torch.device("cuda", 0)) is tfm._sa_loop_kernels


# ---------------------------------------------------------------------------
# the engines that take the call graph

@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_engine_runs_without_host_reads(port_fm, all_on_host,
                                                on_twin, name):
    """The engine's whole call with every loop as the card runs it (the
    lockstep loops by their host loops, chain_scan's, walk_pool_chain's
    and the suffix-array walk's by theirs, each loop through run_loop)
    passes NoHostReads, so a card can capture it, and its head and seed
    matrix equal its plain _run's, the JAX package's program's on these
    reads (tests/test_torch_engines.py); the table gives it the call
    graph."""
    dedup, knobs = ENGINES[name]
    queries = _queries("reads.fq", 96)
    with engine_env(knobs):
        sd = DeviceSeeder(MemOptions(), port_fm, CPU, dedup=dedup)
        R, Lq, qd, rd = sd._upload(queries)
        fns = sd._build(R, Lq)
    assert fns["engine"] == name and seeder2.CALL_GRAPH[name]
    tss.drop_held()
    with cuda_lib.NoHostReads():
        _, _, head, seedpk = sd._run(fns, qd, rd)
    with pytest.MonkeyPatch.context() as m:
        for attr, route in _PLAIN.items():
            m.setattr(tss, attr, route)
        m.setattr(tfm, "_sa_compact", lambda dev: tfm._sa_batch_compact_plain)
        _, _, ph, pp = sd._run(fns, qd, rd)
    assert torch.equal(head, ph) and torch.equal(seedpk, pp)
    assert all_on_host["sa_stage_entry_kernel"] >= 4


_PLAIN = {"_scan_route": lambda dev: tss._scan_lanes_plain,
          "_walk_route": lambda dev: tss._walk_stage_plain,
          "_chain_round": lambda dev: tss._chain_round_plain,
          "_walk_round": lambda dev: tss._walk_round_plain}


def test_plain_routes_read_the_host(port_fm, edge):
    """The plain lockstep scan and walk test their loops on the host (a
    read NoHostReads stops): the CPU's route, which no capture takes."""
    qarr, rl, tq, trl = edge
    td = to_device(port_fm, CPU)
    piv, mh, act = _scan_lanes("round1", rl)
    with pytest.raises(RuntimeError, match="reads a tensor's value"):
        with cuda_lib.NoHostReads():
            tss._scan_lanes(td, L, 4, True, tq, trl, _t(piv), _t(mh),
                            _t(act))
