"""fwd_staged's staged forward walk on the card, held on the CPU, exactly
(everything is integer, tolerance 0), at int32 and int64 index types:

  fwd_stage_kernel   csrc/lockstep.cu built with g++ into its host loop
                     (fwd_stage_host, through seedscan._fwd_stage_walk_kernel
                     with the twin at lockstep_cuda._launch) against the
                     plain version (seedscan._fwd_stage_walk_plain) and the
                     JAX package's _fwd_stage_walk: the LEP sweep with
                     advance at B = 8 (a park) and at B = L + 2 (in-window
                     jumps), a jump target that is padding, round 3 (min_len
                     19, max_intv 20), the round-2 task form (a pivot,
                     min_hits and active a lane, no advance), no live lane,
                     and fill_oob garbage lanes.  Every output comes
                     poisoned (cuda_lib.Poisoned, 0x5A bytes): the state
                     and pf are held everywhere (pf false past a lane's
                     steps), the other records where j < steps and to the
                     sentinel past them (nothing writes there); the plain
                     version's everywhere.
  forward_scan_dedup on the twin (poisoned records) against the plain
                     route, for the four
                     stage lists of tests/test_torch_engines.py's _fwd_kw
                     (r1, r1_small, task, r3), which that file's
                     test_forward_scan_dedup_vs_jax holds to the JAX
                     package's on both routes.
  the call graph     fwd_staged's whole _run under cuda_lib.NoHostReads
                     (what a capture refuses) with every loop as the card
                     runs it, head and seed matrix equal to its plain _run.

The JAX programs run once, at int32 (a module cache): the int64 index's
results equal them as integers; the garbage lanes, whose arithmetic wraps
with the type, are held to the JAX package at their own type.  The kernel
itself is held to its plain version on the card in tests/test_torch_cuda.py
and chip_smoke.py."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
                                         sa_on_host)
from tests.test_torch_engines import (_edge_queries, _fwd_kw, _qarr,
                                      _queries, engine_env)
from tests.test_torch_loop_graph import hosts  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
L = 128
PARK_READ = 56          # _edge_queries' read with Ns at 10 and 11


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


@pytest.fixture(scope="module")
def edge():
    """The fixture reads with Ns, a short read, duplicates, an all-N read
    and an empty one (rlen 0), as numpy."""
    return _qarr(_edge_queries())


@pytest.fixture
def on_twin(twin, monkeypatch):
    """_fwd_stage_walk through its kernel route, every launch by the host
    loops, every output poisoned before its launch."""
    monkeypatch.setattr(tss, "_fwd_route",
                        lambda dev: tss._fwd_stage_walk_kernel)
    monkeypatch.setattr(lockstep_cuda, "_launch", twin.launch)
    with cuda_lib.Poisoned():
        yield twin


_JAX: dict = {}


def _jax(key, run):
    """The JAX program's outputs for ``key``, run once a module."""
    if key not in _JAX:
        _JAX[key] = jax.tree_util.tree_map(np.asarray, run())
    return _JAX[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# name -> (mode, B, advance, lanes): "spawn" every read from pivot p0 (the
# seeder's round-1 spawn), "task" 2R lanes of random reads, pivots,
# min_hits and activity
FWD_CASES = {
    "lep_b8_park": ("lep", 8, True, "spawn"),
    "lep_full_jumps": ("lep", L + 2, True, "spawn"),
    "pad_target": ("lep", L + 2, True, "spawn"),
    "r3": ("r3", L + 2, True, "spawn"),
    "task": ("lep", 24, False, "task"),
    "no_live": ("lep", 8, True, "spawn"),
    "garbage_oob": ("lep", L + 2, True, "spawn"),
}


def _stage(case, qarr, rl, dtype):
    """A case's stage inputs as numpy: (qflat, nxtflat, state, mh, kw)."""
    mode, B, advance, lanes = FWD_CASES[case]
    R = len(rl)
    nxt = np.full((R, L), L, np.int32)
    for r in range(R):
        nx = L
        for p in range(L - 1, -1, -1):
            if qarr[r, p] < 4:
                nx = p
            nxt[r, p] = nx
    rng = np.random.default_rng(17)
    if lanes == "task":
        rid = rng.integers(0, R, 2 * R).astype(np.int32)
        p0 = (rng.random(2 * R) * np.maximum(rl[rid], 1)).astype(np.int32)
        mh = rng.integers(1, 5, 2 * R)
        act = rng.random(2 * R) < 0.9
    else:
        rid = np.arange(R, dtype=np.int32)
        # from pivot 3 at B = 8 the park read's window [4, 12) ends right
        # after its Ns, so the jump target 12 lies outside it: a park
        p0 = np.full(R, 3 if B == 8 else 0, np.int32)
        mh = np.ones(R, np.int64)
        act = np.full(R, case != "no_live")
    pivot = nxt[rid, np.clip(p0, 0, L - 1)]
    alive = (pivot < rl[rid]) & (rl[rid] > 0) & (p0 < rl[rid]) & act
    base = qarr[rid, np.clip(pivot, 0, L - 1)].astype(np.int64)
    # seedscan._set_intv from the fixture's L2, as the seeder spawns
    l2 = np.asarray(dtype.L2, np.int64)
    c = np.clip(base, 0, 3)
    k = np.where(alive, l2[c] + 1, 0)
    l = np.where(alive, l2[3 - c] + 1, 0)
    s = np.where(alive, l2[c + 1] - l2[c], 0)
    if case == "garbage_oob":
        live = np.flatnonzero(alive)[:7]
        big = np.iinfo(np.int32).max // 3
        k[live] = big + np.arange(len(live))
        l[live] = -big
    nxtflat = nxt.reshape(-1).copy()
    if case == "pad_target":
        # the park read's jump after its Ns lands on an N: the lane ends
        nxtflat[PARK_READ * L + 11] = 10
    npdt = np.int64 if dtype.dtype == torch.int64 else np.int32
    state = dict(k=k.astype(npdt), l=l.astype(npdt), s=s.astype(npdt),
                 pos=(pivot + 1).astype(np.int32), pivot=pivot.astype(
                     np.int32), rid=rid, alive=alive)
    kw = dict(mode=mode, min_len=19, max_intv=20) if mode == "r3" else {}
    return (qarr.reshape(-1), nxtflat, state, np.maximum(mh, 1).astype(npdt),
            dict(B=B, advance=advance, **kw))


def _as_torch(out: dict, like: dict) -> dict:
    """JAX outputs as torch tensors of ``like``'s keys and dtypes."""
    return {n: _t(out[n]).to(like[n].dtype) for n in like}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_fwd_stage_twin_equals_plain_and_jax(idx, jd32, edge, on_twin,
                                             case):
    """fwd_stage_kernel's lane code (through the kernel route, its outputs
    poisoned) equals the JAX package's _fwd_stage_walk: the state exactly,
    pf exactly (false past each lane's steps), the other records where j <
    steps, and past them they keep the sentinel; the plain version equals
    it everywhere."""
    jd, td = idx
    if case == "garbage_oob":         # the JAX package's gather rule
        td = dataclasses.replace(td, fill_oob=True)
        key = (case, str(td.dtype))
    else:
        jd, key = jd32, (case,)
    qarr, rl = edge
    qflat, nxtflat, state, mh, kw = _stage(case, qarr, rl, td)
    B, advance = kw.pop("B"), kw.pop("advance")
    want = _jax(key, lambda: jss._fwd_stage_walk(
        jd, jnp.asarray(qflat), jnp.asarray(nxtflat), L, B,
        {n: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 and
                        jd.dtype == jnp.int32 else x)
         for n, x in state.items()},
        jnp.asarray(mh.astype(np.int32) if jd.dtype == jnp.int32 else mh),
        advance, **kw))
    args = (td, _t(qflat), _t(nxtflat), L, B,
            {n: _t(x) for n, x in state.items()}, _t(mh), advance)
    plain = tss._fwd_stage_walk_plain(*args, **kw)
    got = tss._fwd_stage_walk(*args, **kw)
    assert set(got) == set(plain) and set(plain) <= set(want)
    want_t = _as_torch(want, plain)
    for n in plain:
        assert got[n].dtype == plain[n].dtype, n
        assert np.array_equal(plain[n].numpy().astype(np.int64),
                              want[n].astype(np.int64)), f"{n} plain"
    assert lockstep_cases.fwd_vs(got, want_t) == 0
    assert got["rid"] is not None and torch.equal(
        got["rid"], _t(state["rid"]))
    steps = got["steps"]
    past = torch.arange(B)[None, :] >= steps[:, None].to(torch.int64)
    assert not bool(got["pf"][past].any())
    for n in ("pk", "pl", "ps", "pe", "pp"):
        assert bool((got[n][past] == cuda_lib.sentinel(got[n].dtype)).all())
    if case == "no_live":
        assert not steps.any() and not got["pf"].any()
    else:
        assert int(steps.max()) <= B and bool(got["pf"].any())
    if case == "lep_b8_park":
        assert bool(got["waiting"][PARK_READ]) and \
            int(got["wait_npv"][PARK_READ]) == 11
    if case == "lep_full_jumps":
        assert int(got["pivot"][PARK_READ]) >= 12        # past the Ns
    if case == "pad_target":
        assert not bool(got["alive"][PARK_READ]) and \
            not bool(got["waiting"][PARK_READ]) and \
            int(got["pivot"][PARK_READ]) == 0


def test_fwd_stage_dispatch_and_words(idx, edge, twin):
    """_fwd_stage_walk runs the plain version for CPU tensors and the
    kernel's route only for any other, whose launcher refuses a CPU
    tensor; the host loop refuses what the launcher refuses (no lanes, no
    steps, no read length, a null record) and the struct's size is
    FWD_ARGS'."""
    _, td = idx
    assert tss._fwd_route(CPU) is tss._fwd_stage_walk_plain
    assert tss._fwd_route(torch.device("cuda", 0)) is \
        tss._fwd_stage_walk_kernel
    qarr, rl = edge
    qflat, nxtflat, state, mh, kw = _stage("lep_b8_park", qarr, rl, td)
    args = (td, _t(qflat), _t(nxtflat), L, 8,
            {n: _t(x) for n, x in state.items()}, _t(mh), True, False)
    with pytest.raises(ValueError, match="CUDA"):
        lockstep_cuda.fwd_stage(*args)
    assert twin.lib.lockstep_fwd_args_words() == len(lockstep_cuda.FWD_ARGS)
    words = {}

    def keep(kernel, dev, a):
        words["a"] = (type(a))(*a)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(lockstep_cuda, "_launch", keep)
        out = lockstep_cuda.fwd_stage(*args)
    at = {n: i for i, n in enumerate(lockstep_cuda.FWD_ARGS)}
    good = words["a"]
    assert twin.lib.fwd_stage_host(good) == 0
    for field in ("U", "B", "L", "pk", "qflat"):
        bad = (type(good))(*good)
        bad[at[field]] = 0
        assert twin.lib.fwd_stage_host(bad) == -1, field
    assert out["pf"].shape == (len(rl), 8)


@pytest.mark.parametrize("case", ["r1", "r1_small", "task", "r3"])
def test_forward_scan_dedup_on_the_twin_equals_plain(idx, edge, on_twin,
                                                     case):
    """forward_scan_dedup with every stage on the kernel route (the twin)
    equals the plain route: the pool, its row count, the overflow flag
    and fq / fc; one launch a stage.  On that route it reads no value on
    the host and makes no tensor from host data (NoHostReads with
    host_data): a card's call graph can capture it."""
    _, td = idx
    qarr, rl = edge
    R = len(rl)
    stages, kw = _fwd_kw(case, R, L, rl)
    kw = {k: _t(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    td = dataclasses.replace(td, fill_oob=True)       # as the seeder
    launches = []
    orig = on_twin.launch

    def counted(kernel, dev, args):
        launches.append(kernel)
        orig(kernel, dev, args)

    args = (td, _t(qarr), _t(rl), 48 * R, stages)
    with pytest.MonkeyPatch.context() as m, \
            cuda_lib.NoHostReads(host_data=True):
        m.setattr(lockstep_cuda, "_launch", counted)
        got = tss.forward_scan_dedup(*args, **kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tss, "_fwd_route", lambda dev: tss._fwd_stage_walk_plain)
        want = tss.forward_scan_dedup(*args, **kw)
    for nm, g, w in zip(("pool", "n", "ovf", "fq", "fc"), got, want):
        assert torch.equal(g, w), nm
    n_lanes = R if "rids" not in kw else kw["rids"].shape[0]
    assert launches == ["fwd_stage_kernel"] * sum(
        min(U, n_lanes) > 0 for U, _ in stages)
    assert int(got[1]) > 0


def test_fwd_staged_runs_without_host_reads(port_fm, all_on_host, on_twin):
    """fwd_staged's whole call with every loop as the card runs it (each
    forward stage by its host loop, walk_pool_chain's and the
    suffix-array walk's rounds by theirs through run_loop) passes
    NoHostReads, so a card can capture it, and its head and seed matrix
    equal its plain _run's, the JAX package's program's on these reads
    (tests/test_torch_engines.py's test_engine_head_and_seeds_equal_jax);
    the table gives it the call graph."""
    dedup, knobs = ENGINES["fwd_staged"]
    queries = _queries("reads.fq", 96)
    with engine_env(knobs):
        sd = DeviceSeeder(MemOptions(), port_fm, CPU, dedup=dedup)
        R, Lq, qd, rd = sd._upload(queries)
        fns = sd._build(R, Lq)
    assert fns["engine"] == "fwd_staged" and seeder2.CALL_GRAPH["fwd_staged"]
    tss.drop_held()
    launches = []
    orig = on_twin.launch

    def counted(kernel, dev, args):
        launches.append(kernel)
        orig(kernel, dev, args)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(lockstep_cuda, "_launch", counted)
        with cuda_lib.NoHostReads():
            _, _, head, seedpk = sd._run(fns, qd, rd)
    with pytest.MonkeyPatch.context() as m:
        for attr in ("_chain_round", "_walk_round"):
            m.setattr(tss, attr, lambda dev, a=attr: getattr(
                tss, f"{a}_plain"))
        m.setattr(tss, "_fwd_route", lambda dev: tss._fwd_stage_walk_plain)
        m.setattr(tfm, "_sa_compact", lambda dev: tfm._sa_batch_compact_plain)
        _, _, ph, pp = sd._run(fns, qd, rd)
    assert torch.equal(head, ph) and torch.equal(seedpk, pp)
    assert launches.count("fwd_stage_kernel") >= 10
    assert all_on_host["sa_stage_entry_kernel"] >= 4
