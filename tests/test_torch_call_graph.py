"""A seeding call as one CUDA graph, held on the CPU: on a card the default
engine's whole call (ops/seeder2.py::DeviceSeeder._run) is captured once
per (thread, call shape) into a cuda_lib.CallGraph, its loops joining the
capture, and replayed for every later chunk.  The graph itself runs on
the card (tests/test_torch_cuda.py, chip_smoke.py); here:

- the suffix-array walk's host twins (csrc/fm_walk.cu built with g++:
  fm_inv_psi_walk_host with a tail, the walk's folded loop test, and
  sa_stage_entry_host before the last stage, the loop's first test)
  against alive.any(): random masks, all dead, only the last lane alive;
- sa_batch_compact by its kernel route, its last stage through
  run_loop's CPU branch and the twins, against the JAX package's
  sa_batch_compact, int32 and int64, with stragglers past the last
  stage's cap (ovf set); the last stage's loop alone over unsampled rows,
  five rounds, against the plain loop;
- the host-read guard (cuda_lib.NoHostReads: what a capture refuses)
  lets the default engine's _run through, with every loop run as the
  card runs it (run_loop's CPU branch and the host twins), on the kept
  tensors and on the capture route, and its head and seed matrix equal
  the JAX package's ``whole``; it stops fwd_staged's plain staged forward
  walk (the CPU's route) and lets its kernel route (the walk's host loop)
  through;
- the registry of kept call graphs (cuda_lib.Kept through
  DeviceSeeder._call, with a stand-in graph): its key, eviction at
  HELD_CALLS, dropping on a cap raise's rebuild, each thread its own."""

import ctypes as ct
import shutil
import subprocess
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import fm as jfm
from compseed_tpu.ops.device_index import densify_sa as jax_densify
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu.ops.seeder2 import DeviceSeeder as JaxSeeder
from compseed_tpu.options import MemOptions as JaxOptions
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import (cuda_lib, fm_cuda, lockstep_cases,
                                    lockstep_cuda, sa_cases)
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops import seeder2
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.cuda_lib import launcher_of
from compseed_tpu_torch.ops.device_index import densify_sa, to_device
from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
from compseed_tpu_torch.options import MemOptions

from tests.test_torch_loop_graph import MODULES, hosts  # noqa: F401
from tests.test_torch_seeder import _queries

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_READS = 96


@pytest.fixture(scope="module")
def lockstep_twin(tmp_path_factory):
    """csrc/lockstep.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    return lockstep_cases.HostTwin(
        str(tmp_path_factory.mktemp("lockstep") / "liblockstep_host.so"))


@pytest.fixture(scope="module")
def fm_host(tmp_path_factory):
    """csrc/fm_walk.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    so = str(tmp_path_factory.mktemp("fm_walk") / "libfm_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, fm_cuda.LIB.src], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    lib.sa_stage_entry_host.argtypes = [p]
    lib.fm_inv_psi_walk_host.argtypes = [p, ll, p, ll, i, p, p, p, i, ll,
                                         p, p, p, ll, i, p, ll, p]
    for fn in (lib.sa_stage_entry_host, lib.fm_inv_psi_walk_host,
               lib.fm_sa_args_words):
        fn.restype = i
    return lib


def walk_host(host, fm, kk, steps, alive, n_steps: int, out, tail=None,
              n=None) -> int:
    """fm_cuda.inv_psi_walk's launch by the walk's host twin
    (fm_inv_psi_walk_host) on CPU tensors, into ``out``, with the loop's
    test after it when ``tail`` (retire, cond, go) is given; ``n`` the
    lane count passed (None: the lanes').  Returns the twin's code."""
    retire, cond, go = tail or (None, 0, None)
    return host.fm_inv_psi_walk_host(
        fm.occ_packed.data_ptr(), fm.n_rows, fm.L2.data_ptr(),
        int(fm.primary), int(bool(fm.fill_oob)), kk.data_ptr(),
        steps.data_ptr(), alive.data_ptr(), n_steps, fm.sa_intv - 1,
        *(x.data_ptr() for x in out), kk.shape[0] if n is None else n,
        int(fm.dtype == torch.int64),
        None if retire is None else retire.data_ptr(), cond,
        None if go is None else go.data_ptr())


def host_launches(host, monkeypatch) -> dict:
    """The suffix-array walk's launches run by their host twins: the
    stage entries (fm_cuda._launch) and the walks (fm_cuda.inv_psi_walk,
    which SaLoop.walk calls).  Returns the launches by kernel, and under
    "loop_walks" the walks with the loop's test."""
    calls = {"sa_stage_entry_kernel": 0, "fm_inv_psi_walk_kernel": 0,
             "loop_walks": 0}

    def launch(kernel, dev, args):
        assert dev.type == "cpu" and kernel == "sa_stage_entry_kernel"
        assert host.sa_stage_entry_host(ct.addressof(args)) == 0, kernel
        calls[kernel] += 1

    def walk(fm, kk, steps, alive, n_steps, out=None, tail=None):
        assert kk.device.type == "cpu" and out is not None
        assert walk_host(host, fm, kk, steps, alive, n_steps, out,
                         tail) == 0
        calls["fm_inv_psi_walk_kernel"] += 1
        calls["loop_walks"] += tail is not None
        return out

    monkeypatch.setattr(fm_cuda, "_launch", launch)
    monkeypatch.setattr(fm_cuda, "inv_psi_walk", walk)
    return calls


@pytest.fixture
def sa_on_host(fm_host, monkeypatch):
    """sa_batch_compact through its kernel route (the last stage's loop
    through run_loop's CPU branch) with every launch run by its host
    twin; returns the launches by kernel (host_launches)."""
    calls = host_launches(fm_host, monkeypatch)
    monkeypatch.setattr(tfm, "_sa_compact",
                        lambda dev: tfm._sa_batch_compact_kernels)
    return calls


@pytest.fixture
def all_on_host(hosts, sa_on_host, monkeypatch):  # noqa: F811
    """Every loop of the default engine as the card runs it: chain_scan's
    and walk_pool_chain's rounds by the host builds of their kernels,
    the suffix-array walk by its twins, each loop through run_loop."""
    for name, mod in MODULES.items():
        def launch(kernel, dev, args, lib=hosts[name]):
            assert dev.type == "cpu"
            assert getattr(lib, launcher_of(kernel, "_host"))(
                ct.addressof(args)) == 0, kernel
        monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(tss, "_chain_round",
                        lambda dev: tss._chain_round_kernels)
    monkeypatch.setattr(tss, "_walk_round",
                        lambda dev: tss._walk_round_kernels)
    return sa_on_host


def _sa_words(alive: torch.Tensor):
    """A stage entry's SaArgs words over the lanes ``alive`` (positions
    and steps 0, every slot -1, so that no lane is done): the boundary
    before the last stage (the loop's first test, a next stage as wide);
    the walk's tail over the same lanes (retire, cond, go); an index
    whose rows the walk of no step never reads; and the tensors the
    words name, go among them."""
    n = alive.shape[0]
    i32 = torch.int32
    t = dict(kk=torch.zeros(n, dtype=i32), steps=torch.zeros(n, dtype=i32),
             alive=alive, slot=torch.full((n,), -1, dtype=i32),
             next_kk=torch.empty(n, dtype=i32),
             next_steps=torch.empty(n, dtype=i32),
             next_alive=torch.empty(n, dtype=torch.bool),
             next_slot=torch.empty(n, dtype=i32),
             out_steps=torch.zeros(n, dtype=i32),
             out_k=torch.zeros(n, dtype=i32),
             ovf=torch.zeros((), dtype=torch.bool),
             sc=torch.zeros(3 + n // 512, dtype=torch.int64),
             go=torch.full((), -1, dtype=i32))
    args = (ct.c_longlong * len(fm_cuda.SA_ARGS))()
    at = fm_cuda.SaLoop.AT
    for name in ("kk", "steps", "alive", "slot", "next_kk", "next_steps",
                 "next_alive", "next_slot", "out_steps", "out_k", "ovf",
                 "sc", "go"):
        args[at[name]] = t[name].data_ptr()
    for name, x in (("kk0", t["kk"].data_ptr()), ("n", n), ("w", n),
                    ("lb", t["sc"][2:].data_ptr()), ("open", 1)):
        args[at[name]] = x
    fm = SimpleNamespace(occ_packed=torch.zeros((1, 16), dtype=i32),
                         n_rows=1, L2=torch.zeros(5, dtype=i32), primary=0,
                         fill_oob=False, sa_intv=8, dtype=i32)
    t["tail"] = (t["sc"][1], 0, t["go"])
    return args, fm, t


def test_sa_args_layout(fm_host):
    """The host build's SaArgs has a word for each of SA_ARGS."""
    assert fm_host.fm_sa_args_words() == len(fm_cuda.SA_ARGS)


def _twins(fm_host, args, fm, t) -> dict:
    """Both loop tests' twins over the lanes of _sa_words, each from go =
    -1: the walk's folded tail (a walk of no step, in place, with a tail)
    and the stage entry before the last stage; their codes and go."""
    out = {}
    lanes = (t["kk"], t["steps"], t["alive"])
    for what in ("walk tail", "stage entry"):
        t["go"].fill_(-1)
        rc = walk_host(fm_host, fm, *lanes, 0, lanes, t["tail"]) \
            if what == "walk tail" else \
            fm_host.sa_stage_entry_host(ct.addressof(args))
        out[what] = (rc, int(t["go"]))
    return out


@pytest.mark.parametrize("n", [1, 63, 1536, 5000])
@pytest.mark.parametrize("mask", ["random", "dead", "last"])
def test_sa_loop_twins_against_any(fm_host, n, mask):
    """Both loop tests' twins leave go = alive.any() over the lanes: the
    walk's folded tail (fm_inv_psi_walk_host with a tail) and the stage
    entry before the last stage (sa_stage_entry_host with open); a
    sparse random mask, every lane dead, only the last lane alive."""
    rng = np.random.default_rng(n)
    alive = torch.from_numpy(rng.random(n) < 0.01)
    if mask != "random":
        alive.zero_()
    if mask == "last":
        alive[-1] = True
    args, fm, t = _sa_words(alive)
    for what, (rc, go) in _twins(fm_host, args, fm, t).items():
        assert rc == 0 and go == int(alive.any()), what


def test_sa_loop_twins_refuse_bad_words(fm_host):
    """A negative lane count, or a loop test without its go word, is
    refused (-1) by both twins, as the launchers refuse it; the stage
    entry also refuses lanes without an alive array, and the walk's tail
    a walk of no lane (whose last block would never retire)."""
    alive = torch.ones(4, dtype=torch.bool)
    args, fm, t = _sa_words(alive)
    at = fm_cuda.SaLoop.AT
    for field, value in (("n", -1), ("alive", 0), ("go", 0)):
        bad = (ct.c_longlong * len(args))(*args)
        bad[at[field]] = value
        assert fm_host.sa_stage_entry_host(ct.addressof(bad)) == -1, field
    lanes = (t["kk"], t["steps"], t["alive"])
    retire, cond, _ = t["tail"]
    for n, tail in ((-1, t["tail"]), (0, t["tail"]), (4, (retire, cond,
                                                          None))):
        assert walk_host(fm_host, fm, *lanes, 0, lanes, tail, n=n) == -1, n
    assert walk_host(fm_host, fm, *lanes, 0, lanes, t["tail"]) == 0


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def idx(request, tiny_fm):
    """(JAX index, port index on the CPU) of the tiny fixture, its suffix
    array sampled every 8 rows (densify_sa, as the bench index): its
    walks (max 230 steps at the fixture's 32) then outlast the first
    three stages' 56 steps by several rounds of the last stage's 16."""
    force = request.param
    return (jax_densify(jax_to_device(tiny_fm, force_dtype=force), 8),
            densify_sa(to_device(convert.fmindex_from_jax_package(tiny_fm),
                                 CPU, force_dtype=force), 8))


def test_sa_batch_compact_by_the_loop_equals_jax(idx, sa_on_host):
    """sa_batch_compact over 256 lanes (sampled rows, then 8 rows of
    long walks: more than the last stage's cap of 4, so ovf is set and
    some stragglers are dropped, then random rows) by its kernel route,
    every launch by its twin: SA values and ovf equal the JAX package's,
    bit for bit, and equal the plain version's; four stage entries, and
    the walk three times and once a round of the last stage."""
    jd, td = idx
    rng = np.random.default_rng(11)
    N = 256
    long = sa_cases.long_rows(td, 8)[0].numpy()
    k = rng.integers(0, td.seq_len, N).astype(np.int64)
    k[:32] = (k[:32] // td.sa_intv) * td.sa_intv          # sampled rows
    k[32:40] = long
    kt = torch.from_numpy(k).to(td.dtype)
    sa, ovf = tfm.sa_batch_compact(td, kt)
    jsa, jovf = jfm.sa_batch_compact(jd, jnp.asarray(k).astype(jd.dtype))
    assert bool(ovf) and bool(jovf)
    assert np.array_equal(sa.numpy().astype(np.int64),
                          np.asarray(jsa).astype(np.int64))
    assert sa_on_host["sa_stage_entry_kernel"] == 4
    assert sa_on_host["fm_inv_psi_walk_kernel"] >= 4
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tfm, "_sa_compact",
                  lambda dev: tfm._sa_batch_compact_plain)
        sa_plain, ovf_plain = tfm.sa_batch_compact(td, kt)
    assert torch.equal(sa, sa_plain) and bool(ovf_plain)


def test_sa_loop_rounds_equal_the_plain_loop(idx, sa_on_host):
    """The last stage's loop alone by the kernel route: cuda_lib.run_loop
    with SaLoop.boundary(2), the stage entry that runs the loop's first
    test, and SaLoop.walk(3, loop=True), whose folded tail tests each next
    round (2 sa_intv = 16 steps a round; sa_cases.run_last_loop), every
    launch by its twin, over 512 unsampled rows put into the stage before
    the last (sa_cases.last_loop: each with a slot, the rest of that
    stage dead with slot -1), the index's 8 longest walks among them (up
    to 71 steps): the last stage's kk, steps and alive equal the plain
    loop's (_sa_loop_plain) from the same rows, in five rounds, each one
    walk with the loop's test; over the same rows sampled (all dead), no
    round, every lane written out as it was."""
    _, td = idx
    rng = np.random.default_rng(13)
    n = 512
    k = torch.from_numpy(rng.integers(0, td.seq_len, n)).to(td.dtype)
    k = torch.where((k & (td.sa_intv - 1)) == 0, k + 1, k)
    k[100:108] = sa_cases.long_rows(td, 8)[0]
    for lanes in (k, k - (k & (td.sa_intv - 1))):
        alive = (lanes & (td.sa_intv - 1)) != 0
        want = tfm._sa_loop_plain(td, lanes, torch.zeros_like(lanes), alive)
        lp = sa_cases.last_loop(td, lanes)
        assert lp.widths[2:] == (4 * n, n)
        before = dict(sa_on_host)
        sa_cases.run_last_loop(lp)
        ran = {c: sa_on_host[c] - before[c] for c in sa_on_host}
        rounds = -(-int(want[1].max()) // (2 * td.sa_intv))
        assert ran == {"sa_stage_entry_kernel": 1,
                       "fm_inv_psi_walk_kernel": rounds,
                       "loop_walks": rounds}
        assert int(lp.go) == 0 and not bool(lp.ovf)
        if bool(alive.any()):
            assert rounds == 5
            for g, w in zip(lp.lanes[3], want):
                assert torch.equal(g, w)
        else:
            assert torch.equal(lp.out_k[:n], lanes)
            assert not bool(lp.out_steps[:n].any())
            assert not bool(lp.lanes[3][2].any())
    assert rounds == 0


def test_sa_batch_compact_stragglers_equal_the_plain_version(idx,
                                                             sa_on_host):
    """A whole call by the kernel route (run_loop and the twins) over 512
    lanes, 504 sampled rows and the index's 8 longest walks (up to 71
    steps, none past a stage's cap), equals the plain version in SA
    values and ovf (clear), its rounds the plain loop's: the walk three
    times and once a round; over lanes all dead, no round."""
    _, td = idx
    rng = np.random.default_rng(13)
    k = torch.from_numpy(rng.integers(0, td.seq_len, 512)).to(td.dtype)
    k = k - (k & (td.sa_intv - 1))
    k[100:108] = sa_cases.long_rows(td, 8)[0]
    for lanes in (k, k - (k & (td.sa_intv - 1))):
        before = dict(sa_on_host)
        got = tfm.sa_batch_compact(td, lanes)
        want = tfm._sa_batch_compact_plain(td, lanes)
        assert torch.equal(got[0], want[0]) and not bool(got[1]) \
            and not bool(want[1])
        steps = torch.zeros_like(lanes)
        alive = (lanes & (td.sa_intv - 1)) != 0
        _, steps, _ = tfm._sa_loop_plain(td, lanes, steps, alive)
        first = 7 * td.sa_intv                 # the first three stages
        rounds = -(-max(int(steps.max()) - first, 0) // (2 * td.sa_intv))
        assert sa_on_host["sa_stage_entry_kernel"] - \
            before["sa_stage_entry_kernel"] == 4
        assert sa_on_host["fm_inv_psi_walk_kernel"] - \
            before["fm_inv_psi_walk_kernel"] == 3 + rounds
        assert sa_on_host["loop_walks"] - before["loop_walks"] == rounds
    assert rounds == 0


@pytest.fixture(scope="module")
def whole(tiny_fm):
    """The JAX package's ``whole`` (the default engine's device program)
    on the first N_READS reads of reads.fq: (queries, head, seedpk)."""
    queries = _queries("reads.fq", N_READS)
    js = JaxSeeder(JaxOptions(), tiny_fm, dedup=True)
    ts = DeviceSeeder(MemOptions(), convert.fmindex_from_jax_package(
        tiny_fm), CPU, dedup=True)
    R, L, qd, rd = ts._upload(queries)
    jh, jp = js._build(R, L)["whole"](js.dfi, jnp.asarray(qd.numpy()),
                                     jnp.asarray(rd.numpy()))
    return queries, np.asarray(jh), np.asarray(jp)


@pytest.mark.parametrize("route", ["kept", "capture"])
def test_guard_lets_the_default_run_through(tiny_fm, whole, all_on_host,
                                            route, monkeypatch):
    """The default engine's whole call, every loop through run_loop as on
    the card, under NoHostReads: no host read and no shape that depends
    on the values, so a card can capture it; head and seed matrix equal
    the JAX package's ``whole``.  "kept": chain_scan and walk_pool_chain
    on their kept tensors (seedscan._held, the eager route); "capture":
    the route they take inside a call's capture (cuda_lib.capturing
    patched true: no kept tensors, the memo and the pool's columns copied
    once, nothing copied out)."""
    queries, jh, jp = whole
    sd = DeviceSeeder(MemOptions(), convert.fmindex_from_jax_package(
        tiny_fm), CPU, dedup=True)
    R, L, qd, rd = sd._upload(queries)
    fns = sd._build(R, L)
    assert fns["engine"] == "default" and not sd._graphed(fns)  # the CPU
    if route == "capture":
        monkeypatch.setattr(cuda_lib, "capturing", lambda dev: True)
        monkeypatch.setattr(tss, "_held", lambda *a: pytest.fail(
            "the capture route keeps no tensors"))
    tss.drop_held()
    with cuda_lib.NoHostReads():
        _, _, head, seedpk = sd._run(fns, qd, rd)
    assert np.array_equal(head.numpy(), jh)
    assert np.array_equal(seedpk.numpy(), jp)
    assert all_on_host["sa_stage_entry_kernel"] == 4


def test_guard_stops_an_eager_engine(tiny_fm, whole, all_on_host,
                                     lockstep_twin, monkeypatch):
    """fwd_staged's plain staged forward walk (seedscan.
    _fwd_stage_walk_plain, the CPU's route, which tests its loop on the
    host) is stopped by NoHostReads at its first host read; with the walk
    on the kernel route (its host loop at lockstep_cuda._launch) and every
    other loop as the card runs it, the same call passes."""
    for k, v in seeder2.ENGINES["fwd_staged"][1].items():
        monkeypatch.setenv(k, v)
    sd = DeviceSeeder(MemOptions(), convert.fmindex_from_jax_package(
        tiny_fm), CPU, dedup=seeder2.ENGINES["fwd_staged"][0])
    R, L, qd, rd = sd._upload(whole[0])
    fns = sd._build(R, L)
    assert fns["engine"] == "fwd_staged" and \
        seeder2.CALL_GRAPH["fwd_staged"]
    assert tss._fwd_route(CPU) is tss._fwd_stage_walk_plain
    with pytest.raises(RuntimeError, match="reads a tensor's value") as e:
        with cuda_lib.NoHostReads():
            sd._run(fns, qd, rd)
    assert any(f.name == "_fwd_stage_walk_plain" for f in e.traceback)
    monkeypatch.setattr(tss, "_fwd_route",
                        lambda dev: tss._fwd_stage_walk_kernel)
    monkeypatch.setattr(lockstep_cuda, "_launch", lockstep_twin.launch)
    tss.drop_held()
    with cuda_lib.NoHostReads():
        _, _, head, _ = sd._run(fns, qd, rd)
    # the same seeds as the default engine's: mtotal, stotal, n_uniq
    assert np.array_equal(head[:3].numpy(), whole[1][:3])


@pytest.mark.parametrize("name", sorted(seeder2.ENGINES))
def test_engine_table_names_each_engine(tiny_fm, name, monkeypatch):
    """Each entry of ENGINES, selected by its knobs, is the engine _build
    names, and every one takes the call graph (on a card); EagerCalls
    turns it off for its block and restores the table."""
    dedup, knobs = seeder2.ENGINES[name]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    sd = DeviceSeeder(MemOptions(), convert.fmindex_from_jax_package(
        tiny_fm), CPU, dedup=dedup)
    fns = sd._build(256, 128)
    assert fns["engine"] == name
    assert seeder2.CALL_GRAPH[name]
    with seeder2.EagerCalls():
        assert not any(seeder2.CALL_GRAPH.values())
    assert seeder2.CALL_GRAPH[name]


class StandIn:
    """A CallGraph's stand-in: runs the call eagerly; counts its makings
    and closings."""
    made, closed = [], []

    def __init__(self, dev, fn, inputs):
        self.fn = fn
        self.shape = tuple(tuple(x.shape) for x in inputs)
        StandIn.made.append(self)

    def run(self, inputs):
        return self.fn(*inputs)

    def close(self):
        StandIn.closed.append(self)


@pytest.fixture
def stand_in(tiny_fm, monkeypatch):
    """A default-engine seeder whose programs take the call graph, with
    the stand-in graph; returns (seeder, queries)."""
    StandIn.made, StandIn.closed = [], []
    monkeypatch.setattr(cuda_lib, "CallGraph", StandIn)
    sd = DeviceSeeder(MemOptions(), convert.fmindex_from_jax_package(
        tiny_fm), CPU, dedup=True)
    monkeypatch.setattr(sd, "_graphed", lambda fns: True)
    return sd


def test_kept_call_key_and_reuse(stand_in):
    """One graph a call shape: the key covers R, L, the engine, the caps,
    the index's identity and dtype; a later call of the shape replays the
    kept graph, and _call's outputs equal _run's."""
    sd = stand_in
    queries = _queries("reads.fq", N_READS)
    R, L, qd, rd = sd._upload(queries)
    fns = sd._build(R, L)
    dev, R_, L_, engine, caps, dfi_id, dt = fns["key"]
    assert (R_, L_, engine, dfi_id, dt) == (R, L, "default", id(sd.dfi),
                                            sd.dfi.dtype)
    assert caps[:2] == (sd.GP_F, sd.CAPU_F)
    head, seedpk = sd._call(fns, qd, rd)
    _, _, h2, s2 = sd._run(fns, qd, rd)
    assert torch.equal(head, h2) and torch.equal(seedpk, s2)
    sd._call(fns, qd, rd)
    assert len(StandIn.made) == 1
    assert sd._build(512, L)["key"] != fns["key"]
    sd.GP_F *= 2
    sd._progs.clear()
    assert sd._build(R, L)["key"] != fns["key"]


def _fake_call(sd, R: int, L: int):
    """_call on a call shape (R, L) of programs that take the graph (the
    seeder's _run a stand-in program, fake_run)."""
    fns = dict(key=("shape", R, L))
    return sd._call(fns, torch.zeros((R, L), dtype=torch.uint8),
                    torch.zeros(R, dtype=torch.int32))


def fake_run(fns, qd, rd):
    return None, None, qd.sum(), rd.sum()


def test_kept_calls_evict_at_held_calls(stand_in):
    """Beyond HELD_CALLS shapes a thread's least recently used graph is
    closed; a shape used again moves to the end."""
    sd = stand_in
    sd._run = fake_run
    n = tss.HELD_CALLS
    for i in range(n):
        _fake_call(sd, 256 * (i + 1), 32)
    _fake_call(sd, 256, 32)                      # the first, used again
    assert len(StandIn.made) == n and not StandIn.closed
    _fake_call(sd, 256 * (n + 1), 32)
    assert StandIn.closed == [StandIn.made[1]]   # the least recent
    kept = sd._calls.by_thread[threading.get_ident()]
    assert len(kept) == n and ("shape", 256, 32) in kept


def test_kept_calls_dropped_on_a_rebuild(stand_in, capsys):
    """A cap raise rebuilds the programs (_note_fwd_overflow ->
    _rebuild): the thread's call graphs are closed with them."""
    sd = stand_in
    sd._run = fake_run
    for i in range(3):
        _fake_call(sd, 256 * (i + 1), 32)
    flags = np.zeros(11, dtype=np.int32)
    flags[0] = 1                                   # the round-1 pool cap
    sd._note_fwd_overflow(flags)
    assert "raising" in capsys.readouterr().err
    assert sorted(map(id, StandIn.closed)) == sorted(map(id, StandIn.made))
    assert threading.get_ident() not in sd._calls.by_thread
    assert not sd._progs


def test_kept_calls_are_each_threads_own(stand_in):
    """Threads calling one shape at once each make and keep a graph of
    their own; once they have ended, a thread that keeps none takes over
    one ended thread's (no graph made) and the others' are closed."""
    import concurrent.futures as cf
    sd = stand_in
    sd._run = fake_run
    met = threading.Barrier(3)

    def work(_):
        met.wait(timeout=60)                # three threads at once
        return _fake_call(sd, 256, 32)

    with cf.ThreadPoolExecutor(max_workers=3) as ex:
        list(ex.map(work, range(3)))
    n_made = len(StandIn.made)
    assert n_made == 3 and not StandIn.closed
    _fake_call(sd, 256, 32)
    assert len(StandIn.made) == n_made            # one taken over
    assert len(StandIn.closed) == n_made - 1      # the other ended ones'
    (mine,) = sd._calls.by_thread[threading.get_ident()].values()
    assert mine not in StandIn.closed
    assert list(sd._calls.by_thread) == [threading.get_ident()]
