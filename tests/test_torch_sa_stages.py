"""sa_batch_compact's suffix-array walk on its kernels, held on the CPU:
sa_stage_entry_kernel and fm_inv_psi_walk_kernel's folded loop test
(csrc/fm_walk.cu) through their host twins built with g++
(sa_stage_entry_host, fm_inv_psi_walk_host with a tail; the twins' own
loop tests are held to alive.any() in tests/test_torch_call_graph.py).

At every boundary between two stages of sa_batch_compact calls on the
fixture index (tiny.fa at its sa_intv of 32 and densified to 8, int32 and
int64 positions; random lanes with sampled rows and the index's longest
walks among them, N = 256 and 1,000, and N = 40 and 1, under 64: a last
stage of one lane), captured as the plain version runs them
(ops/sa_cases.BoundaryCapture), in every form (as captured, no live lane,
cap // 2, cap and cap + 37 live lanes: ovf set): the twin equals the plain
version (ops/fm.py::_sa_boundary_plain) on the outputs, ovf, the next
stage's alive bytes and slots (its fillers dead with slot -1), its live
lanes' positions and steps, and go before the last stage; the plain
version equals the JAX package's boundary (compseed_tpu/ops/fm.py:268-291,
run here on the same numpy state), whose compaction takes only dead lanes
with slot -1 as fillers.  Whole calls: the kernel route on the twins
equals _sa_batch_compact_plain and the JAX package's sa_batch_compact,
bit for bit, with four stage entries and a walk a stage and a round; it
runs no plain version, no sort and no host read.  The twins refuse words
the launchers refuse; the stages' widths are the JAX package's caps."""

import ctypes as ct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import fm as jfm
from compseed_tpu.ops.device_index import densify_sa as jax_densify
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import cuda_lib, fm_cuda, sa_cases
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops.device_index import densify_sa, to_device

from tests.test_torch_call_graph import fm_host  # noqa: F401
from tests.test_torch_call_graph import host_launches, walk_host

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = (256, 1000, 40, 1)
_CASES: dict = {}
_LONG: dict = {}


@pytest.fixture(scope="module", params=[
    (None, 32), (None, 8), (np.int64, 32), (np.int64, 8)],
    ids=["int32-sa32", "int32-sa8", "int64-sa32", "int64-sa8"])
def idx(request, tiny_fm):
    """(JAX index, port index on the CPU) of the tiny fixture, with int32
    or int64 positions, its suffix array sampled every 32 rows (its own)
    or every 8 (densify_sa)."""
    force, sa_intv = request.param
    jd = jax_to_device(tiny_fm, force_dtype=force)
    td = to_device(convert.fmindex_from_jax_package(tiny_fm), CPU,
                   force_dtype=force)
    if sa_intv != jd.sa_intv:
        jd, td = jax_densify(jd, sa_intv), densify_sa(td, sa_intv)
    return jd, td


@pytest.fixture
def on_host(fm_host, monkeypatch):  # noqa: F811
    """The suffix-array walk's launches run by their host twins; returns
    the launches by kernel (host_launches)."""
    return host_launches(fm_host, monkeypatch)


def _long_rows(host, td) -> np.ndarray:
    """The index's 8 rows whose inverse-Psi walk to a sampled row is
    longest, longest first: every row walked to its end by the walk's
    host twin (fm_inv_psi_walk_host), once an index."""
    key = (str(td.dtype), td.sa_intv)
    if key not in _LONG:
        k = torch.arange(td.seq_len, dtype=td.dtype)
        steps = torch.zeros_like(k)
        alive = (k & (td.sa_intv - 1)) != 0
        out = (torch.empty_like(k), torch.empty_like(k),
               torch.empty_like(alive))
        assert walk_host(host, td, k, steps, alive, 1 << 30, out) == 0
        assert not out[2].any()
        order = torch.argsort(out[1], descending=True, stable=True)
        _LONG[key] = k[order[:8]].numpy()
    return _LONG[key]


def _lanes(host, td, N: int) -> torch.Tensor:
    """N random positions of the index: an eighth of them sampled rows,
    then up to 8 of its longest walks, the rest random."""
    rng = np.random.default_rng(N)
    k = rng.integers(0, td.seq_len, N).astype(np.int64)
    k[:N // 8] -= k[:N // 8] % td.sa_intv
    long = _long_rows(host, td)[:N - N // 8]
    k[N // 8:N // 8 + len(long)] = long
    return torch.from_numpy(k).to(td.dtype)


def _cases(host, td) -> list:
    """Every boundary of one sa_batch_compact call a size of SIZES,
    captured as the plain version runs them (once an index)."""
    key = (str(td.dtype), td.sa_intv)
    if key not in _CASES:
        with sa_cases.BoundaryCapture() as cap:
            for N in SIZES:
                tfm.sa_batch_compact(td, _lanes(host, td, N))
        assert len(cap.cases) == 4 * len(SIZES)
        _CASES[key] = cap.cases
    return _CASES[key]


def _jax_boundary(src: dict, N: int, cap) -> dict:
    """The JAX package's step at a boundary (compseed_tpu/ops/fm.py
    :286-291, the done lanes scattered with mode="drop", then :268-279,
    argsort(~alive, stable=True)[:cap] and the gathers) on the same state
    as numpy arrays; asserts that every dead lane its compaction takes
    has slot -1."""
    a = {n: jnp.asarray(v.numpy()) for n, v in src.items()}
    alive, slot = a["alive"], a["slot"].astype(jnp.int32)
    done = ~alive & (slot >= 0)
    sl = jnp.where(done, slot, N)
    out = dict(
        out_steps=a["out_steps"][:N].at[sl].set(
            jnp.where(done, a["steps"], jnp.zeros_like(a["steps"])),
            mode="drop"),
        out_k=a["out_k"][:N].at[sl].set(
            jnp.where(done, a["kk"], jnp.zeros_like(a["kk"])), mode="drop"),
        ovf=a["ovf"])
    slot = jnp.where(done, -1, slot)
    if cap is not None:
        order = jnp.argsort(~alive, stable=True)
        n_alive = jnp.sum(alive.astype(jnp.int32))
        out["ovf"] = out["ovf"] | (n_alive > cap)
        take = order[:cap]
        out.update(kk=a["kk"][take], steps=a["steps"][take],
                   alive=alive[take], slot=slot[take])
        fillers = ~out["alive"]
        assert bool(jnp.all(jnp.where(fillers, out["slot"] == -1, True)))
    return {n: np.asarray(v).astype(np.int64) for n, v in out.items()}


@pytest.mark.parametrize("form", sa_cases.FORMS)
def test_stage_twin_equals_plain_and_jax(fm_host, idx, on_host,  # noqa: F811
                                        form):
    """At every boundary of the fixture calls, in the form: the stage
    entry's twin equals the plain version (sa_cases.stage_vs_plain: the
    outputs, ovf, the next stage's alive bytes and slots, its live
    prefix, go before the last stage), and the plain version equals the
    JAX package's boundary on the same state, every lane; the forms'
    live counts give what they must (ovf past the cap; no go without a
    live lane)."""
    _, td = idx
    seen = 0
    for at, case in enumerate(_cases(fm_host, td)):
        if form not in sa_cases.forms(case):
            continue
        seen += 1
        _, N, s, _ = case
        n0 = on_host["sa_stage_entry_kernel"]
        r = sa_cases.stage_vs_plain(case, form)
        assert on_host["sa_stage_entry_kernel"] == n0 + 1
        assert r["max_abs_err"] == 0, (at, form, r)
        src = sa_cases.source(case, form)
        want = sa_cases.plain(case, src)
        jx = _jax_boundary(src, N, sa_cases.next_width(case))
        for n, x in jx.items():
            got = want[n][:N] if n in ("out_steps", "out_k") else want[n]
            assert np.array_equal(got.numpy().astype(np.int64), x), (at, n)
        w = sa_cases.next_width(case)
        if form == "cap + 37 live":
            assert r["ovf"] and r["kept"] == w
        if form == "no live lane":
            assert r["kept"] == 0 and r["go"] in (None, 0)
        if s == 2:
            assert r["go"] == int(r["live"] > 0)
    assert seen >= (4 * len(SIZES) if form in ("captured", "no live lane")
                    else 3)


@pytest.mark.parametrize("N", SIZES)
def test_kernel_route_equals_plain_and_jax(fm_host, idx, on_host,  # noqa: F811
                                          N):
    """sa_batch_compact's kernel route with every launch by its twin
    equals the plain version and the JAX package's sa_batch_compact:
    SA values and ovf, bit for bit; four stage entries, and the walk once
    a stage and once a round of the last stage."""
    jd, td = idx
    k = _lanes(fm_host, td, N)
    sa, ovf = tfm._sa_batch_compact_kernels(td, k)
    psa, povf = tfm._sa_batch_compact_plain(td, k)
    jsa, jovf = jfm.sa_batch_compact(jd, jnp.asarray(k.numpy()).astype(
        jd.dtype))
    assert torch.equal(sa, psa) and bool(ovf) == bool(povf) == bool(jovf)
    assert np.array_equal(sa.numpy().astype(np.int64),
                          np.asarray(jsa).astype(np.int64))
    assert on_host["sa_stage_entry_kernel"] == 4
    assert on_host["fm_inv_psi_walk_kernel"] >= 3


def test_kernel_route_runs_no_plain_version(fm_host, idx,  # noqa: F811
                                            on_host, monkeypatch):
    """The kernel route (the twins in place of its launches) calls no
    plain version of a boundary, a walk or the loop, sorts nothing, and
    passes the host-read guard (what a capture refuses); its result is
    the plain version's."""
    _, td = idx
    k = _lanes(fm_host, td, 256)
    want = tfm._sa_batch_compact_plain(td, k)

    def fail(*a, **kw):
        raise AssertionError("a plain version ran on the kernel route")

    for name in ("_sa_batch_compact_plain", "_sa_boundary_plain",
                 "_sa_loop_plain", "_walk_plain", "_walk"):
        monkeypatch.setattr(tfm, name, fail)
    monkeypatch.setattr(torch, "argsort", fail)
    with cuda_lib.NoHostReads():
        got = tfm._sa_batch_compact_kernels(td, k)
    assert torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
    assert on_host["sa_stage_entry_kernel"] == 4


def _good_words(host, td):
    """An SaLoop over 256 fixture lanes, every stage's lanes dead,
    pointed at the boundary before its last stage: the loop and the
    stage entry's words."""
    k = _lanes(host, td, 256)
    lp = fm_cuda.SaLoop(td, k, torch.zeros_like(k),
                        (k & (td.sa_intv - 1)) != 0)
    for lanes in lp.lanes:                  # dead lanes, none done
        for x in lanes:
            x.fill_(-1 if x.dtype == torch.int32 and len(lanes) == 4
                    else 0)
    got = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(fm_cuda, "_launch", lambda kernel, dev, args: got.update(
            args=(ct.c_longlong * len(args))(*args)))
        lp.boundary(2)
    return lp, got["args"]


@pytest.mark.parametrize("entry,bad", [
    ("sa_stage_entry", dict(n=0)), ("sa_stage_entry", dict(n=-1)),
    ("sa_stage_entry", dict(kk=0)), ("sa_stage_entry", dict(alive=0)),
    ("sa_stage_entry", dict(w=-1)), ("sa_stage_entry", dict(w=10 ** 6)),
    ("sa_stage_entry", dict(slot=0, kk0=0)),
    ("sa_stage_entry", dict(out_k=0)),
    ("sa_stage_entry", dict(next_alive=0)), ("sa_stage_entry", dict(sc=0)),
    ("sa_stage_entry", dict(lb=0)), ("sa_stage_entry", dict(ovf=0)),
    ("sa_stage_entry", dict(go=0)), ("sa_stage_entry", dict(w=0)),
    ("fm_inv_psi_walk", dict(n=0)), ("fm_inv_psi_walk", dict(n=-1)),
    ("fm_inv_psi_walk", dict(go=0))],
    ids=lambda x: x if isinstance(x, str) else "-".join(
        f"{k}={v}" for k, v in x.items()))
def test_twins_refuse_bad_words(fm_host, idx, entry, bad):  # noqa: F811
    """Each twin takes its good arguments (a boundary before the last
    stage; the loop's walk with its tail) and refuses (-1, as its launcher
    refuses them) words with no lanes, missing arrays, a next stage wider
    than the stage, a first stage without the call's positions, or a loop
    test (open, or the walk's tail) without its go; the walk's tail also
    needs a lane."""
    _, td = idx
    lp, good = _good_words(fm_host, td)
    if entry == "fm_inv_psi_walk":
        lanes = lp.lanes[3][:3]
        retire, cond, go = lp.tail()

        def walk(n=None, go=go):
            return walk_host(fm_host, td, *lanes, lp.n_steps[3], lanes,
                             (retire, cond, go), n=n)
        assert walk() == 0
        assert walk(**{k: None if k == "go" else v
                       for k, v in bad.items()}) == -1
        return
    fn = fm_host.sa_stage_entry_host
    assert fn(ct.addressof(good)) == 0
    args = (ct.c_longlong * len(good))(*good)
    for name, x in bad.items():
        args[fm_cuda.SaLoop.AT[name]] = x
    assert fn(ct.addressof(args)) == -1


@pytest.mark.parametrize("N,widths", [
    (0, (0, 0, 0, 0)), (1, (1, 1, 1, 1)), (40, (40, 10, 2, 1)),
    (63, (63, 15, 3, 1)), (64, (64, 16, 4, 1)),
    (98304, (98304, 24576, 6144, 1536))])
def test_stage_widths_are_the_jax_caps(N, widths):
    """The stages' lanes: N, then max(N // div, 1) for div 4, 16, 64, as
    the JAX package's caps (none wider than N)."""
    assert fm_cuda.sa_widths(N) == widths


def test_route_by_device():
    """sa_batch_compact takes its plain version for CPU tensors and its
    kernels for any other device; a launch of the route raises for
    tensors not on a card."""
    assert tfm._sa_compact(CPU) is tfm._sa_batch_compact_plain
    assert tfm._sa_compact(torch.device("cuda")) is \
        tfm._sa_batch_compact_kernels
    with pytest.raises(ValueError, match="CUDA"):
        fm_cuda._launch("sa_stage_entry_kernel", CPU,
                        (ct.c_longlong * len(fm_cuda.SA_ARGS))())
