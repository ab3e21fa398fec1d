"""walk_pool_chain's round body, the kernels of compseed_tpu_torch/csrc/
walk_chain.cu, held on the CPU: the source compiled with g++ into its host
loops (walk_*_host), run in place of the launches through walk_pool_chain's
own kernel path (a test-only patch of ``walk_cuda._launch`` and
``seedscan._walk_round``), against the plain round
(``seedscan._walk_round_plain``) and the JAX package's walk_pool_chain, bit
for bit, at int32 and int64 index types over the ``tiny`` fixture index:
death, fk, fl, fs, ovf, calls and n_groups.  Cases: round 1 (no min_hits),
round 2 (per-row min_hits), a lane cap below the valid rows (overflow) and
one at the valid rows (more groups than representatives, groups deferred),
over a pool wide enough that every segment width and compaction runs.

At step level, each kernel's host loop against its plain step on the
captured rounds, in their own form, with more groups than representatives,
and in the forced forms of ops/walk_cases.forced: two lanes whose keys
collide while their (window, k, s) differ, a live lane whose key is
INT32_MAX, and a live lane after a dead one of the same (window, k, s);
also cut to a width that is no multiple of a block's lanes, padded (most
representatives past n_w) and walked 5 chars a round (another width of
the apply's chain rows), each also capped and forced; the pads past n_w
come from the key kernel's host loop.

Also: the native mix against the plain version's int64 emulation (bits.
mul32); the caller's pool is never written; the Args layout the launchers
pass; the dispatch (the plain round only for CPU tensors, the kernels or
an error otherwise); round_work counts each byte once.  The kernels
themselves are held to the plain round on the card in
tests/test_torch_cuda.py and chip_smoke.py."""

import ast
import ctypes as ct
import inspect
import re
import shutil
import subprocess
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import seedscan as jss
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops import walk_cases, walk_cuda
from compseed_tpu_torch.ops.cuda_lib import launcher_of
from compseed_tpu_torch.ops.device_index import to_device

from tests.test_torch_seeder import _queries

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
L = 128
N_READS = 96
CHAIN_W = 8
SEGS = (1, 4, 16)           # walk_pool_chain's default width divisors
NARROW = (1, 2, 4)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/walk_chain.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    so = str(tmp_path_factory.mktemp("walk_chain") / "libwalk_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, walk_cuda.LIB.src], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    for kernel in walk_cuda.LIB.launches:         # kernels and the sort
        fn = getattr(lib, launcher_of(kernel, "_host"))
        fn.argtypes = [ct.c_void_p]
        fn.restype = ct.c_int
    p, ll = ct.c_void_p, ct.c_longlong
    lib.walk_mix_host.argtypes = [p, p, p, ll, p]
    lib.walk_mix_host.restype = None
    lib.walk_args_words.restype = ct.c_int
    return lib


@pytest.fixture
def on_host(host, monkeypatch):
    """walk_pool_chain's kernel path with every launch run by the host
    build; returns the launches by kernel, and under "groups" each round's
    (n_u, Uw, lanes) as the group kernel left them."""
    calls = dict.fromkeys(walk_cuda.LIB.launches, 0)
    calls["groups"] = []
    at = {n: i for i, n in enumerate(walk_cuda.ARGS)}

    def launch(kernel, dev, args):
        assert dev.type == "cpu"
        rc = getattr(host, launcher_of(kernel, "_host"))(
            ct.addressof(args))
        assert rc == 0, kernel
        calls[kernel] += 1
        if kernel == "walk_group_kernel":
            sc = ct.cast(args[at["sc"]], ct.POINTER(ct.c_int32))
            calls["groups"].append((sc[walk_cuda.SC_NU], args[at["Uw"]],
                                    args[at["w"]]))

    monkeypatch.setattr(walk_cuda, "_launch", launch)
    monkeypatch.setattr(tss, "_walk_round",
                        lambda dev: tss._walk_round_kernels)
    return calls


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def idx(request, tiny_fm):
    """(JAX index, port index on the CPU) of the tiny fixture."""
    force = request.param
    return (jax_to_device(tiny_fm, force_dtype=force),
            to_device(convert.fmindex_from_jax_package(tiny_fm), CPU,
                      force_dtype=force))


@pytest.fixture(scope="module")
def reads():
    """(qarr, rlens, rwflat) of the first reads of the fixture."""
    queries = _queries("reads.fq", N_READS)
    qarr = np.full((len(queries), L), 4, np.uint8)
    rl = np.zeros(len(queries), np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rl[i] = len(q)
    qarr[5, 30:33] = 4                  # ambiguous chars inside a read
    return qarr, rl, tss.packed_rev_windows(torch.from_numpy(qarr))


_POOL = {}


def _pool(td, reads):
    """Round 1's LEP pool over the reads (the port's chain_scan on the
    plain round), once per index type."""
    key = str(td.dtype)
    if key not in _POOL:
        qarr, rl, _ = reads
        memo = tss.make_chain_memo(1 << 14, 8192, CHAIN_W, td.dtype, CPU)
        pool = tss.chain_scan(td, torch.from_numpy(qarr),
                              torch.from_numpy(rl), 48 * len(rl), memo,
                              W=CHAIN_W)[0]
        _POOL[key] = pool.numpy()
    return _POOL[key]


def _case(name, pool):
    """(CAPW, mh as numpy or None, segs) of one case.  Round 1 and 2 take
    the lane widths CAPW, CAPW / 2, CAPW / 4, so that on these reads a
    round runs at each (the default divisors 1, 4, 16 skip one)."""
    n_valid = int((pool[:, 6] != 0).sum())
    wide = 1 << (n_valid - 1).bit_length()
    if name == "r1":
        return wide, None, NARROW
    mh = np.random.default_rng(9).integers(1, 7, pool.shape[0])
    if name == "r2":
        return wide, mh.astype(np.int32), NARROW
    if name == "ovf":
        return n_valid // 2, None, SEGS
    return n_valid, None, SEGS                 # "tight": groups deferred


CASES = ["r1", "r2", "ovf", "tight"]
NAMES = ("death", "fk", "fl", "fs", "ovf", "calls", "n_groups")
_JAX = {}


def _jax_result(name, jd, pool, rw_j):
    """The JAX package's walk_pool_chain of one case, once per file."""
    key = (name, str(jd.dtype))
    if key not in _JAX:
        CAPW, mh, segs = _case(name, pool)
        out = jss.walk_pool_chain(jd, rw_j, L, jnp.asarray(pool), CAPW,
                                  mh=None if mh is None else jnp.asarray(mh),
                                  segs=segs)
        _JAX[key] = [np.asarray(x) for x in out]
    return _JAX[key]


def _port(td, reads, pool, name):
    CAPW, mh, segs = _case(name, pool)
    return tss.walk_pool_chain(td, reads[2], L, torch.from_numpy(pool), CAPW,
                               mh=None if mh is None else
                               torch.from_numpy(mh), segs=segs)


def _equal(got, want, where):
    for nm, g, w in zip(NAMES, got, want):
        gv = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert gv.shape == np.shape(w), f"{where}: {nm}"
        assert np.array_equal(gv.astype(np.int64),
                              np.asarray(w).astype(np.int64)), \
            f"{where}: {nm}"


@pytest.mark.parametrize("name", CASES)
def test_walk_pool_chain_host_kernels_equal_plain_and_jax(on_host, idx,
                                                          reads, name,
                                                          monkeypatch):
    """The round through the kernels' host build == the plain round ==
    the JAX package's walk_pool_chain, every output bit for bit; every
    kernel ran once a round."""
    jd, td = idx
    pool = _pool(td, reads)
    got = _port(td, reads, pool, name)
    rounds = dict(on_host)
    with monkeypatch.context() as m:
        m.setattr(tss, "_walk_round", lambda dev: tss._walk_round_plain)
        plain = _port(td, reads, pool, name)
    rw_j = jss.packed_rev_windows(jnp.asarray(reads[0]))
    want = _jax_result(name, jd, pool, rw_j)
    assert len(got) == len(plain) == len(want) == 7
    _equal(got, want, "kernels vs JAX")
    _equal(plain, want, "plain vs JAX")
    groups = rounds.pop("groups")
    # the entry kernel once a width; every other launch once a round
    entries = rounds.pop("walk_segment_entry_kernel")
    n_rounds = set(rounds.values())
    assert len(n_rounds) == 1 and n_rounds.pop() == len(groups) > 2, rounds
    assert 1 <= entries <= len(SEGS)
    widths = [w for _, _, w in groups]
    assert int(got[6]) > 0 and int(got[5]) > 0
    assert (got[0] >= -1).sum() > 0           # walks died inside the reads
    if name in ("r1", "r2"):
        assert len(set(widths)) == 3          # every segment ran
        assert not bool(got[4])
    if name == "ovf":
        assert bool(got[4])
    if name in ("ovf", "tight"):
        assert any(n_u > uw for n_u, uw, _ in groups)   # groups deferred


@pytest.mark.parametrize("name", ["r1", "r2"])
def test_captured_rounds_step_by_step(on_host, idx, reads, name):
    """ops/walk_cases (what chip_smoke.py runs on the card): the states
    RoundCapture keeps before the first round of each width, with 64
    representatives, and in the forced forms, through each kernel's host
    loop == its plain step, output by output."""
    _, td = idx
    pool = _pool(td, reads)
    with walk_cases.RoundCapture() as cap:
        want = _port(td, reads, pool, name)
    CAPW = _case(name, pool)[0]
    assert sorted(n for _, n in cap.states) == [CAPW // 4, CAPW // 2, CAPW]
    deferred = 0
    for rnd in cap.states.values():
        forms = [rnd, walk_cases.capped(rnd)]
        if int(rnd[2]["alive"][:5].sum()) == 5:
            forms.append(walk_cases.forced(rnd))
        for c in forms:
            errs = walk_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(walk_cuda.KERNELS, 0), stats
            assert stats["live"] > 0 and stats["walked"] > 0
            deferred += stats["n_u"] > stats["n_w"]
            work = walk_cases.round_work(stats, td.dtype.itemsize, 8)
            assert set(work) == set(walk_cuda.KERNELS)
            assert min(min(v) for v in work.values()) > 0
    assert deferred >= len(cap.states)
    got = _port(td, reads, pool, name)       # the capture changed nothing
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _captured(idx, reads, name):
    """The captured rounds of one case (the first of each width)."""
    _, td = idx
    pool = _pool(td, reads)
    with walk_cases.RoundCapture() as cap:
        _port(td, reads, pool, name)
    return list(cap.states.values())


def _form(rnd, form):
    n = rnd[2]["k"].shape[0]
    return {"ragged": lambda: walk_cases.narrow(rnd, n - 37),
            "pads": lambda: walk_cases.padded(rnd),
            "W5": lambda: walk_cases.width(rnd, 5)}[form]()


@pytest.mark.parametrize("form", ["ragged", "pads", "W5"])
@pytest.mark.parametrize("name", ["r1", "r2"])
def test_captured_round_forms_step_by_step(on_host, idx, reads, name, form):
    """Each kernel's host loop == its plain step on the captured rounds in
    three more forms, each also capped and forced: cut to a width that is
    no multiple of a block's lanes (the first w - 37 lanes), padded (Uw =
    w, a quarter of the lanes alive: pads past n_w are most of the
    representatives) and walked 5 chars a round."""
    forced = 0
    for rnd in _captured(idx, reads, name):
        c = _form(rnd, form)
        forms = [c, walk_cases.capped(c)]
        if int(c[2]["alive"][:5].sum()) == 5:
            forms.append(walk_cases.forced(c))
            forced += 1
        for i, c2 in enumerate(forms):
            errs = walk_cases.steps_vs_plain(c2)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(walk_cuda.KERNELS, 0), (form, stats)
            assert stats["walked"] > 0
            if i == 1:
                continue
            if form == "ragged":
                assert stats["w"] % walk_cuda.GROUP_BLOCK
                assert stats["Uw"] == stats["w"] // 2
            if form == "pads":
                assert stats["Uw"] - stats["n_w"] > 2 * stats["n_w"], stats
    assert forced > 0


@pytest.mark.parametrize("name", ["r1", "r2"])
def test_key_writes_the_plain_pads(on_host, idx, reads, name):
    """The pads (representatives past n_w: lane 0's window, k, l and s,
    not valid) come from the key kernel's host loop, every j < Uw, as
    _walk_group_plain leaves them, with the group minima reset; the group
    overwrites only the heads.  On the captured rounds, capped and
    padded."""
    for rnd in _captured(idx, reads, name):
        wide = walk_cases.padded(rnd)
        for c in (rnd, walk_cases.capped(rnd), wide):
            fm, const, st, Uw = c
            ks = walk_cases.clone_state(st)
            rd = walk_cuda.WalkRound(fm, const, ks, Uw)
            walk_cuda.key(rd)
            ps = walk_cases.clone_state(st)
            kr = tss._walk_key_plain(const, ps)
            gr = tss._walk_group_plain(ps, kr, torch.argsort(
                kr["key"], stable=True), Uw)
            n_w = int(gr["n_w"])
            assert n_w < Uw or c is not wide
            sc = rd.scratch
            for n in ("rep_rw", "rep_k", "rep_l", "rep_s", "rep_valid"):
                got, want = sc[n].to(torch.int64), gr[n].to(torch.int64)
                assert torch.equal(got[n_w:], want[n_w:]), n
                assert (got == got[0]).all(), n        # all lane 0's
            assert not sc["rep_valid"].any()
            assert bool((sc["gmin"] == torch.iinfo(sc["gmin"].dtype).max)
                        .all())


def test_forced_forms_group_as_the_plain_step_says(on_host, idx, reads):
    """The forced round's groups: lanes 0 and 1 (equal keys, different
    (k, s)) head groups of their own; lane 3 (after the dead lane 2 of the
    same (window, k, s)) heads none and takes the group before lane 2;
    lane 4 (key INT32_MAX) heads one among the dead lanes."""
    _, td = idx
    pool = _pool(td, reads)
    with walk_cases.RoundCapture(limit=1) as cap:
        _port(td, reads, pool, "r1")
    case = walk_cases.forced(next(iter(cap.states.values())))
    _, const, st, Uw = case
    kr = tss._walk_key_plain(const, st)
    order = torch.argsort(kr["key"], stable=True)
    gr = tss._walk_group_plain(st, kr, order, Uw)
    g = gr["gidx"]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0])
    assert kr["key"][0] == kr["key"][1] and g[0] != g[1]
    assert int(pos[3]) == int(pos[2]) + 1 and int(pos[4]) == int(pos[3]) + 1
    assert g[3] == g[order[pos[2] - 1]] and g[4] == g[3] + 1
    assert kr["key"][3] == kr["key"][4] == 2**31 - 1
    errs = walk_cases.steps_vs_plain(case)
    errs.pop("stats")
    assert errs == dict.fromkeys(walk_cuda.KERNELS, 0)


@pytest.mark.parametrize("es", [4, 8], ids=["int32", "int64"])
def test_round_work_counts_each_byte_once(es):
    """round_work's bytes (the kernels' bound) count distinct bytes: a dead
    lane costs the key kernel its alive, rid, i and outputs, and no k or
    s; a lane before position 0 reads no window; a pad (a representative
    past n_w) costs the key kernel its five outputs and the group nothing,
    a walked representative the group its five outputs, its l and its
    minimum; a lane the apply leaves
    costs alive and group index; a walked lane adds its l, i and mh, not
    its group's chain, whose s words up to the last one tested and whose
    kept k and l columns count once however many lanes read them; a death
    adds its slot and pool row, and its own k and s only at its first
    step; a survivor its new state, and no k, s or slot read."""
    base = dict(w=1024, Uw=512, live=600, windows=900, compared=700,
                members=600, n_u=300, n_w=300, walked=500, died=200,
                died_first=50, through=300, cs_words=1800, kept_cols=400)

    def delta(kernel, **more):
        st = dict(base)
        for n, d in more.items():
            st[n] += d
        return walk_cases.round_work(st, es, 8)[kernel][0] - \
            walk_cases.round_work(base, es, 8)[kernel][0]

    assert delta("walk_key_kernel", w=1) == 1 + 4 + 4 + 8 + 4
    assert delta("walk_key_kernel", w=1, windows=1) == 1 + 4 + 4 + 8 + 4 + 8
    assert delta("walk_key_kernel", live=1) == 2 * es
    assert delta("walk_group_kernel", w=1) == 8 + 1 + 4
    assert delta("walk_group_kernel", compared=1) == 8 + 2 * es
    assert delta("walk_group_kernel", members=1) == es
    rep = 8 + 3 * es + 1
    assert delta("walk_key_kernel", Uw=1) == es + rep
    assert delta("walk_key_kernel", n_w=1) == -rep
    assert delta("walk_group_kernel", Uw=1) == 0
    assert delta("walk_group_kernel", n_w=1) == rep + 2 * es
    assert delta("walk_apply_kernel", w=1) == 1
    assert delta("walk_apply_kernel", live=1) == 4
    assert delta("walk_apply_kernel", walked=1, through=1) == \
        (2 * es + 4) + (3 * es + 4)
    assert delta("walk_apply_kernel", walked=1, died=1) == \
        (2 * es + 4) + (4 + 4 + 3 * es + 1)
    assert delta("walk_apply_kernel", walked=1, died=1, died_first=1) == \
        (2 * es + 4) + (4 + 4 + 3 * es + 1) + 2 * es
    assert delta("walk_apply_kernel", n_w=1) == 4 + es
    assert delta("walk_apply_kernel", cs_words=1) == es
    assert delta("walk_apply_kernel", kept_cols=1) == 2 * es


def test_window_before_the_read_is_the_args_word(host, idx):
    """A lane at a position below 0 takes the Args word all4 as its window
    (walk_pool_chain passes the plain step's _ALL4), and every other lane
    its window word; with _ALL4 the key kernel equals the plain step."""
    _, td = idx
    n, GP = 16, 4
    dt, i32 = td.dtype, torch.int32
    g = torch.Generator().manual_seed(3)
    st = dict(k=torch.randint(1, 1000, (n,), generator=g).to(dt),
              l=torch.zeros(n, dtype=dt),
              s=torch.randint(1, 60, (n,), generator=g).to(dt),
              mh=torch.ones(n, dtype=dt),
              rid=torch.randint(0, 4, (n,), generator=g).to(i32),
              i=torch.arange(n, dtype=i32) * 9 - 40,
              slot=torch.arange(n, dtype=i32),
              alive=torch.ones(n, dtype=torch.bool),
              death=torch.zeros(GP, dtype=i32), fk=torch.zeros(GP, dtype=dt),
              fl=torch.zeros(GP, dtype=dt), fs=torch.zeros(GP, dtype=dt),
              ctr=torch.zeros(2, dtype=i32))
    c = dict(rwflat=torch.randint(0, 1 << 24, (4 * L,), generator=g),
             L=L, W=8)
    before = st["i"] < 0
    assert 0 < int(before.sum()) < n
    for all4 in (tss._ALL4, 0x123456):
        rd = walk_cuda.WalkRound(td, dict(c, all4=all4), st, 4)
        assert host.walk_key_host(ct.addressof(rd.args)) == 0
        rw = rd.scratch["rw"]
        assert bool((rw[before] == all4).all())
        want = tss._walk_key_plain(c, st)
        assert torch.equal(rw[~before], want["rw"][~before])
        if all4 == tss._ALL4:
            assert torch.equal(rw, want["rw"])
            assert torch.equal(rd.scratch["key"], want["key"])


def test_mix_native_equals_emulation(host):
    """walk_mix in native uint32 == the plain key step's int64 emulation
    (bits.mul32) == walk_cases.mix_np, on random 24-bit windows and random
    k and s (sign-extended int32 and full int64)."""
    rng = np.random.default_rng(5)
    n = 4096
    rw = rng.integers(0, 1 << 24, n, dtype=np.int64)
    k64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    s64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    k32 = rng.integers(-2**31, 2**31, n).astype(np.int32).astype(np.int64)
    for k, s in ((k64, s64), (k32, s64[::-1].copy()), (k32, k32)):
        out = np.empty(n, np.int64)
        host.walk_mix_host(rw.ctypes.data, k.ctypes.data, s.ctypes.data, n,
                           out.ctypes.data)
        assert np.array_equal(out, walk_cases.mix_np(rw, k, s))
        assert out.min() >= 0 and out.max() < 2**32
        st = dict(k=torch.from_numpy(k), s=torch.from_numpy(s),
                  i=torch.zeros(n, dtype=torch.int32),
                  rid=torch.arange(n, dtype=torch.int32),
                  alive=torch.ones(n, dtype=torch.bool))
        kr = tss._walk_key_plain(dict(L=1, rwflat=torch.from_numpy(rw)), st)
        assert np.array_equal(kr["key"].numpy(), out >> 1)


def test_callers_pool_is_not_written(on_host, idx, reads):
    """The kernel path writes copies of the pool's columns: the caller's
    pool is unchanged, and a second call gives the same results."""
    _, td = idx
    pool = torch.from_numpy(_pool(td, reads).copy())
    before = pool.clone()
    a = tss.walk_pool_chain(td, reads[2], L, pool, 4096)
    assert torch.equal(pool, before)
    assert (a[0] >= -1).sum() > 0 and not torch.equal(a[1], pool[:, 0])
    b = tss.walk_pool_chain(td, reads[2], L, pool, 4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_args_layout_matches_source(host):
    """ops/walk_cuda.ARGS names struct Args's fields in order, one 64-bit
    word each."""
    src = open(walk_cuda.LIB.src).read()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for decl in body.split(";") if decl.strip()
              for f in decl.replace("long long", "").split(",")]
    assert tuple(fields) == walk_cuda.ARGS
    assert host.walk_args_words() == len(walk_cuda.ARGS)


def test_block_sizes_match_source():
    """ops/walk_cuda's GROUP_BLOCK and APPLY_BLOCK are the source's
    kGroupBlock and kApplyBlock: WalkRound sizes the group's look-back
    status words, one a group block, by GROUP_BLOCK, and too few would be
    overrun without an error."""
    src = open(walk_cuda.LIB.src).read()
    for name, value in (("kGroupBlock", walk_cuda.GROUP_BLOCK),
                        ("kApplyBlock", walk_cuda.APPLY_BLOCK)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


@pytest.mark.parametrize("bad", ["W=0", "W=11", "Uw=0", "n_rw=0"])
def test_host_entries_refuse_bad_sizes(host, bad):
    """The entries refuse a window outside [1, 10], no representative and
    an empty window array (the launchers return cudaErrorInvalidValue for
    the same)."""
    args = (ct.c_longlong * len(walk_cuda.ARGS))()
    at = {n: i for i, n in enumerate(walk_cuda.ARGS)}
    for n, v in (("w", 8), ("Uw", 4), ("W", 8), ("n_rw", 16)):
        args[at[n]] = v
    k, v = bad.split("=")
    args[at[k]] = int(v)
    for kernel in walk_cuda.KERNELS:
        assert getattr(host, kernel.replace("_kernel", "_host"))(
            ct.addressof(args)) == -1


def test_round_dispatch_and_launch_device():
    """walk_pool_chain takes the plain round for CPU tensors only and the
    kernels for any other device; a launch on a non-CUDA device raises;
    no ``try`` and no environment knob decides the path."""
    assert tss._walk_round(CPU) is tss._walk_round_plain
    for dev in ("meta", "cuda"):
        assert tss._walk_round(torch.device(dev)) is tss._walk_round_kernels
    args = (ct.c_longlong * len(walk_cuda.ARGS))()
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA"):
            walk_cuda._launch("walk_key_kernel", torch.device(dev), args)
    src = inspect.getsource(walk_cuda)
    nodes = list(ast.walk(ast.parse(src)))
    names = [n.id if isinstance(n, ast.Name) else n.attr for n in nodes
             if isinstance(n, (ast.Name, ast.Attribute))]
    assert "environ" not in src
    assert not [x for x in names if x.endswith("_plain")]
    assert not any(isinstance(n, ast.Try) for n in nodes)
    for fn in (tss.walk_pool_chain, tss._walk_round,
               tss._walk_round_kernels):
        t = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(t))
        assert "environ" not in inspect.getsource(fn)
    rt = ast.parse(textwrap.dedent(inspect.getsource(tss._walk_round)))
    ifs = [n for n in ast.walk(rt) if isinstance(n, ast.If)]
    assert len(ifs) == 1 and ast.unparse(ifs[0].test) == \
        "dev.type == 'cpu'"
    assert "_walk_round_plain" in ast.unparse(ifs[0].body[0])


def test_walk_round_checks_inputs(idx):
    """WalkRound refuses a dtype, shape or device the kernels do not take
    before anything launches."""
    _, td = idx
    n, Uw, GP = 8, 4, 16
    dt = td.dtype
    i32 = torch.int32
    st = dict(k=torch.zeros(n, dtype=dt), l=torch.zeros(n, dtype=dt),
              s=torch.zeros(n, dtype=dt), mh=torch.ones(n, dtype=dt),
              rid=torch.zeros(n, dtype=i32), i=torch.zeros(n, dtype=i32),
              slot=torch.zeros(n, dtype=i32),
              alive=torch.zeros(n, dtype=torch.bool),
              death=torch.zeros(GP, dtype=i32), fk=torch.zeros(GP, dtype=dt),
              fl=torch.zeros(GP, dtype=dt), fs=torch.zeros(GP, dtype=dt),
              ctr=torch.zeros(2, dtype=i32))
    c = dict(rwflat=torch.zeros(4 * L, dtype=torch.int64), L=L, W=8,
             all4=tss._ALL4)
    rd = walk_cuda.WalkRound(td, c, st, Uw)
    # the round holds its sort's storage and its walk, so that a round's
    # launches allocate nothing; the sort takes the keys' 31 bits
    at = {n_: i for i, n_ in enumerate(walk_cuda.ARGS)}
    assert rd.args[at["key_bits"]] == walk_cuda.KEY_BITS == 31
    assert [tuple(x.shape) for x in rd.walk] == [(Uw, 8)] * 3 + [(Uw,)]
    assert rd.args[at["cs"]] == rd.walk[2].data_ptr()
    other = torch.int32 if dt == torch.int64 else torch.int64
    for key, bad in (("k", torch.zeros(n, dtype=other)),
                     ("alive", torch.zeros(n, dtype=torch.uint8)),
                     ("i", torch.zeros(n + 1, dtype=i32)),
                     ("mh", torch.zeros(n, dtype=other)),
                     ("fk", torch.zeros((GP, 2), dtype=dt)[:, 0]),
                     ("death", torch.zeros(GP, dtype=torch.int64)),
                     ("ctr", torch.zeros(3, dtype=i32)),
                     ("l", torch.zeros(n, dtype=dt, device="meta"))):
        with pytest.raises((TypeError, ValueError)):
            walk_cuda.WalkRound(td, c, dict(st, **{key: bad}), Uw)
    for kw in (dict(W=0), dict(W=11),
               dict(rwflat=torch.zeros(4 * L, dtype=torch.int32)),
               dict(rwflat=torch.zeros(0, dtype=torch.int64))):
        with pytest.raises((TypeError, ValueError)):
            walk_cuda.WalkRound(td, dict(c, **kw), st, Uw)
    with pytest.raises(ValueError):
        walk_cuda.WalkRound(td, c, st, 0)
