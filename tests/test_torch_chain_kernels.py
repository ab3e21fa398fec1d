"""chain_scan's round body, the kernels of compseed_tpu_torch/csrc/
chain_scan.cu, held on the CPU: the source compiled with g++ into its host
loops (chain_*_host), run in place of the launches through chain_scan's
own kernel path (a test-only patch of ``chain_cuda._launch`` and
``seedscan._chain_round``), against the plain round
(``seedscan._chain_round_plain``) and the JAX package's chain_scan, bit
for bit, at int32 and int64 index types over the ``tiny`` fixture index:
pool, n_rows, ovf, fq, fc, the memo (tbl, cst, cur) and, with
report_rounds, the round count and the live-lane histogram.  Modes:
round-1 LEP; round-2 tasks (min_hits, pivots0, rids, record_lane_index,
active, advance=False); round 3; a lossy memo (slot evictions, a full
store) with a rep cap below the group count; COMPSEED_CHAIN_SEGS set to
"" and to "4,16" over 512 reads; report_rounds.

Captured rounds step by step (ops/chain_cases), each kernel's host loop
against its plain step: as captured, lossy, padded (pads past n_w, which
the probe writes, are most of the representatives) and at a width that
is no multiple of a block's lanes; two and three consecutive rounds of
one segment on one set of launch arguments (the probe reads each lane's
read id from the state's lane_rid), and a segment compacted as
chain_scan compacts it, which carries lane_rid beside lane0 (a lane_rid
kept from before the compaction is shown to give other windows).

Also: the native slot hash against the int64 emulation (bits.mul64) on
random 64-bit patterns; the caller's memo is never written; the Args
layout the launchers pass (and another build's, a prefix of it); the
block sizes; the dispatch (the plain round only for CPU
tensors, the kernels or an error otherwise).  The kernels themselves are
held to the plain round on the card in tests/test_torch_cuda.py and
chip_smoke.py."""

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
from compseed_tpu_torch.ops import chain_cases, chain_cuda
from compseed_tpu_torch.ops.cuda_lib import launcher_of
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.device_index import to_device

from tests.test_torch_seeder import _queries

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
W = 5
L = 128
N_WIDE = 512                # lanes of the segmented cases: widths 512, 256


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/chain_scan.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    so = str(tmp_path_factory.mktemp("chain_scan") / "libchain_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, chain_cuda.LIB.src], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    for kernel in chain_cuda.LIB.launches:         # kernels and the sort
        fn = getattr(lib, launcher_of(kernel, "_host"))
        fn.argtypes = [ct.c_void_p]
        fn.restype = ct.c_int
    p, ll = ct.c_void_p, ct.c_longlong
    lib.chain_slot_hash_host.argtypes = [p, p, p, ll, ll, p]
    lib.chain_slot_hash_host.restype = None
    lib.chain_args_words.restype = ct.c_int
    return lib


@pytest.fixture
def on_host(host, monkeypatch):
    """chain_scan's kernel path with every launch run by the host build;
    returns the launches by kernel, and under "groups" each round's
    (n_u, Uw, w) as the group kernel left them."""
    calls = dict.fromkeys(chain_cuda.LIB.launches, 0)
    calls["groups"] = []
    at = {n: i for i, n in enumerate(chain_cuda.ARGS)}

    def launch(kernel, dev, args):
        assert dev.type == "cpu"
        rc = getattr(host, launcher_of(kernel, "_host"))(
            ct.addressof(args))
        assert rc == 0, kernel
        calls[kernel] += 1
        if kernel == "chain_group_kernel":
            sc = ct.cast(args[at["sc"]], ct.POINTER(ct.c_int32))
            calls["groups"].append((sc[3], args[at["Uw"]], args[at["w"]]))

    monkeypatch.setattr(chain_cuda, "_launch", launch)
    monkeypatch.setattr(tss, "_chain_round",
                        lambda dev: tss._chain_round_kernels)
    return calls


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def idx(request, tiny_fm):
    """(JAX index, port index on the CPU) of the tiny fixture."""
    force = request.param
    return (jax_to_device(tiny_fm, force_dtype=force),
            to_device(convert.fmindex_from_jax_package(tiny_fm), CPU,
                      force_dtype=force))


def _reads(n, extra=()):
    queries = _queries("reads.fq", n) + list(extra)
    R = len(queries)
    qarr = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rl[i] = len(q)
    return qarr, rl


def _case(name):
    """(qarr, rlens, GP, (H, M), chain_scan keywords as numpy, env) of
    one case."""
    rng = np.random.default_rng(17)
    if name in ("lep", "segs_off"):
        # round 1 over N_WIDE reads: the loop narrows to 256 lanes, or not
        qarr, rl = _reads(N_WIDE)
        kw = dict(report_rounds=True) if name == "lep" else {}
        segs = "4,16" if name == "lep" else ""
        return qarr, rl, 48 * N_WIDE, (4096, 2048), kw, \
            {"COMPSEED_CHAIN_SEGS": segs}
    if name == "r3":
        qarr, rl = _reads(48)
        return qarr, rl, 48 * 48, (256, 128), \
            dict(mode="r3", min_len=20, max_intv=20), {}
    if name == "r2":
        qarr, rl = _reads(64)
        n = N_WIDE
        rids = rng.integers(0, 64, n).astype(np.int32)
        kw = dict(min_hits=rng.integers(1, 6, n).astype(np.int32),
                  pivots0=(rng.random(n) * rl[rids]).astype(np.int32),
                  rids=rids, record_lane_index=True,
                  active=rng.random(n) < 0.9, advance=False,
                  u_cap=N_WIDE // 4)
        return qarr, rl, 32 * n, (1024, 512), kw, {}
    # a lossy memo (16 store rows, 32 slots) and a rep cap of 8
    qarr, rl = _reads(32)
    qarr, rl = _reads(32, [qarr[2, :rl[2]].copy(), qarr[3, 7:80].copy()])
    qarr[0, 10:12] = 4
    return qarr, rl, 48 * len(rl), (32, 16), dict(u_cap=8), {}


CASES = ["lep", "segs_off", "r2", "r3", "lossy"]
_JAX = {}


def _jax_result(name, jd, case):
    """The JAX package's chain_scan of one case, once per file."""
    key = (name, str(jd.dtype))
    if key not in _JAX:
        qarr, rl, GP, (H, M), kw, _ = case
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        out = jss.chain_scan(jd, jnp.asarray(qarr), jnp.asarray(rl), GP,
                             jss.make_chain_memo(H, M, W, jd.dtype), W=W,
                             **jkw)
        _JAX[key] = [np.asarray(x) if not isinstance(x, dict) else
                     {k: np.asarray(v) for k, v in x.items()} for x in out]
    return _JAX[key]


def _port(td, case):
    qarr, rl, GP, (H, M), kw, _ = case
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    memo = tss.make_chain_memo(H, M, W, td.dtype, CPU)
    return tss.chain_scan(td, torch.from_numpy(qarr), torch.from_numpy(rl),
                          GP, memo, W=W, **tkw)


NAMES = ("pool", "n_rows", "ovf", "fq", "fc", "memo", "rounds", "alive_hist")


def _equal(got, want, where):
    for nm, g, w in zip(NAMES, got, want):
        if isinstance(w, dict):
            assert set(g) == set(w), where
            for k in w:
                gk = g[k].numpy() if isinstance(g[k], torch.Tensor) \
                    else g[k]
                assert np.array_equal(gk.astype(np.int64),
                                      w[k].astype(np.int64)), \
                    f"{where}: memo {k}"
            continue
        gv = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert gv.shape == np.shape(w), f"{where}: {nm}"
        assert np.array_equal(gv.astype(np.int64),
                              np.asarray(w).astype(np.int64)), \
            f"{where}: {nm}"


@pytest.mark.parametrize("name", CASES)
def test_chain_scan_host_kernels_equal_plain_and_jax(on_host, idx, name,
                                                     monkeypatch):
    """The round through the kernels' host build == the plain round ==
    the JAX package's chain_scan, every output bit for bit; every kernel
    ran once a round."""
    jd, td = idx
    case = _case(name)
    for k, v in case[5].items():
        monkeypatch.setenv(k, v)
    got = _port(td, case)
    rounds = dict(on_host)
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round", lambda dev: tss._chain_round_plain)
        plain = _port(td, case)
    want = _jax_result(name, jd, case)
    assert len(got) == len(plain) == len(want)
    _equal(got, want, "kernels vs JAX")
    _equal(plain, want, "plain vs JAX")
    groups = rounds.pop("groups")
    # the entry kernel once a segment; every other launch once a round
    entries = rounds.pop("chain_segment_entry_kernel")
    n_rounds = set(rounds.values())
    assert len(n_rounds) == 1 and n_rounds.pop() == len(groups) > 2, rounds
    assert entries == (2 if name in ("lep", "r2") else 1)
    n_pool, cur, M = int(got[1]), int(got[5]["cur"]), case[3][1]
    assert n_pool > 0 and cur > 0
    widths = {w for _, _, w in groups}
    if name == "lep":
        assert int(got[6]) == len(groups)
    if name in ("lep", "r2"):
        assert len(widths) == 2       # the loop narrowed to 256 lanes
    if name == "segs_off":
        assert len(widths) == 1
    if name == "lossy":
        assert cur == M                               # the store filled
        assert any(n_u > uw for n_u, uw, _ in groups)  # groups deferred


@pytest.mark.parametrize("name", ["lep", "r2"])
def test_captured_rounds_step_by_step(on_host, idx, name, monkeypatch):
    """ops/chain_cases (what chip_smoke.py runs on the card): the states
    RoundCapture keeps before the first round of each width, and their
    lossy form (64 table slots, a store with 8 free rows), through each
    kernel's host loop == its plain step, output by output."""
    _, td = idx
    case = _case(name)
    for k, v in case[5].items():
        monkeypatch.setenv(k, v)
    with chain_cases.RoundCapture() as cap:
        want = _port(td, case)
    assert sorted(w for _, w in cap.states) == [256, N_WIDE]
    for rnd in cap.states.values():
        for c in (rnd, chain_cases.lossy(rnd, H=64, room=8)):
            errs = chain_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), stats
            assert stats["live"] > 0 and stats["applied"] > 0
            work = chain_cases.round_work(stats, td.dtype.itemsize, W)
            assert set(work) == set(chain_cuda.KERNELS)
            assert min(min(v) for v in work.values()) > 0
        assert stats["H"] == 64 and stats["stored"] <= 8
    got = _port(td, case)                   # the capture changed nothing
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(g, w)


_ROUNDS = {}


def _captured(idx, name, monkeypatch):
    """The rounds RoundCapture keeps from one case's kernel path, once
    per file (CPU tensors; the host loops must be patched in)."""
    _, td = idx
    key = (name, str(td.dtype))
    if key not in _ROUNDS:
        case = _case(name)
        with monkeypatch.context() as m:
            for k, v in case[5].items():
                m.setenv(k, v)
            with chain_cases.RoundCapture() as cap:
                _port(td, case)
        _ROUNDS[key] = list(cap.states.values())
    return _ROUNDS[key]


@pytest.mark.parametrize("name", ["lep", "r2"])
def test_probe_writes_the_plain_pads(on_host, idx, name, monkeypatch):
    """The pads (representatives past n_w: lane 0's window, k, l, s and
    slot, not valid) come from the probe's host loop, every j < Uw, as
    _chain_group_plain leaves them; the group overwrites only the heads.
    On the captured rounds, their lossy form and their padded form (Uw =
    w, a quarter of the lanes alive: pads are most of the
    representatives)."""
    for rnd in _captured(idx, name, monkeypatch):
        w = rnd[3]
        wide = chain_cases.padded(rnd)
        for c in (rnd, chain_cases.lossy(rnd, H=64, room=8), wide):
            fm, const, st, w, Uw = c
            ks = chain_cases.clone_state(st)
            rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
            chain_cuda.probe(rd)
            ps = chain_cases.clone_state(st)
            pr = tss._chain_probe_plain(fm, const, ps)
            gr = tss._chain_group_plain(ps, pr, torch.argsort(
                pr["key"], stable=True), Uw)
            n_w = int(gr["n_w"])
            assert n_w < Uw or c is not wide
            sc = rd.scratch
            for n in ("rep_wv", "rep_k", "rep_l", "rep_s", "rep_valid",
                      "rep_slot"):
                got, want = sc[n].to(torch.int64), gr[n].to(torch.int64)
                assert torch.equal(got[n_w:], want[n_w:]), n
                assert (got == got[0]).all(), n        # all lane 0's
            assert not sc["rep_valid"].any()


@pytest.mark.parametrize("form", ["pads", "ragged"])
@pytest.mark.parametrize("name", ["lep", "r2"])
def test_captured_round_forms_step_by_step(on_host, idx, name, form,
                                           monkeypatch):
    """Each kernel's host loop == its plain step on the captured rounds
    in two more forms: padded (Uw = w, a quarter of the lanes alive: pads
    past n_w are most of the representatives) and a width that is no
    multiple of a block's lanes (the first w - 37 lanes), also each
    lossy."""
    for rnd in _captured(idx, name, monkeypatch):
        w = rnd[3]
        c = chain_cases.padded(rnd) if form == "pads" else \
            chain_cases.narrow(rnd, w - 37)
        for c in (c, chain_cases.lossy(c, H=64, room=8)):
            errs = chain_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), stats
            assert stats["applied"] > 0
            if form == "pads":
                assert stats["Uw"] - stats["n_w"] > 2 * stats["n_w"], stats
            else:
                assert stats["w"] % 256 and stats["Uw"] == stats["w"] // 2


def _segment_rounds(case, rounds):
    """``rounds`` consecutive rounds of one segment from the case's state
    on one ChainRound (chain_cases.round_vs_plain), each kernel's host
    loop held to its plain step round by round (the plain probe reads
    lane_rid0[lane0], the kernel the state's lane_rid), the read-id
    array holding lane_rid0[lane0] for every lane after each round.
    Returns (the ChainRound, the kernels' state, the lanes applied in
    all)."""
    fm, const, st, w, Uw = case
    ks, ps = chain_cases.clone_state(st), chain_cases.clone_state(st)
    rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
    applied = 0
    for r in range(rounds):
        errs, ps = chain_cases.round_vs_plain(fm, const, rd, ks, ps, w, Uw)
        stats = errs.pop("stats")
        assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), (r, stats)
        assert torch.equal(ks["lane_rid"], const["lane_rid0"][
            ks["lane0"].to(torch.int64)])
        applied += stats["applied"]
    return rd, ks, applied


@pytest.mark.parametrize("rounds", [2, 3])
@pytest.mark.parametrize("form", ["captured", "lossy", "padded"])
@pytest.mark.parametrize("name", ["lep", "r2"])
def test_probe_rid_cache_across_rounds(on_host, idx, name, form, rounds,
                                       monkeypatch):
    """Consecutive rounds of one segment through the host loops on one set
    of Args words (every probe reads the read ids the segment's set-up
    left in lane_rid) == the plain round, round by round and kernel by
    kernel (_segment_rounds), on the captured rounds as they are, lossy
    and padded."""
    for rnd in _captured(idx, name, monkeypatch):
        c = {"captured": rnd, "lossy": chain_cases.lossy(rnd, H=64, room=8),
             "padded": chain_cases.padded(rnd)}[form]
        assert _segment_rounds(c, rounds)[2] > 0


@pytest.mark.parametrize("name", ["lep", "r2"])
def test_probe_rid_cache_refilled_after_compaction(on_host, idx, name,
                                                   monkeypatch):
    """A segment compacted by chain_scan's own step (seedscan.
    _compact_lanes: the live lanes first, in order, lane0 a permutation
    of a subset and lane_rid moved beside it), once half its lanes or
    fewer live, on fresh launch arguments: two rounds through the host
    loops == the plain round.  The same compacted round probed with the
    wider segment's lane_rid kept (not compacted) reads other read ids
    and other windows than the plain probe: a stale read-id array shows
    here."""
    for rnd in _captured(idx, name, monkeypatch):
        fm, const, st, w, Uw = rnd
        ks = chain_cases.clone_state(st)
        rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
        ps = chain_cases.clone_state(st)
        for _ in range(3 * L + 16):        # chain_scan's round cap
            errs, ps = chain_cases.round_vs_plain(fm, const, rd, ks, ps, w,
                                                  Uw)
            errs.pop("stats")
            assert not any(errs.values())
            if 2 * int(ks["alive"].sum()) <= w:
                break
        lalive = ks["alive"]
        n_alive = int(lalive.sum())
        nxtw = max(n_alive + 5, 8)
        assert 0 < n_alive < nxtw < w
        st2 = dict(ks)
        tss._compact_lanes(st2, tss.CHAIN_LANE_KEYS, nxtw,
                           dict(lane_rid=const["lane_rid0"][:1]))
        moved = st2["lane0"][:n_alive] != torch.arange(n_alive)
        assert moved.any()                  # lane0 is no longer the identity
        _segment_rounds((fm, const, st2, nxtw, min(Uw, nxtw)), 2)
        # the wider segment's read ids kept across the compaction
        st3 = chain_cases.clone_state(st2)
        st3["lane_rid"] = ks["lane_rid"][:nxtw].clone()
        assert not torch.equal(st3["lane_rid"], st2["lane_rid"])
        stale = chain_cuda.ChainRound(fm, const, st3, nxtw, min(Uw, nxtw))
        chain_cuda.probe(stale)
        pr = tss._chain_probe_plain(fm, const, chain_cases.clone_state(st2))
        assert chain_cases.max_err(stale.scratch["p_wv"], pr["wv"]) > 0


@pytest.mark.parametrize("es", [4, 8], ids=["int32", "int64"])
def test_round_work_counts_each_byte_once(es):
    """round_work's bytes (the kernels' bound) count distinct bytes: a
    lane the apply leaves costs its alive, hit and group index; a hit on
    a store row another hit read adds no store row; a lane that applies
    its group's walk adds no walk; the probe reads a lane's read id (not
    lane0 and lane_rid0), no pivot or k; the group reads window, l and s
    for misses only."""
    base = dict(w=1024, Uw=256, live=600, hits=300, misses=300,
                hit_rows=100, applied=500, lived=300, respawned=100,
                pushes=900, n_u=200, n_w=200, stored=150, tbl_rows=120,
                advance=True)

    def delta(kernel, **more):
        st = dict(base)
        for n, d in more.items():
            st[n] += d
        return chain_cases.round_work(st, es, W)[kernel][0] - \
            chain_cases.round_work(base, es, W)[kernel][0]

    lane_in = 3 * es + 6 * 4 + es           # k, l, s, pos, pivot, 4 consts
    assert delta("chain_apply_kernel", w=1) == 1 + 1 + 4
    shared = delta("chain_apply_kernel", hits=1, applied=1, lived=1)
    assert shared == lane_in + (4 + es + 4) + (3 * es + 4)
    assert delta("chain_apply_kernel", hits=1, hit_rows=1, applied=1,
                 lived=1) == shared + 3 * W * es
    assert delta("chain_apply_kernel", applied=1, lived=1) == \
        lane_in + 3 * es + 4
    assert delta("chain_probe_kernel", w=1) == \
        (4 + 4 + 8 + 2 * es + 1) + (8 + 4 + 1 + 4 + es + 4 + 4)
    assert delta("chain_probe_kernel", live=1) == 8 * es
    assert delta("chain_group_kernel", w=1) == 8 + 4 + 4
    assert delta("chain_group_kernel", live=1, hits=1) == 0
    assert delta("chain_group_kernel", live=1, misses=1) == 8 + 2 * es
    rep = 8 + 3 * es + 1 + 4                # a representative's six words
    assert delta("chain_probe_kernel", Uw=1) == rep        # one more pad
    assert delta("chain_group_kernel", Uw=1) == 0
    assert delta("chain_probe_kernel", n_w=1) == -rep      # a head, not a pad
    assert delta("chain_group_kernel", n_w=1) == es + 4 + rep


def test_slot_hash_native_equals_emulation(host):
    """slot_hash in native uint64 == _slot_hash's int64 emulation of the
    JAX package's uint64 arithmetic (bits.mul64), on random 64-bit
    patterns for l and s (sign-extended int32 and full int64) and every
    30-bit window."""
    rng = np.random.default_rng(5)
    n = 4096
    wv = rng.integers(0, 1 << 30, n, dtype=np.int64)
    l64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    s64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    l32 = rng.integers(-2**31, 2**31, n).astype(np.int32).astype(np.int64)
    for H in (1 << 4, 1 << 22, 1 << 30):
        for l, s in ((l64, s64), (l32, s64[::-1].copy()), (l32, l32)):
            out = np.empty(n, np.int64)
            host.chain_slot_hash_host(wv.ctypes.data, l.ctypes.data,
                                      s.ctypes.data, n, H, out.ctypes.data)
            want = tss._slot_hash(torch.from_numpy(wv), torch.from_numpy(l),
                                  torch.from_numpy(s), H).numpy()
            assert np.array_equal(out, want)
            assert out.min() >= 0 and out.max() < H


def test_callers_memo_is_not_written(on_host, idx):
    """The kernel path copies the memo once per call and updates the copy:
    the caller's tensors are unchanged, and a second call on the same memo
    gives the same results."""
    _, td = idx
    qarr, rl = _reads(24)
    memo = tss.make_chain_memo(256, 128, W, td.dtype, CPU)
    memo["tbl"][3] = 7
    before = {k: v.clone() for k, v in memo.items()}
    args = (td, torch.from_numpy(qarr), torch.from_numpy(rl), 24 * 48, memo)
    a = tss.chain_scan(*args, W=W)
    for k in memo:
        assert torch.equal(memo[k], before[k]), k
    assert int(a[5]["cur"]) > 0 and a[5]["tbl"] is not memo["tbl"]
    b = tss.chain_scan(*args, W=W)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    for k in tss.MEMO_KEYS:
        assert torch.equal(a[5][k], b[5][k])


def test_args_layout_matches_source(host):
    """ops/chain_cuda.ARGS names struct Args's fields in order, one
    64-bit word each."""
    src = open(chain_cuda.LIB.src).read()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for decl in body.split(";") if decl.strip()
              for f in decl.replace("long long", "").split(",")]
    assert tuple(fields) == chain_cuda.ARGS
    assert host.chain_args_words() == len(chain_cuda.ARGS)
    # the lanes' read ids, then the sort's and the loop's words, then the
    # loop word, then the segment entry's source words come after the
    # earlier words, so that an earlier build of the source reads a prefix
    # of the words
    at = chain_cuda.ARGS.index("lane_rid")
    assert chain_cuda.ARGS[at - 1] == "idx64"
    assert chain_cuda.ARGS[at + 1:] == (
        "sorted_key", "iota", "sort_tmp", "sort_bytes", "key_bits", "rnd",
        "live_in", "nxtw", "rcap", "hist", "cond", "go", "loop") + tuple(
        f"src_{n}" for n in chain_cuda.LANE_KEYS) + (
        "src_w", "lb_entry")


class _Fn:
    """A stand-in for a ctypes function: takes argtypes, returns n."""

    def __init__(self, n=0):
        self.n = n

    def __call__(self, *a):
        return self.n


@pytest.mark.parametrize("words,prefix,ok", [
    (len(chain_cuda.ARGS), False, True),
    (len(chain_cuda.ARGS) - 1, False, False),
    (len(chain_cuda.ARGS) - 1, True, True),
    (len(chain_cuda.ARGS), True, True),
    (len(chain_cuda.ARGS) + 1, True, False),
    (0, True, False)])
def test_bind_checks_args_words(words, prefix, ok):
    """chain_cuda._bind takes a source whose struct Args has the port's
    words; with ``prefix`` (another build, such as the parent's, whose
    launchers read only their own words) also one with fewer, never
    more."""
    lib = type("Lib", (), {})()
    for kernel in chain_cuda.LIB.launches:
        setattr(lib, launcher_of(kernel), _Fn())
    for name in ("streams", "begin", "nest", "body", "end", "launch",
                 "nodes", "close"):
        setattr(lib, f"chain_graph_{name}", _Fn())
    lib.chain_sort_bytes = _Fn()
    lib.chain_args_words = _Fn(words)
    if ok:
        chain_cuda._bind(lib, prefix)
    else:
        with pytest.raises(RuntimeError, match="words"):
            chain_cuda._bind(lib, prefix)


def test_block_sizes_match_source():
    """ops/chain_cuda's PROBE_BLOCK, BLOCK and APPLY_BLOCK are the
    source's kProbeBlock, kGroupBlock and kApplyBlock: ChainRound sizes
    the look-back status words, one a block of the kernel with the most
    blocks, by APPLY_BLOCK, which is no larger than the others."""
    src = open(chain_cuda.LIB.src).read()
    for name, value in (("kProbeBlock", chain_cuda.PROBE_BLOCK),
                        ("kGroupBlock", chain_cuda.BLOCK),
                        ("kApplyBlock", chain_cuda.APPLY_BLOCK)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert chain_cuda.APPLY_BLOCK <= chain_cuda.BLOCK


@pytest.mark.parametrize("bad", ["W=0", "W=11", "Uw=0", "Uw>w"])
def test_host_entries_refuse_bad_sizes(host, bad):
    """The entries refuse a window outside [1, 10] and a rep cap outside
    [1, w] (the launchers return cudaErrorInvalidValue for the same)."""
    args = (ct.c_longlong * len(chain_cuda.ARGS))()
    at = {n: i for i, n in enumerate(chain_cuda.ARGS)}
    args[at["w"]], args[at["Uw"]], args[at["W"]] = 8, 4, 5
    k, v = {"W=0": ("W", 0), "W=11": ("W", 11), "Uw=0": ("Uw", 0),
            "Uw>w": ("Uw", 9)}[bad]
    args[at[k]] = v
    for kernel in chain_cuda.KERNELS:
        assert getattr(host, kernel.replace("_kernel", "_host"))(
            ct.addressof(args)) == -1


def test_round_dispatch_and_launch_device():
    """chain_scan takes the plain round for CPU tensors only and the
    kernels for any other device; a launch on a non-CUDA device raises;
    no ``try`` and no environment knob decides the path."""
    assert tss._chain_round(CPU) is tss._chain_round_plain
    for dev in ("meta", "cuda"):
        assert tss._chain_round(torch.device(dev)) is \
            tss._chain_round_kernels
    args = (ct.c_longlong * len(chain_cuda.ARGS))()
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA"):
            chain_cuda._launch("chain_probe_kernel", torch.device(dev), args)
    src = inspect.getsource(chain_cuda)
    nodes = list(ast.walk(ast.parse(src)))
    names = [n.id if isinstance(n, ast.Name) else n.attr for n in nodes
             if isinstance(n, (ast.Name, ast.Attribute))]
    assert "environ" not in src
    assert not [x for x in names if x.endswith("_plain")]
    assert not any(isinstance(n, ast.Try) for n in nodes)
    for fn in (tss.chain_scan, tss._chain_round, tss._chain_round_kernels):
        t = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(t))
        assert "environ" not in inspect.getsource(fn)
    rt = ast.parse(textwrap.dedent(inspect.getsource(tss._chain_round)))
    ifs = [n for n in ast.walk(rt) if isinstance(n, ast.If)]
    assert len(ifs) == 1 and ast.unparse(ifs[0].test) == \
        "dev.type == 'cpu'"
    assert "_chain_round_plain" in ast.unparse(ifs[0].body[0])


def test_chain_round_checks_inputs(idx):
    """ChainRound refuses a dtype, shape or device the kernels do not take
    before anything launches."""
    _, td = idx
    w, Uw, GP = 8, 4, 16
    dt = td.dtype
    st = dict(lane0=torch.zeros(w, dtype=torch.int32),
              lane_rid=torch.zeros(w, dtype=torch.int32),
              pivot=torch.zeros(w, dtype=torch.int32),
              pos=torch.zeros(w, dtype=torch.int32),
              alive=torch.zeros(w, dtype=torch.bool),
              k=torch.zeros(w, dtype=dt), l=torch.zeros(w, dtype=dt),
              s=torch.zeros(w, dtype=dt),
              pool=torch.zeros((6, GP), dtype=dt),
              ctr=torch.zeros(4, dtype=torch.int32),
              **tss.make_chain_memo(16, 8, W, dt, CPU))
    c = dict(lane_rid0=torch.zeros(w, dtype=torch.int32),
             lane_rlen0=torch.zeros(w, dtype=torch.int32),
             row_id0=torch.zeros(w, dtype=torch.int32),
             mh0=torch.ones(w, dtype=dt),
             winflat=torch.zeros(4 * (L + 2), dtype=torch.int64),
             nxt=torch.zeros((4, L), dtype=torch.int32),
             qflat=torch.zeros(4 * L, dtype=torch.uint8), W=W, L=L, GP=GP,
             r3=False, advance=True, min_len=0, max_intv=0)
    rd = chain_cuda.ChainRound(td, c, st, w, Uw)
    # the round holds its sort's storage and its walk, so that a round's
    # launches allocate nothing; the sort takes the keys' bits (H = 16)
    at = {n: i for i, n in enumerate(chain_cuda.ARGS)}
    assert rd.args[at["key_bits"]] == chain_cuda.key_bits(16) == 5
    assert [tuple(x.shape) for x in rd.walk] == [(Uw, W)] * 3 + [(Uw,)]
    assert rd.args[at["ck"]] == rd.walk[0].data_ptr()
    i32 = torch.int32
    for bad in (dict(rnd=torch.zeros(1, dtype=i32)),
                dict(live_in=torch.zeros((), dtype=torch.int64)),
                dict(hist=torch.zeros(3, dtype=i32))):
        kw = dict(dict(rnd=torch.zeros((), dtype=i32),
                       live_in=torch.zeros((), dtype=i32), nxtw=0, rcap=4,
                       hist=torch.zeros(4, dtype=i32)), **bad)
        with pytest.raises((TypeError, ValueError)):
            rd.set_loop(**kw)
    other = torch.int32 if dt == torch.int64 else torch.int64
    for key, bad in (("k", torch.zeros(w, dtype=other)),
                     ("alive", torch.zeros(w, dtype=torch.uint8)),
                     ("pos", torch.zeros(w + 1, dtype=torch.int32)),
                     ("lane_rid", torch.zeros(w, dtype=torch.int64)),
                     ("tbl", torch.zeros((16, 7), dtype=dt)),
                     ("cst", torch.zeros((8, 3 * W + 1), dtype=dt)),
                     ("pool", torch.zeros((6, GP), dtype=dt).T),
                     ("l", torch.zeros(w, dtype=dt, device="meta"))):
        with pytest.raises((TypeError, ValueError)):
            chain_cuda.ChainRound(td, c, dict(st, **{key: bad}), w, Uw)
    for kw in (dict(W=0), dict(W=11)):
        with pytest.raises(ValueError):
            chain_cuda.ChainRound(td, dict(c, **kw), st, w, Uw)
    for uw in (0, w + 1):
        with pytest.raises(ValueError):
            chain_cuda.ChainRound(td, c, st, w, uw)
    with pytest.raises(ValueError):
        chain_cuda.ChainRound(td, c, dict(st, tbl=torch.zeros((12, 8),
                                                               dtype=dt)),
                              w, Uw)
