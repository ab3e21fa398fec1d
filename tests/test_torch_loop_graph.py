"""The round loops' graph parts held on the CPU: chain_scan's and
walk_pool_chain's segments run on a card as one CUDA graph each
(ops/cuda_lib.run_loop, csrc/loop_graph.cuh), whose pieces that are not
the graph itself are checked here with the sources built by g++ into
their host loops.

- Each key's bit count (chain_cuda.key_bits(H), walk_cuda.KEY_BITS), the
  bits the round's radix sort sorts, bounds every key of every round of
  the fixture runs, chain and walk, int32 and int64, and is reached (a
  key needs its top bit); the host sort over those bits equals
  torch.sort(stable=True) on every round, and over one bit fewer it
  does not on some round.
- The segment entry kernels' host twins (chain_segment_entry_host,
  walk_segment_entry_host) before a call's first segment (the round's
  live lanes counted) and the apply kernels' folded tail (the apply's
  host loop with the loop word set) against the Python loop's test,
  rnd < RCAP and live > nxtw with the histogram word, and against
  seedscan.loop_step_plain, at a running round, the RCAP cap, a segment
  exit and zero live lanes; without the loop word the apply touches no
  loop word.  (The entries' compaction between segments:
  tests/test_torch_segment_entry.py.)
- A CPU chain_scan with report_rounds (round-2 tasks, segmented) against
  the JAX chain_scan: rnd and alive_hist too; the same through the host
  loops stepped as the graph would step them; chain_scan and
  walk_pool_chain through the host loops against the JAX package's while
  loops in rounds, histogram and outputs, every apply a round's last
  launch with the loop word set and its retire count left at 0.
- chain_cases.CallCapture / call_vs_plain / sort_vs_torch (what
  chip_smoke.py and the card tests run on the card) on the host loops.
- cuda_lib.NoTorchOps, the capture guard: it raises on a torch
  allocation or operation of its own thread only.

The graphs themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py."""

import ctypes as ct
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import seedscan as jss
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import (chain_cases, chain_cuda, cuda_lib,
                                    walk_cases, walk_cuda)
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.cuda_lib import launcher_of
from compseed_tpu_torch.ops.device_index import to_device

from tests.test_torch_chain_kernels import W, _case, _port

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODULES = {"chain": chain_cuda, "walk": walk_cuda}


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """Both round sources built with g++ into their host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    out = {}
    for name, mod in MODULES.items():
        so = str(tmp_path_factory.mktemp(name) / f"lib{name}_host.so")
        subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                        "-fPIC", "-o", so, mod.LIB.src], check=True,
                       capture_output=True)
        lib = ct.CDLL(so)
        for kernel in mod.LIB.launches:
            fn = getattr(lib, launcher_of(kernel, "_host"))
            fn.argtypes = [ct.c_void_p]
            fn.restype = ct.c_int
        out[name] = lib
    return out


@pytest.fixture
def on_host(hosts, monkeypatch):
    """Both loops' kernel paths with every launch run by the host builds;
    returns the launches by kernel."""
    calls = {}
    for name, mod in MODULES.items():
        def launch(kernel, dev, args, lib=hosts[name]):
            assert dev.type == "cpu"
            assert getattr(lib, launcher_of(kernel, "_host"))(
                ct.addressof(args)) == 0, kernel
            calls[kernel] = calls.get(kernel, 0) + 1
        monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(tss, "_chain_round",
                        lambda dev: tss._chain_round_kernels)
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


def _run(td, name, monkeypatch):
    """One chain_scan case (tests/test_torch_chain_kernels) and the walk
    of its pool at two lane widths; returns both calls' outputs."""
    case = _case(name)
    for k, v in case[5].items():
        monkeypatch.setenv(k, v)
    out = _port(td, case)
    qarr = torch.from_numpy(case[0])
    pool = out[0]
    n_valid = int((pool[:, 6] != 0).sum())
    walk = tss.walk_pool_chain(td, tss.packed_rev_windows(qarr),
                               qarr.shape[1], pool,
                               1 << (n_valid - 1).bit_length(),
                               segs=(1, 2, 4))
    return out, walk


def _sort_words(mod, key: torch.Tensor, bits: int):
    """Args words for the host sort of ``key``: (args, sorted, order)."""
    at = {n: i for i, n in enumerate(mod.ARGS)}
    w = key.shape[0]
    sorted_key = torch.empty(w, dtype=torch.int32)
    order = torch.empty(w, dtype=torch.int64)
    args = (ct.c_longlong * len(mod.ARGS))()
    for n, x in (("w", w), ("Uw", max(w // 2, 1)), ("W", 5), ("n_rw", 1),
                 ("key", key.data_ptr()), ("sorted_key", sorted_key.data_ptr()),
                 ("order", order.data_ptr()), ("key_bits", bits)):
        if n in at:                     # n_rw is the walk's alone
            args[at[n]] = x
    return args, sorted_key, order


@pytest.mark.parametrize("name", ["lep", "r2"])
def test_key_bits_bound_every_captured_key(hosts, idx, name, monkeypatch):
    """Every round's sort keys, chain_scan's (a live miss's slot or H)
    and walk_pool_chain's (the mix >> 1 or INT32_MAX), lie in [0,
    2^bits) with bits the round's key_bits, and some key of each kind
    needs the top bit; the host build's sort over those bits equals
    torch.sort(key, stable=True) on every round, and over one bit fewer
    differs on some round."""
    _, td = idx
    with chain_cases.EveryRound(limit=512) as cc, \
            walk_cases.EveryRound(limit=512) as wc:
        _run(td, name, monkeypatch)
    assert len(cc.states) > 4 and len(wc.states) >= 3
    for what, states in (("chain", cc.states), ("walk", wc.states)):
        mod, lib = MODULES[what], hosts[what]
        top, short = 0, 0
        for fm, c, st, *sizes in states.values():
            if what == "chain":
                key = tss._chain_probe_plain(fm, c, st)["key"].to(
                    torch.int32)
                bits = chain_cuda.key_bits(st["tbl"].shape[0])
            else:
                key = tss._walk_key_plain(c, st)["key"].to(torch.int32)
                bits = walk_cuda.KEY_BITS
            assert int(key.min()) >= 0 and int(key.max()) < 1 << bits, what
            top = max(top, int(key.max()).bit_length())
            want_key, want_order = torch.sort(key, stable=True)
            for b in (bits, bits - 1):
                args, sk, order = _sort_words(mod, key, b)
                assert getattr(lib, f"{what}_sort_host")(
                    ct.addressof(args)) == 0
                same = torch.equal(sk, want_key) and \
                    torch.equal(order, want_order)
                if b == bits:
                    assert same, what
                else:
                    short += not same
        assert top == bits, what
        assert short > 0, what


def _tiny_round(what, td, n=8):
    """A round of ``what``'s loop on the CPU over n dead lanes (Uw = n //
    2), its scratch and walk zeroed: an apply on it changes no lane and
    adds nothing to the live count."""
    i32, dt = torch.int32, td.dtype
    L = _case("lossy")[0].shape[1]
    if what == "chain":
        st = dict(tss.make_chain_memo(32, 16, W, dt, CPU),
                  lane0=torch.zeros(n, dtype=i32),
                  lane_rid=torch.zeros(n, dtype=i32),
                  pivot=torch.zeros(n, dtype=i32),
                  pos=torch.zeros(n, dtype=i32),
                  alive=torch.zeros(n, dtype=torch.bool),
                  k=torch.zeros(n, dtype=dt), l=torch.zeros(n, dtype=dt),
                  s=torch.zeros(n, dtype=dt),
                  pool=torch.zeros((6, 16), dtype=dt),
                  ctr=torch.zeros(4, dtype=i32))
        c = dict(lane_rid0=torch.zeros(n, dtype=i32),
                 lane_rlen0=torch.zeros(n, dtype=i32),
                 row_id0=torch.zeros(n, dtype=i32),
                 mh0=torch.ones(n, dtype=dt),
                 winflat=torch.zeros(4 * (L + 2), dtype=torch.int64),
                 nxt=torch.zeros((4, L), dtype=i32),
                 qflat=torch.zeros(4 * L, dtype=torch.uint8), W=W, L=L,
                 GP=16, r3=False, advance=True, min_len=0, max_intv=0)
        rd = chain_cuda.ChainRound(td, c, st, n, n // 2)
    else:
        st = dict(k=torch.zeros(n, dtype=dt), l=torch.zeros(n, dtype=dt),
                  s=torch.zeros(n, dtype=dt), mh=torch.ones(n, dtype=dt),
                  rid=torch.zeros(n, dtype=i32), i=torch.zeros(n, dtype=i32),
                  slot=torch.zeros(n, dtype=i32),
                  alive=torch.zeros(n, dtype=torch.bool),
                  death=torch.full((16,), -2, dtype=i32),
                  fk=torch.zeros(16, dtype=dt), fl=torch.zeros(16, dtype=dt),
                  fs=torch.zeros(16, dtype=dt), ctr=torch.zeros(2, dtype=i32))
        c = dict(rwflat=torch.zeros(4 * L, dtype=torch.int64), L=L, W=W,
                 all4=tss._ALL4)
        rd = walk_cuda.WalkRound(td, c, st, n // 2)
    for name, x in rd.scratch.items():
        if name != "iota":
            x.zero_()
    for x in rd.walk:
        x.zero_()
    return rd


def _retire(rd, mod) -> int:
    """The round's retire count (the 64-bit word at sc[SC_RETIRE])."""
    sc = rd.scratch["sc"]
    return int(sc[mod.SC_RETIRE]) | int(sc[mod.SC_RETIRE + 1]) << 32


def _apply_host(hosts, what, rd) -> None:
    assert getattr(hosts[what], f"{what}_apply_host")(
        ct.addressof(rd.args)) == 0


@pytest.mark.parametrize("what", ["chain", "walk"])
@pytest.mark.parametrize("case", ["running", "cap", "exit", "zero"])
def test_loop_host_twins_match_the_python_test(hosts, tiny_fm, what, case):
    """The segment entry kernel's host twin before a call's first segment
    (no source lanes) and the apply kernel's folded tail (its host loop
    with set_loop's loop word, on a round whose lanes are dead so that it
    adds nothing to the live count) against the Python loop's test (rnd <
    RCAP and live > nxtw; when it holds, chain_scan's histogram word
    hist[rnd] = live) and against the plain version,
    seedscan.loop_step_plain (after the apply with the loop word unset):
    the entry counts the round's live lanes into its live word and tests
    the count; the tail counts the round and tests the count the apply
    left, and leaves the retire count at 0.  At a running round, at the
    RCAP cap (the entry at rnd = RCAP, the tail reaching it), at a
    segment exit (live == nxtw) and with no live lane."""
    td = to_device(convert.fmindex_from_jax_package(tiny_fm), CPU)
    mod = MODULES[what]
    i32 = torch.int32
    rcap, nxtw = 12, 64
    rnd0, live = {"running": (3, 100), "cap": (12, 100),
                  "exit": (3, nxtw), "zero": (0, 0)}[case]
    if case == "zero":
        nxtw = 0
    for entry in (True, False):
        r0 = rnd0 - (0 if entry or case != "cap" else 1)
        words = []
        for run in ("twin", "plain"):
            rd = _tiny_round(what, td, 128)
            if entry:
                rd._held["alive"][:live] = True
            rnd = torch.tensor(r0, dtype=i32)
            hist = torch.full((rcap,), -1, dtype=i32) \
                if what == "chain" else None
            rd.set_loop(rnd, None, nxtw, rcap, hist)
            rd.live.fill_(-1 if entry else live)
            rd.go.fill_(-1)
            if run == "twin" and entry:
                assert getattr(hosts[what], f"{what}_segment_entry_host")(
                    ct.addressof(rd.args)) == 0
            elif run == "twin":
                _apply_host(hosts, what, rd)
            else:
                if not entry:
                    rd.args[rd.AT["loop"]] = 0
                    _apply_host(hosts, what, rd)
                tss.loop_step_plain(rd, entry)
            words.append((int(rnd), int(rd.live), int(rd.go),
                          _retire(rd, mod), hist))
        # the Python loop: ``while rnd < RCAP and live > nxtw``
        r = r0 if entry else r0 + 1
        want = r < rcap and live > nxtw
        want_hist = torch.full((rcap,), -1, dtype=i32)
        if want:
            want_hist[r] = live
        for got in words:
            assert got[:4] == (r, live, int(want), 0), (case, entry, words)
            if what == "chain":
                assert torch.equal(got[4], want_hist), (case, entry)
        assert want == (case == "running")


@pytest.mark.parametrize("what", ["chain", "walk"])
def test_apply_without_loop_word_leaves_loop_words(hosts, tiny_fm, what):
    """A round's apply launched on its own (the loop word 0: a round that
    set_loop never named, or whose word is cleared, as phase 2's checks
    and the captured rounds launch it) leaves the round counter, go, the
    histogram and the retire count as they were; with the word set the
    same apply counts the round."""
    td = to_device(convert.fmindex_from_jax_package(tiny_fm), CPU)
    i32 = torch.int32
    rd = _tiny_round(what, td)
    assert rd.args[rd.AT["loop"]] == 0
    rnd = torch.tensor(5, dtype=i32)
    hist = torch.full((12,), -3, dtype=i32)
    rd.set_loop(rnd, torch.tensor(40, dtype=i32), 8, 12, hist)
    assert rd.args[rd.AT["loop"]] == 1
    rd.args[rd.AT["loop"]] = 0
    rd.live.fill_(40)
    rd.go.fill_(-7)
    _apply_host(hosts, what, rd)
    assert (int(rnd), int(rd.go), int(rd.live)) == (5, -7, 40)
    assert bool((hist == -3).all())
    assert _retire(rd, MODULES[what]) == 0
    rd.args[rd.AT["loop"]] = 1
    _apply_host(hosts, what, rd)
    assert (int(rnd), int(rd.go), int(hist[6])) == (6, 1, 40)


def test_cpu_chain_scan_report_rounds_equals_jax(hosts, idx, on_host,
                                                 monkeypatch):
    """chain_scan with report_rounds on round-2 tasks (segmented, 512
    lanes): the round count and the live lanes before each round equal
    the JAX chain_scan's, by the plain loop and by the host loops stepped
    as a segment's graph steps them (the entry kernel, then rounds while
    the test of the apply's folded tail holds), every output bit for
    bit."""
    jd, td = idx
    qarr, rl, GP, (H, M), kw, _ = _case("r2")
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jss.chain_scan(jd, jnp.asarray(qarr), jnp.asarray(rl), GP,
                          jss.make_chain_memo(H, M, W, jd.dtype), W=W,
                          report_rounds=True, **jkw)
    case = (qarr, rl, GP, (H, M), dict(kw, report_rounds=True), {})
    got = _port(td, case)
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round", lambda dev: tss._chain_round_plain)
        plain = _port(td, case)
    assert int(want[6]) > 3
    for out in (got, plain):
        for g, w in zip(out[:5] + out[6:], want[:5] + want[6:]):
            assert np.array_equal(np.asarray(g).astype(np.int64),
                                  np.asarray(w).astype(np.int64))
        for k in tss.MEMO_KEYS:
            assert np.array_equal(out[5][k].numpy().astype(np.int64),
                                  np.asarray(want[5][k]).astype(np.int64))
    rounds = int(got[6])
    assert on_host["chain_apply_kernel"] == rounds
    assert on_host["chain_probe_kernel"] == rounds
    assert on_host["chain_segment_entry_kernel"] == 2   # 512 lanes, then 256


def test_call_capture_vs_plain_on_host(idx, on_host, monkeypatch):
    """chain_cases.CallCapture keeps every call as the kernel path ran it
    (the host loops here, a segment's graph on a card); call_vs_plain
    runs each again through the plain loop: every output equal, and
    sort_vs_torch's check of every round's sort passes."""
    _, td = idx
    with chain_cases.CallCapture("chain_scan") as cc, \
            chain_cases.CallCapture("walk_pool_chain") as wc:
        out, walk = _run(td, "lep", monkeypatch)
    assert len(cc.calls) == len(wc.calls) == 1
    assert len(out) == 8                    # the caller's report_rounds
    for entry, cap, check in (
            ("chain_scan", cc, chain_cases.sort_vs_torch()),
            ("walk_pool_chain", wc, walk_cases.sort_vs_torch())):
        errs = chain_cases.call_vs_plain(entry, cap.calls[0], check)
        names = set(errs)
        assert not any(errs.values()), (entry, errs)
        assert len(check.errs) > 2 and not any(check.errs)
    assert {"rnd", "alive_hist", "memo.tbl", "pool"} <= \
        set(chain_cases.call_vs_plain("chain_scan", cc.calls[0]))
    assert names == set(chain_cases.CALL_OUTPUTS["walk_pool_chain"])
    # a differing output shows
    a, kw, outs = cc.calls[0]
    bad = list(outs)
    bad[3] = outs[3] + 1
    assert chain_cases.call_vs_plain("chain_scan", (a, kw, bad))["fq"] == 1


def test_capture_guard_is_the_threads_own():
    """NoTorchOps raises on a torch allocation and on any other torch
    operation of its own thread (what a captured body must not issue),
    not on a tensor's metadata or address, nor on another thread's
    operations meanwhile."""
    x = torch.zeros(4, dtype=torch.int32)
    seen = []

    def other():
        seen.append(int((torch.ones(3) + 1).sum()))

    with cuda_lib.NoTorchOps():
        assert x.data_ptr() and x.shape == (4,) and x.is_contiguous()
        t = threading.Thread(target=other)
        t.start()
        t.join()
        for op in (lambda: torch.empty(1), lambda: x.add_(1),
                   lambda: int(x[0])):
            with pytest.raises(RuntimeError, match="graph capture"):
                op()
    assert seen == [6] and not x.any()
    torch.empty(1)                      # the mode has ended


def test_loop_words_live_on_the_device(hosts, idx):
    """set_loop points the round's Args at device words (the round
    counter, the live count of the lanes it starts from, its own go word)
    and plain sizes, and sets the loop word: nothing a round changes is an
    Args word, so one set of words serves every replay of the segment's
    graph.  The loop's plain version (seedscan.loop_step_plain, what
    chip_smoke.py holds the segment entry kernel's test and the apply's
    folded tail to on the card) leaves the same words as the entry's host
    twin (no source: the round's live lanes counted) and the apply's host
    loop."""
    _, td = idx
    rd = _tiny_round("chain", td)
    rnd = torch.zeros((), dtype=torch.int32)
    live = torch.tensor(5, dtype=torch.int32)
    hist = torch.zeros(20, dtype=torch.int32)
    at = {n: i for i, n in enumerate(chain_cuda.ARGS)}
    assert rd.args[at["loop"]] == 0
    rd.set_loop(rnd, live, 4, 20, hist)
    assert rd.args[at["rnd"]] == rnd.data_ptr()
    assert rd.args[at["live_in"]] == live.data_ptr()
    assert rd.args[at["hist"]] == hist.data_ptr()
    assert rd.args[at["go"]] == rd.go.data_ptr()
    assert (rd.args[at["nxtw"]], rd.args[at["rcap"]],
            rd.args[at["cond"]], rd.args[at["loop"]]) == (4, 20, 0, 1)
    for entry, r0, live0 in ((True, 3, 5), (False, 3, 5), (False, 19, 9),
                             (True, 2, 4), (False, 7, 3)):
        words = []
        for run in ("twin", "plain"):
            rnd.fill_(r0)
            live.fill_(live0)
            rd.live.fill_(-1 if entry else live0)
            rd._held["alive"].zero_()[:live0] = entry
            hist.zero_()
            if run == "twin" and entry:
                assert hosts["chain"].chain_segment_entry_host(
                    ct.addressof(rd.args)) == 0
            elif run == "twin":
                _apply_host(hosts, "chain", rd)
            else:
                if not entry:
                    rd.args[at["loop"]] = 0
                    _apply_host(hosts, "chain", rd)
                    rd.args[at["loop"]] = 1
                tss.loop_step_plain(rd, entry)
            words.append([int(rnd), int(rd.live), int(rd.go), hist.clone()])
        assert words[0][:3] == words[1][:3], (entry, r0, live0)
        assert torch.equal(words[0][3], words[1][3])
    rd.set_loop(rnd, live, 0, 20)
    assert rd.args[at["hist"]] == 0


def test_retire_count_is_zero_after_every_round(idx, on_host, monkeypatch):
    """Every apply that chain_scan and walk_pool_chain launch through the
    host loops ends a loop's body (its loop word set) and leaves the
    retire count (the 64-bit word at sc[SC_RETIRE], what the kernel's
    last block resets) at 0, after every round, every segment and a second call of the same
    shape on the kept tensors; the applies are one a round."""
    _, td = idx
    launch = {m: m._launch for m in MODULES.values()}
    seen = {"chain": [], "walk": []}

    def watch(mod, what):
        at = {n: i for i, n in enumerate(mod.ARGS)}

        def run(kernel, dev, args):
            launch[mod](kernel, dev, args)
            if kernel == f"{what}_apply_kernel":
                sc = ct.cast(args[at["sc"]], ct.POINTER(ct.c_int32))
                seen[what].append((args[at["loop"]], sc[mod.SC_RETIRE],
                                   sc[mod.SC_RETIRE + 1]))
        return run

    for what, mod in MODULES.items():
        monkeypatch.setattr(mod, "_launch", watch(mod, what))
    tss.drop_held()
    for call in range(2):
        n0 = {w: len(v) for w, v in seen.items()}
        out, _ = _run(td, "lep", monkeypatch)
        assert len(seen["chain"]) - n0["chain"] == int(out[6]) > 3
        assert len(seen["walk"]) - n0["walk"] > 2
        for held in tss._HELD[threading.get_ident()].values():
            for rd in filter(None, held.rounds):
                mod = walk_cuda if isinstance(rd, walk_cuda.WalkRound) \
                    else chain_cuda
                assert _retire(rd, mod) == 0
    for what, runs in seen.items():
        assert runs and all(r == (1, 0, 0) for r in runs), (what, runs)


@pytest.mark.parametrize("what", ["chain", "walk"])
def test_host_loops_rounds_equal_jax(idx, on_host, what, monkeypatch):
    """chain_scan (report_rounds, segmented) and walk_pool_chain through
    the host loops, the apply's folded tail deciding every round after a
    segment's first: rounds, the histogram and every output equal the JAX
    package's while loops (the walk's rounds, which the JAX function does
    not report, equal the plain loop's, whose outputs equal JAX's), one
    apply a round."""
    jd, td = idx
    case = _case("lep")
    for k, v in case[5].items():
        monkeypatch.setenv(k, v)
    qarr, rl, GP, (H, M), kw, _ = case
    if what == "chain":
        want = jss.chain_scan(jd, jnp.asarray(qarr), jnp.asarray(rl), GP,
                              jss.make_chain_memo(H, M, W, jd.dtype), W=W,
                              **kw)
        got = _port(td, case)
        assert len(got) == len(want) == 8 and int(want[6]) > 3
        for g, w in zip(got[:5] + got[6:], want[:5] + want[6:]):
            assert np.array_equal(np.asarray(g).astype(np.int64),
                                  np.asarray(w).astype(np.int64))
        for k in tss.MEMO_KEYS:
            assert np.array_equal(got[5][k].numpy().astype(np.int64),
                                  np.asarray(want[5][k]).astype(np.int64))
        assert on_host["chain_apply_kernel"] == int(got[6])
        return
    pool = _port(td, case)[0]
    n_valid = int((pool[:, 6] != 0).sum())
    CAPW = 1 << (n_valid - 1).bit_length()
    applies = on_host.get("walk_apply_kernel", 0)
    got = tss.walk_pool_chain(td, tss.packed_rev_windows(
        torch.from_numpy(qarr)), qarr.shape[1], pool, CAPW, segs=(1, 2, 4))
    applies = on_host["walk_apply_kernel"] - applies
    rounds = []
    plain_round = tss._walk_round_plain
    with monkeypatch.context() as m:
        m.setattr(tss, "_walk_round", lambda dev: lambda *a: (
            rounds.append(1), plain_round(*a))[1])
        plain = tss.walk_pool_chain(td, tss.packed_rev_windows(
            torch.from_numpy(qarr)), qarr.shape[1], pool, CAPW,
            segs=(1, 2, 4))
    want = jss.walk_pool_chain(jd, jss.packed_rev_windows(
        jnp.asarray(qarr)), qarr.shape[1], jnp.asarray(pool.numpy()), CAPW,
        segs=(1, 2, 4))
    assert len(got) == len(plain) == len(want) == 7
    for g, p, w in zip(got, plain, want):
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64))
        assert torch.equal(g, p)
    assert applies == len(rounds) > 2


@pytest.mark.parametrize("name", ["lep", "r2"])
def test_kept_tensors_serve_the_next_call_of_a_shape(idx, on_host, name,
                                                     monkeypatch):
    """Calls of one shape with other inputs each time (the reads in
    another order; round-2 tasks with other pivots and min_hits) through
    the host loops, which run on the tensors kept for that shape
    (seedscan._held): each call equals the plain loop, output by output;
    only the first builds its rounds (a card captures their graphs then
    and runs them again); what a call returns, the memo, the counters and
    the walk's results, is its own (the next call leaves it as it
    was)."""
    _, td = idx
    tss.drop_held()                 # the thread's kept shapes from before
    built = []
    for mod, cls in ((chain_cuda, "ChainRound"), (walk_cuda, "WalkRound")):
        def counted(*a, _make=getattr(mod, cls), **kw):
            built.append(cls)
            return _make(*a, **kw)
        monkeypatch.setattr(mod, cls, counted)
    qarr0, rl0, GP, (H, M), kw0, env = _case(name)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(5)
    outs, walks = [], []
    for call in range(3):
        perm = rng.permutation(len(rl0))
        qarr, rl = qarr0[perm], rl0[perm]
        kw = dict(kw0)
        if "min_hits" in kw:
            n = len(kw["min_hits"])
            kw["min_hits"] = rng.integers(1, 6, n).astype(np.int32)
            kw["pivots0"] = (rng.random(n) * rl[kw["rids"]]).astype(np.int32)
        case = (qarr, rl, GP, (H, M), kw, env)
        got = _port(td, case)
        with monkeypatch.context() as m:
            m.setattr(tss, "_chain_round",
                      lambda dev: tss._chain_round_plain)
            want = _port(td, case)
        for g, w in zip(got[:5] + got[6:], want[:5] + want[6:]):
            assert torch.equal(g, w), call
        for k in tss.MEMO_KEYS:
            assert torch.equal(got[5][k], want[5][k]), call
        pool = got[0]
        n_valid = int((pool[:, 6] != 0).sum())
        args = (td, tss.packed_rev_windows(torch.from_numpy(qarr)),
                qarr.shape[1], pool, 1 << (n_valid - 1).bit_length())
        walk = tss.walk_pool_chain(*args, segs=(1, 2, 4))
        with monkeypatch.context() as m:
            m.setattr(tss, "_walk_round", lambda dev: tss._walk_round_plain)
            walk_plain = tss.walk_pool_chain(*args, segs=(1, 2, 4))
        for g, w in zip(walk, walk_plain):
            assert torch.equal(g, w), call
        if call == 0:
            n_built = len(built)
            assert n_built >= 2
        outs.append([[x.clone() for x in got[1:5]] +
                     [v.clone() for v in got[5].values()],
                     list(got[1:5]) + list(got[5].values())])
        walks.append([[x.clone() for x in walk], walk])
    assert len(built) == n_built      # the later calls built no round
    for kept, returned in walks[:2]:
        for a, b in zip(kept, returned):
            assert torch.equal(a, b)
    for kept, returned in outs[:2]:
        for a, b in zip(kept, returned):
            assert torch.equal(a, b)


def test_kept_tensors_are_each_threads_own(idx, on_host, monkeypatch):
    """Threads running chain_scan side by side on one shape (more workers
    than cores, a short switch interval) each keep tensors of their own
    (seedscan._held) and each equal the plain loop; what a thread kept is
    freed by the next call of a live thread once it has ended."""
    import concurrent.futures as cf
    import sys

    _, td = idx
    case = _case("lep")
    for k, v in case[5].items():
        monkeypatch.setenv(k, v)
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round", lambda dev: tss._chain_round_plain)
        want = _port(td, case)
    seen = {}

    def work(i):
        out = _port(td, case)
        with tss._HELD_LOCK:
            seen[i] = (threading.get_ident(),
                       id(tss._HELD[threading.get_ident()]))
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(max_workers=6) as ex:
            futs = [ex.submit(work, i) for i in range(6)]
            outs = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for got in outs:
        for g, w in zip(got[:5] + got[6:], want[:5] + want[6:]):
            assert torch.equal(g, w)
    idents = {t for t, _ in seen.values()}
    # a thread's calls share its kept shapes; no two threads share them
    assert len(idents) > 1
    assert len({k for _, k in seen.values()}) == len(idents)
    assert idents & set(tss._HELD)           # the ended threads' kept state
    _port(td, case)                           # a live thread's call
    assert not idents & set(tss._HELD)
