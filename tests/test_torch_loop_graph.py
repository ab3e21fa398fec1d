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
- The loop kernels' host twins (chain_loop_*_host, walk_loop_*_host)
  against the Python loop's test, rnd < RCAP and live > nxtw with the
  histogram word, at a running round, the RCAP cap, a segment exit and
  zero live lanes.
- A CPU chain_scan with report_rounds (round-2 tasks, segmented) against
  the JAX chain_scan: rnd and alive_hist too; the same through the host
  loops stepped as the graph would step them.
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


@pytest.mark.parametrize("what", ["chain", "walk"])
@pytest.mark.parametrize("case", ["running", "cap", "exit", "zero"])
def test_loop_host_twins_match_the_python_test(hosts, what, case):
    """The entry and cond kernels' host twins against the Python loop's
    test (rnd < RCAP and live > nxtw; when it holds, chain_scan's
    histogram word hist[rnd] = live): the entry copies the live count
    the segment starts with into the round's live word and tests it; the
    cond counts the round and tests the apply kernel's count.  At a
    running round, at the RCAP cap (the entry at rnd = RCAP, the cond
    reaching it), at a segment exit (live == nxtw) and with no live
    lane."""
    mod, lib = MODULES[what], hosts[what]
    rcap, nxtw = 12, 64
    rnd0, live = {"running": (3, 100), "cap": (12, 100),
                  "exit": (3, nxtw), "zero": (0, 0)}[case]
    if case == "zero":
        nxtw = 0
    live_word = 2                       # sc[2] in both sources
    for entry in (True, False):
        rnd = torch.tensor(rnd0 - (0 if entry or case != "cap" else 1),
                           dtype=torch.int32)
        live_in = torch.tensor(live, dtype=torch.int32)
        sc = torch.zeros(8, dtype=torch.int32)
        sc[live_word] = live if not entry else -1
        hist = torch.full((rcap,), -1, dtype=torch.int32)
        go = torch.tensor(-1, dtype=torch.int32)
        at = {n: i for i, n in enumerate(mod.ARGS)}
        args = (ct.c_longlong * len(mod.ARGS))()
        for n, x in (("w", 8), ("Uw", 4), ("W", 5), ("n_rw", 1),
                     ("rnd", rnd.data_ptr()), ("live_in", live_in.data_ptr()),
                     ("sc", sc.data_ptr()), ("nxtw", nxtw), ("rcap", rcap),
                     ("hist", hist.data_ptr() if what == "chain" else 0),
                     ("go", go.data_ptr())):
            if n in at:                 # n_rw is the walk's alone
                args[at[n]] = x
        r0 = int(rnd)
        fn = f"{what}_loop_{'entry' if entry else 'cond'}_host"
        assert getattr(lib, fn)(ct.addressof(args)) == 0
        # the Python loop: ``while rnd < RCAP and live > nxtw``
        r = r0 if entry else r0 + 1
        want = r < rcap and live > nxtw
        assert int(rnd) == r and int(sc[live_word]) == live
        assert int(go) == int(want), (case, entry)
        want_hist = torch.full((rcap,), -1, dtype=torch.int32)
        if want and what == "chain":
            want_hist[r] = live
        assert torch.equal(hist, want_hist), (case, entry)
        if case in ("cap", "exit", "zero"):
            assert not want
        if case == "running":
            assert want


def test_cpu_chain_scan_report_rounds_equals_jax(hosts, idx, on_host,
                                                 monkeypatch):
    """chain_scan with report_rounds on round-2 tasks (segmented, 512
    lanes): the round count and the live lanes before each round equal
    the JAX chain_scan's, by the plain loop and by the host loops stepped
    as a segment's graph steps them (the entry kernel, then rounds while
    the cond kernel's test holds), every output bit for bit."""
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
    assert on_host["chain_loop_cond_kernel"] == rounds
    assert on_host["chain_probe_kernel"] == rounds
    assert on_host["chain_loop_entry_kernel"] == 2   # 512 lanes, then 256


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
    counter, the live count it starts from, its own go word) and plain
    sizes: nothing a round changes is an Args word, so one set of words
    serves every replay of the segment's graph.  The loop kernels' plain
    version (seedscan.loop_step_plain, what chip_smoke.py holds them to
    on the card) leaves the same words as their host twins."""
    _, td = idx
    case = _case("lossy")
    memo = tss.make_chain_memo(32, 16, W, td.dtype, CPU)
    st = dict(memo, lane0=torch.zeros(8, dtype=torch.int32),
              lane_rid=torch.zeros(8, dtype=torch.int32),
              pivot=torch.zeros(8, dtype=torch.int32),
              pos=torch.zeros(8, dtype=torch.int32),
              alive=torch.zeros(8, dtype=torch.bool),
              k=torch.zeros(8, dtype=td.dtype),
              l=torch.zeros(8, dtype=td.dtype),
              s=torch.zeros(8, dtype=td.dtype),
              pool=torch.zeros((6, 16), dtype=td.dtype),
              ctr=torch.zeros(4, dtype=torch.int32))
    L = case[0].shape[1]
    c = dict(lane_rid0=torch.zeros(8, dtype=torch.int32),
             lane_rlen0=torch.zeros(8, dtype=torch.int32),
             row_id0=torch.zeros(8, dtype=torch.int32),
             mh0=torch.ones(8, dtype=td.dtype),
             winflat=torch.zeros(4 * (L + 2), dtype=torch.int64),
             nxt=torch.zeros((4, L), dtype=torch.int32),
             qflat=torch.zeros(4 * L, dtype=torch.uint8), W=W, L=L, GP=16,
             r3=False, advance=True, min_len=0, max_intv=0)
    rd = chain_cuda.ChainRound(td, c, st, 8, 4)
    rnd = torch.zeros((), dtype=torch.int32)
    live = torch.tensor(5, dtype=torch.int32)
    hist = torch.zeros(20, dtype=torch.int32)
    rd.set_loop(rnd, live, 4, 20, hist)
    at = {n: i for i, n in enumerate(chain_cuda.ARGS)}
    assert rd.args[at["rnd"]] == rnd.data_ptr()
    assert rd.args[at["live_in"]] == live.data_ptr()
    assert rd.args[at["hist"]] == hist.data_ptr()
    assert rd.args[at["go"]] == rd.go.data_ptr()
    assert (rd.args[at["nxtw"]], rd.args[at["rcap"]],
            rd.args[at["cond"]]) == (4, 20, 0)
    for entry, r0, live0 in ((True, 3, 5), (False, 3, 5), (False, 19, 9),
                             (True, 2, 4), (False, 7, 3)):
        words = []
        for run in ("twin", "plain"):
            rnd.fill_(r0)
            live.fill_(live0)
            rd.live.fill_(-1 if entry else live0)
            hist.zero_()
            if run == "twin":
                name = f"chain_loop_{'entry' if entry else 'cond'}_host"
                assert getattr(hosts["chain"], name)(
                    ct.addressof(rd.args)) == 0
            else:
                tss.loop_step_plain(rd, entry)
            words.append([int(rnd), int(rd.live), int(rd.go), hist.clone()])
        assert words[0][:3] == words[1][:3], (entry, r0, live0)
        assert torch.equal(words[0][3], words[1][3])
    rd.set_loop(rnd, live, 0, 20)
    assert rd.args[at["hist"]] == 0


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
