"""The round loops' segment entry kernels held on the CPU:
chain_segment_entry_kernel (csrc/chain_scan.cu) and
walk_segment_entry_kernel (csrc/walk_chain.cu), both csrc/compact.cuh,
through their host twins built with g++ (chain_segment_entry_host,
walk_segment_entry_host).

At every boundary between two segments of the fixture runs (chain_scan's
segmented round 1 and round-2 tasks, walk_pool_chain's widths; int32 and
int64 positions), captured as the host loops run it, the twin is held to
the plain version (seedscan.segment_entry_plain: seedscan._compact_lanes,
then loop_step_plain's entry test) and to the JAX package's compaction
and cond (compseed_tpu/ops/seedscan.py:1727-1737 for chain_scan, :739-748
for walk_pool_chain, and the while_loop's cond, run here on the same
numpy state): every lane of the new width, the live count (min(live, w),
jnp.sum(alive) after the compaction), go, the round counter and the
histogram.  Besides the captured states, on purpose: no live lane,
exactly w live lanes, more than w live lanes at the RCAP cap (the ones
past w dropped), and the histogram word with a round to run.  The kernel
path never runs the plain compaction, and its entry runs once a segment;
set_loop refuses a source that does not fit the round."""

import ctypes as ct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu_torch.ops import chain_cuda, cuda_lib
from compseed_tpu_torch.ops import seedscan as tss

from tests.test_torch_chain_kernels import _case, _port
# the fixtures hosts, idx and on_host are the loop graph tests'
from tests.test_torch_loop_graph import (  # noqa: F401
    _run, _tiny_round, hosts, idx, on_host)

torch.set_num_threads(1)

I32 = torch.int32
# the JAX loops' lane arrays (alive apart): chain_scan's has no lane_rid,
# which the port carries as lane_rid0[lane0]
JAX_KEYS = dict(chain=("lane0", "pivot", "pos", "k", "l", "s"),
                walk=("k", "l", "s", "rid", "i", "mh", "slot"))
FORMS = ["captured", "zero", "exact", "cap", "hist"]
_BOUNDS: dict = {}


def _what(rd) -> str:
    return "chain" if isinstance(rd, chain_cuda.ChainRound) else "walk"


def _boundaries(td, monkeypatch) -> dict:
    """Every segment boundary of the fixture runs through the host loops
    (chain_scan's "lep" run and the walk of its pool, chain_scan's "r2"
    run), once per index type: "chain" / "walk" -> [the next segment's
    round, the source lanes (with "live") as they were, the round
    counter, the next width, RCAP]."""
    key = str(td.dtype)
    if key in _BOUNDS:
        return _BOUNDS[key]
    seen = {"chain": [], "walk": []}
    entry = cuda_lib.RoundArgs.entry

    def watch(rd):
        if rd._src is not None:
            rnd = rd._loop[0]
            seen[_what(rd)].append(dict(
                rd=rd, src={n: v.clone() for n, v in rd._src.items()},
                rnd=int(rnd), nxtw=rd.args[rd.AT["nxtw"]],
                rcap=rd.args[rd.AT["rcap"]]))
        entry(rd)

    tss.drop_held()
    with monkeypatch.context() as m:
        m.setattr(cuda_lib.RoundArgs, "entry", watch)
        _run(td, "lep", monkeypatch)
        _port(td, _case("r2"))
    # the rounds now belong to this file: no later call reuses their words
    tss.drop_held()
    assert len(seen["chain"]) >= 2 and len(seen["walk"]) >= 1, seen
    _BOUNDS[key] = seen
    return seen


def _form(b: dict, form: str, rng) -> tuple:
    """A boundary's source lanes, round counter, next width and whether
    the histogram is on, in one of FORMS."""
    src = {n: v.clone() for n, v in b["src"].items()}
    n, w = src["alive"].shape[0], b["rd"].w
    rnd, nxtw = b["rnd"], b["nxtw"]
    if form in ("zero", "exact", "cap"):
        live = {"zero": 0, "exact": w, "cap": w + 37}[form]
        assert live <= n
        src["alive"] = torch.zeros(n, dtype=torch.bool)
        src["alive"][torch.from_numpy(rng.choice(n, live, replace=False))] \
            = True
        if form == "cap":
            rnd = b["rcap"]
        src["live"] = torch.tensor(live, dtype=I32)
    if form == "hist":
        nxtw = 0                        # a round to run: the word written
    return src, rnd, nxtw, form in ("captured", "hist")


def _entry(hosts, b: dict, src: dict, rnd0: int, nxtw: int, hist_on: bool,
           run: str) -> dict:
    """The segment entry on boundary ``b``'s round from ``src``: the host
    twin or the plain version, every lane of the round filled with
    garbage first (a lane neither moved nor padded shows).  Its lanes,
    live count, go, round counter and histogram."""
    rd, what = b["rd"], _what(b["rd"])
    s = {n: v.clone() for n, v in src.items()}
    rnd = torch.tensor(rnd0, dtype=I32)
    hist = torch.full((b["rcap"],), -1, dtype=I32) if hist_on else None
    rd.set_loop(rnd, s["live"], nxtw, b["rcap"], hist, s)
    for n in rd.LANE_KEYS:
        rd._held[n].fill_(True if n == "alive" else -7)
    rd.live.fill_(-1)
    rd.go.fill_(-1)
    if run == "twin":
        assert getattr(hosts[what], f"{what}_segment_entry_host")(
            ct.addressof(rd.args)) == 0
    else:
        tss.segment_entry_plain(rd)
    return dict(lanes={n: rd._held[n].clone() for n in rd.LANE_KEYS},
                live=int(rd.live), go=int(rd.go), rnd=int(rnd), hist=hist)


def _jax_entry(what: str, src: dict, w: int, rnd: int, nxtw: int,
               rcap: int) -> dict:
    """The JAX package's step between segments on the same state: its
    stable rank-scatter compaction (seedscan.py:1727-1737, chain_scan;
    :739-748, walk_pool_chain) and the next while_loop's cond."""
    lalive = jnp.asarray(src["alive"].numpy())
    crank = jnp.cumsum(lalive, dtype=jnp.int32) - 1
    tgt = jnp.where(lalive, crank, w)
    out = {kk: np.asarray(jnp.zeros(w, src[kk].numpy().dtype).at[tgt].set(
        jnp.asarray(src[kk].numpy()), mode="drop")) for kk in JAX_KEYS[what]}
    out["alive"] = np.asarray(jnp.zeros(w, jnp.bool_).at[tgt].set(
        lalive, mode="drop"))
    live = int(jnp.sum(jnp.asarray(out["alive"]), dtype=jnp.int32))
    go = bool((rnd < rcap) & (live > nxtw))
    return dict(lanes=out, live=live, go=go)


@pytest.mark.parametrize("what", ["chain", "walk"])
@pytest.mark.parametrize("form", FORMS)
def test_segment_entry_host_equals_plain_and_jax(hosts, idx, on_host, what,
                                                 form, monkeypatch):
    """At every boundary of the fixture runs (chain or walk), in each
    form: the entry's host twin equals the plain version on every lane
    of the new width, the live count, go, the round counter and the
    histogram, and both equal the JAX package's compaction and cond (the
    chain's lane_rid stays lane_rid0[lane0], lane 0's for a pad).  The
    live count is min(live, w): the cap form keeps w of its w + 37 live
    lanes and runs no round."""
    _, td = idx
    rng = np.random.default_rng(18)
    bounds = _boundaries(td, monkeypatch)[what]
    for at, b in enumerate(bounds):
        src, rnd, nxtw, hist_on = _form(b, form, rng)
        w, rcap = b["rd"].w, b["rcap"]
        twin, plain = (_entry(hosts, b, src, rnd, nxtw, hist_on, run)
                       for run in ("twin", "plain"))
        where = (what, form, at)
        for n in b["rd"].LANE_KEYS:
            assert torch.equal(twin["lanes"][n], plain["lanes"][n]), \
                (where, n)
        for k in ("live", "go", "rnd"):
            assert twin[k] == plain[k], (where, k, twin[k], plain[k])
        if hist_on:
            assert torch.equal(twin["hist"], plain["hist"]), where
        want = _jax_entry(what, src, w, rnd, nxtw, rcap)
        for n, x in want["lanes"].items():
            assert np.array_equal(plain["lanes"][n].numpy().astype(np.int64),
                                  x.astype(np.int64)), (where, n)
        assert (plain["live"], bool(plain["go"])) == (want["live"],
                                                      want["go"]), where
        assert plain["rnd"] == rnd
        if what == "chain":
            lane0 = plain["lanes"]["lane0"].long()
            rid_pad = int(b["rd"].pads["lane_rid"])
            kept = plain["lanes"]["alive"]
            assert (plain["lanes"]["lane_rid"][~kept] == rid_pad).all()
            # a kept lane's read id moved with it
            src_rid = dict(zip(src["lane0"].tolist(),
                               src["lane_rid"].tolist()))
            assert [src_rid[x] for x in lane0[kept].tolist()] == \
                plain["lanes"]["lane_rid"][kept].tolist(), where
        if hist_on:
            hist = torch.full((rcap,), -1, dtype=I32)
            if want["go"]:
                hist[rnd] = want["live"]
            assert torch.equal(plain["hist"], hist), where
        expect = {"zero": (0, 0), "exact": (w, int(rnd < rcap and w > nxtw)),
                  "cap": (w, 0)}.get(form)
        if expect:
            assert (plain["live"], plain["go"]) == expect, where
        if form == "hist":
            assert plain["go"] == int(plain["live"] > 0 and rnd < rcap)


def test_kernel_path_compacts_by_the_entry_alone(idx, on_host, monkeypatch):
    """Through the host loops (what the graphs run on a card) the lanes
    go from one segment to the next by the entry kernels alone: the plain
    compaction never runs, the entry runs once a segment (the call's
    first too, which counts its live lanes), and the outputs equal the
    plain loops'."""
    _, td = idx

    def refuse(*a, **kw):
        raise AssertionError("the kernel path ran the plain compaction")

    tss.drop_held()
    with monkeypatch.context() as m:
        m.setattr(tss, "_compact_lanes", refuse)
        out, walk = _run(td, "lep", monkeypatch)
    assert on_host["chain_segment_entry_kernel"] == 2     # 512, then 256
    assert 2 <= on_host["walk_segment_entry_kernel"] <= 3
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round", lambda dev: tss._chain_round_plain)
        m.setattr(tss, "_walk_round", lambda dev: tss._walk_round_plain)
        want, want_walk = _run(td, "lep", monkeypatch)
    for g, w in zip(out[:5] + out[6:], want[:5] + want[6:]):
        assert torch.equal(g, w)
    for g, w in zip(walk, want_walk):
        assert torch.equal(g, w)


@pytest.mark.parametrize("what", ["chain", "walk"])
def test_set_loop_refuses_a_source_that_does_not_fit(hosts, idx, what):
    """set_loop names a source's lanes only if each has the round's dtype
    and the source's one width, that width is at least the round's and a
    live count comes with it; the host twin refuses a source narrower
    than the round (as the launcher does), and without a source it reads
    no source word."""
    _, td = idx
    rd = _tiny_round(what, td, 16)
    src = {n: torch.zeros(32, dtype=rd._held[n].dtype)
           for n in rd.LANE_KEYS}
    src["live"] = torch.zeros((), dtype=I32)
    rnd = torch.zeros((), dtype=I32)
    rd.set_loop(rnd, src["live"], 0, 4, None, src)
    assert rd.args[rd.AT["src_w"]] == 32
    assert rd.args[rd.AT["src_k"]] == src["k"].data_ptr()
    other = torch.int32 if td.dtype == torch.int64 else torch.int64
    for bad, live in ((dict(src, k=torch.zeros(32, dtype=other)),
                       src["live"]),
                      (dict(src, slot=torch.zeros(31, dtype=I32))
                       if what == "walk" else
                       dict(src, pos=torch.zeros(31, dtype=I32)),
                       src["live"]),
                      ({n: v[:8] for n, v in src.items() if n != "live"},
                       src["live"]),
                      (src, None)):
        with pytest.raises((TypeError, ValueError)):
            rd.set_loop(rnd, live, 0, 4, None, bad)
    rd.set_loop(rnd, src["live"], 0, 4, None, src)
    rd.args[rd.AT["src_w"]] = 8                  # narrower than the round
    assert getattr(hosts[what], f"{what}_segment_entry_host")(
        ct.addressof(rd.args)) == -1
    rd.set_loop(rnd, None, 0, 4)
    assert rd.args[rd.AT["src_w"]] == 0 and rd.args[rd.AT["live_in"]] == 0
    rd._held["alive"][:3] = True
    assert getattr(hosts[what], f"{what}_segment_entry_host")(
        ct.addressof(rd.args)) == 0
    assert (int(rd.live), int(rd.go)) == (3, 1)


def test_boundary_capture_entry_vs_plain_on_host(idx, on_host, monkeypatch):
    """entry_cases (what chip_smoke.py and the card tests run on the card)
    on the host twins: BoundaryCapture keeps every boundary of the
    fixture runs through the plain rounds (chain and walk), and on each,
    in every form, entry_vs_plain finds the entry equal to its plain
    version, with the live count the form asks for."""
    from compseed_tpu_torch.ops import entry_cases
    _, td = idx
    with entry_cases.BoundaryCapture() as cap:
        _run(td, "lep", monkeypatch)
    kinds = [c[0] for c in cap.cases]
    assert kinds.count("chain") == 1 and kinds.count("walk") >= 1, kinds
    for case in cap.cases:
        w = case[4]
        for form in entry_cases.FORMS:
            r = entry_cases.entry_vs_plain(case, form)
            assert r["max_abs_err"] == 0, (case[0], form, r)
            want = {"no live lane": 0, "w live": w, "cap": w}.get(form)
            if want is not None:
                assert r["kept"] == want, (form, r)
            if form == "cap":
                assert r["go"] == 0
        nbytes, ops = entry_cases.entry_work(
            case, entry_cases.source(case, "captured")[0])
        assert nbytes > case[3]["alive"].shape[0] and ops > 0


def test_entry_tile_matches_source():
    """cuda_lib.ENTRY_TILE, the lanes a block of the segment entry takes,
    is csrc/compact.cuh's kEntryBlock * kEntryItems: set_loop sizes the
    entry's look-back words by it (a word a block), and too few would be
    overrun without an error."""
    import re
    src = open(chain_cuda.LIB.src.replace("chain_scan.cu",
                                          "compact.cuh")).read()
    n = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("kEntryBlock", "kEntryItems")}
    assert n["kEntryBlock"] * n["kEntryItems"] == cuda_lib.ENTRY_TILE
    assert n["kEntryBlock"] % 32 == 0 and n["kEntryBlock"] <= 1024


@pytest.fixture(scope="module")
def stage_twin(tmp_path_factory):
    """csrc/lockstep.cu built with g++ into its host loops (the walk stage
    entry's twin, walk_stage_entry_host)."""
    from compseed_tpu_torch.ops import lockstep_cases
    return lockstep_cases.HostTwin(
        str(tmp_path_factory.mktemp("lockstep") / "liblockstep_host.so"))


def test_walk_stage_entry_host_counts_the_epoch(stage_twin, idx):
    """walk_stage_entry_kernel's host twin keeps the look-back's epoch
    word as the kernel does in both forms: a count (no source: the
    stage's live lanes counted, which on the card takes no ticket and no
    look-back) and a compaction advance sc's epoch by one each; neither
    leaves a ticket or a retire count behind; the live word is min(live,
    w), go the loop's test, and a compaction's lanes are the plain
    version's (lockstep_cases.walk_entry_plain)."""
    from compseed_tpu_torch.ops import lockstep_cases, lockstep_cuda
    _, td = idx
    rng = np.random.default_rng(12)
    w, n, fit = 200, 300, 40
    lp = lockstep_cuda.WalkLoop(td, 16, 40, torch.zeros(64, dtype=torch.uint8),
                                None, 3, n)
    sc = lp.sc.view(I32)
    sc[2] = 7                                   # an epoch already counted

    def lanes(m, p_alive):
        st = {k: torch.from_numpy(rng.integers(-50, 50, m)).to(
            lp._dtype(k)) for k in lockstep_cuda.LANE_KEYS if k != "alive"}
        st["alive"] = torch.from_numpy(rng.random(m) < p_alive)
        return st

    def entry(st, src=None):
        lp._point(st, fit, src)
        assert stage_twin.lib.walk_stage_entry_host(ct.addressof(lp.args)) \
            == 0
        return int(sc[0]), int(lp.go)

    epoch = 7
    for form, p_alive in (("count", 0.5), ("compact", 0.5), ("count", 0.0),
                          ("compact", 1.0), ("count", 1.0)):
        if form == "count":
            st = lanes(w, p_alive)
            want = {k: v.clone() for k, v in st.items()}
            live = int(st["alive"].sum())
            got = entry(st)
        else:
            src = lanes(n, p_alive)
            live = int(src["alive"].sum())
            lp.live.fill_(live)
            st = lp.empty_lanes(w)
            want = lockstep_cases.walk_entry_plain(src, w)
            got = entry(st, src)
        epoch += 1
        kept = min(live, w)
        assert got == (kept, int(kept > fit)), form
        assert int(sc[2]) == epoch and int(sc[1]) == 0, form
        assert int(lp.sc[2]) == 0, form          # the retire word
        for k in want:
            assert torch.equal(st[k], want[k]), (form, k)
