"""The boundaries between the segments of chain_scan's and
walk_pool_chain's loops, for checking the segment entry kernels
(csrc/compact.cuh: chain_segment_entry_kernel, walk_segment_entry_kernel)
against their plain version (used by chip_smoke.py and
tests/test_torch_cuda.py).

``BoundaryCapture`` runs both loops through their plain rounds (every
seeding call eager) and keeps, at every boundary (``seedscan.
_compact_lanes``), the loop ("chain" or "walk"), the index, the call's
constants, the state as the segment before left it and the next width.
``entry_round`` builds the next segment's round on such a case (its lanes
new tensors), ``source`` gives its source lanes in one of ``FORMS`` (as
captured, no live lane, exactly w live, w + 37 live at the RCAP cap), and
``entry_vs_plain`` runs the kernel and the plain version
(``seedscan.segment_entry_plain``) from one form on two such rounds:
max_abs_err over every lane of the new width and the loop words (live
count, go, round counter, histogram)."""

from __future__ import annotations

import torch

from compseed_tpu_torch.ops import chain_cases, chain_cuda, seeder2
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops import walk_cases, walk_cuda
from compseed_tpu_torch.ops.chain_cases import max_err

FORMS = ("captured", "no live lane", "w live", "cap")
_ENTRIES = dict(chain=("chain_scan", "_chain_round", "_chain_round_plain"),
                walk=("walk_pool_chain", "_walk_round", "_walk_round_plain"))


class BoundaryCapture:
    """While active, runs every chain_scan and walk_pool_chain call
    through the plain round (and every seeding call eager,
    seeder2.EagerCalls), and keeps up to ``limit`` boundaries, in order:
    ``cases``, a list of (loop, fm, constants, the state before the
    compaction, the next width).  A RoundCapture may be entered inside
    it (chip_smoke.chain_capture: one seeding run for both)."""

    def __init__(self, limit: int = 32):
        self.limit, self.cases = limit, []

    def __enter__(self):
        self._eager = seeder2.EagerCalls().__enter__()
        names = [n for e in _ENTRIES.values() for n in e] + ["_compact_lanes"]
        self._orig = {n: getattr(tss, n) for n in names}
        last = {}               # loop -> (fm, constants) of the call running

        def entry(what, fn):
            def call(*a, **kw):
                last.pop(what, None)
                return fn(*a, **kw)
            return call

        def plain(what, fn):
            def rnd(fm, c, *a):
                last[what] = (fm, c)
                return fn(fm, c, *a)
            return rnd

        def compact(st, keys, w, pads=None, out=None):
            what = "chain" if keys == tss.CHAIN_LANE_KEYS else "walk"
            clone = dict(chain=chain_cases.clone_state,
                         walk=walk_cases.clone_state)[what]
            if what in last and len(self.cases) < self.limit:
                self.cases.append((what, *last[what], clone(st), w))
            return self._orig["_compact_lanes"](st, keys, w, pads, out)

        # the plain rounds wrapped (a RoundCapture entered inside runs
        # them), and the dispatch pointed at them
        for what, (fn, dispatch, plain_round) in _ENTRIES.items():
            rnd = plain(what, self._orig[plain_round])
            setattr(tss, fn, entry(what, self._orig[fn]))
            setattr(tss, plain_round, rnd)
            setattr(tss, dispatch, lambda dev, rnd=rnd: rnd)
        tss._compact_lanes = compact
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(tss, n, fn)
        self._eager.__exit__()


def entry_round(case):
    """The round of the segment after a boundary (``case``: one of
    BoundaryCapture's): the state as the segment before left it with its
    lanes new tensors of the next width, as chain_scan and
    walk_pool_chain build it."""
    what, fm, c, st, w = case
    st = dict(chain=chain_cases.clone_state,
              walk=walk_cases.clone_state)[what](st)
    st.update({n: torch.empty(w, dtype=st[n].dtype, device=st[n].device)
               for n in _lane_keys(what)})
    if what == "chain":
        return chain_cuda.ChainRound(fm, c, st, w, min(w, max(w // 2, 64)))
    return walk_cuda.WalkRound(fm, c, st, max(w // 2, 64))


def _lane_keys(what: str) -> tuple:
    return tss.CHAIN_LANE_KEYS if what == "chain" else tss.WALK_LANE_KEYS


def rcap_of(case) -> int:
    """The loop's RCAP: chain_scan's 3 L + 16, walk_pool_chain's L + 2."""
    what, _, c, _, _ = case
    return 3 * c["L"] + 16 if what == "chain" else c["L"] + 2


def source(case, form: str, seed: int = 18) -> tuple:
    """A boundary's source lanes (LANE_KEYS -> the lanes as the segment
    before left them, and "live", their live count) in one of FORMS, and
    the round counter it comes at (3; RCAP for "cap"): "no live lane",
    "w live" (w lanes chosen by ``seed``) and "cap" (w + 37 live: the
    lanes past w dropped, no round run) set alive and the live count."""
    what, _, _, st, w = case
    src = {n: st[n].clone() for n in _lane_keys(what)}
    src["live"] = st["live"].to(torch.int32).clone()
    n = src["alive"].shape[0]
    live = {"no live lane": 0, "w live": w, "cap": w + 37}.get(form)
    if live is not None:
        if live > n:
            raise ValueError(f"{form}: {live} live lanes of {n}")
        g = torch.Generator().manual_seed(seed)
        alive = torch.zeros(n, dtype=torch.bool)
        alive[torch.randperm(n, generator=g)[:live]] = True
        src["alive"] = alive.to(src["alive"].device)
        src["live"].fill_(live)
    return src, rcap_of(case) if form == "cap" else 3


def set_entry(rd, case, src: dict, rnd0: int, nxtw: int | None = None):
    """Name ``src`` as ``rd``'s source (set_loop: a new round counter at
    ``rnd0``, the next width w // 4 unless given, RCAP, a histogram for
    chain_scan's rounds) and fill its lanes with garbage, so that a lane
    the entry neither moves nor pads shows: (round counter, histogram)."""
    dev = rd.dev
    rnd = torch.tensor(rnd0, dtype=torch.int32, device=dev)
    rcap = rcap_of(case)
    hist = torch.full((rcap,), -1, dtype=torch.int32, device=dev) \
        if case[0] == "chain" else None
    rd.set_loop(rnd, src["live"], rd.w // 4 if nxtw is None else nxtw,
                rcap, hist, src)
    for n in rd.LANE_KEYS:
        rd._held[n].fill_(True if n == "alive" else -7)
    rd.live.fill_(-1)
    rd.go.fill_(-1)
    return rnd, hist


def entry_vs_plain(case, form: str, launch=None) -> dict:
    """The segment entry kernel (``launch(rd)``: another build's; None:
    the port's, ``rd.entry``) and its plain version from the same form of
    a boundary, each on a round of its own: {max_abs_err over the new
    lanes and the loop words, kept: the live count, go}."""
    src, rnd0 = source(case, form)
    got = []
    for run in ("kernel", "plain"):
        rd = entry_round(case)
        rnd, hist = set_entry(rd, case, src, rnd0)
        if run == "kernel":
            (launch or type(rd).entry)(rd)
        else:
            tss.segment_entry_plain(rd)
        words = dict(rd._held, live=rd.live, go=rd.go, rnd=rnd, hist=hist)
        got.append({n: words[n] for n in rd.LANE_KEYS +
                    ("live", "go", "rnd", "hist") if words[n] is not None})
    e = max(max_err(got[0][n], got[1][n]) for n in got[1])
    return dict(max_abs_err=e, kept=int(got[1]["live"]),
                go=int(got[1]["go"]))


def entry_work(case, src: dict) -> tuple:
    """(bytes, operations) the entry's work needs on a source: the
    source's alive bytes read, each kept lane's words read and written
    (its alive written), each pad's words and alive written, the live
    word; a scan addition and a compare a source lane."""
    what, _, _, st, w = case
    lane_bytes = sum(st[n].element_size() for n in _lane_keys(what)
                     if n != "alive")
    n = src["alive"].shape[0]
    kept = min(int(src["alive"].sum()), w)
    nbytes = n + kept * (2 * lane_bytes + 1) + (w - kept) * (lane_bytes + 1)
    return nbytes + 4, 2 * n
