"""Rounds of chain_scan for checking the kernels of csrc/chain_scan.cu
against their plain steps (used by chip_smoke.py and
tests/test_torch_cuda.py).

``RoundCapture`` keeps the state before chosen rounds of a run (the
main path's own rounds at its own widths; the run goes through the plain
round, whose states are the kernels' bit for bit: on a card the kernels
run a segment's rounds as one graph, and the host sees no state between
them), ``EveryRound`` before every round; ``CallCapture`` keeps every
call's whole-call form (its arguments, the state before its first
segment, and its outputs after the last) as the kernel path ran it, and
``call_vs_plain`` runs such a call again through the plain loop and
returns each output's largest difference (``sort_vs_torch``, given to it
as ``each_round``, holds the round's sort to torch.sort on every round
of the call); ``lossy`` turns such a
state into one whose table is 1,024 slots (slot collisions everywhere)
and whose store is all but full; ``narrow`` cuts one to its first lanes;
``padded`` leaves a quarter of its lanes alive and lets each lead a
group; ``steps_vs_plain`` runs one round from a state through each kernel and
through the plain steps (``seedscan._chain_probe_plain`` and the rest),
step by step, and returns each kernel's largest difference
(``round_vs_plain``: the same on given launch arguments, so that a
segment's consecutive rounds share them, as chain_scan's do);
``round_work`` counts the bytes and operations each kernel's work
needs on this round's data."""

from __future__ import annotations

import torch

from compseed_tpu_torch.ops import chain_cuda, seeder2
from compseed_tpu_torch.ops import seedscan as tss

_LANE = tss.CHAIN_LANE_KEYS


def clone_state(st: dict) -> dict:
    """A copy of chain_scan's state, its views rebuilt on the copy."""
    out = {n: st[n].clone() for n in _LANE + tss.MEMO_KEYS +
           ("pool", "ctr", "live")}
    out.update(zip(tss.POOL_KEYS, out["pool"]))
    out.update(zip(("fq", "fc", "cursor", "povf"), out["ctr"]))
    return out


class RoundCapture:
    """While active, runs every chain_scan call through the plain round
    (``seedscan._chain_round`` patched; every seeding call eager,
    seeder2.EagerCalls) and keeps (fm, constants, state,
    w, Uw) before the first round of every width of every call, up to
    ``limit`` states, numbered by call: ``states[(call, w)]``.  A round
    loop of another seedscan entry names its entry, its dispatch, its
    plain round, its state's clone and its width (``width(st, sizes)``,
    sizes: the round's arguments after the state).  With
    ``every_round`` set (``EveryRound``) it keeps every round's state,
    keyed by call and by round within the call, from 1."""

    every_round = False

    def __init__(self, limit: int = 8, entry: str = "chain_scan",
                 dispatch: str = "_chain_round",
                 plain: str = "_chain_round_plain", clone=None,
                 width=lambda st, sizes: sizes[0]):
        self.limit = limit
        self.states = {}
        self.calls = 0
        self._names = (entry, dispatch, plain)
        self._clone = clone or clone_state
        self._width = width
        self._rounds = {}

    def __enter__(self):
        self._eager = seeder2.EagerCalls().__enter__()
        entry, dispatch, plain = self._names
        self._entry = getattr(tss, entry)
        self._dispatch = getattr(tss, dispatch)
        plain_round = getattr(tss, plain)

        def call(*a, **kw):
            self.calls += 1
            return self._entry(*a, **kw)

        def rnd(fm, c, st, *sizes):
            key = self.key(st, sizes)
            if key not in self.states and len(self.states) < self.limit:
                self.states[key] = (fm, c, self._clone(st), *sizes)
            return plain_round(fm, c, st, *sizes)

        setattr(tss, entry, call)
        setattr(tss, dispatch, lambda dev: rnd)
        return self

    def key(self, st, sizes) -> tuple:
        """A round's key among the states: (call, width), or (call,
        round) with ``every_round``."""
        if self.every_round:
            r = self._rounds[self.calls] = self._rounds.get(self.calls, 0) + 1
            return self.calls, r
        return self.calls, self._width(st, sizes)

    def __exit__(self, *exc):
        entry, dispatch, _ = self._names
        setattr(tss, entry, self._entry)
        setattr(tss, dispatch, self._dispatch)
        self._eager.__exit__()


class EveryRound(RoundCapture):
    """RoundCapture keeping the state before every round of every
    chain_scan call (not only the first of each width): ``states[(call,
    round)]``."""

    every_round = True

    def __init__(self, limit: int = 128):
        super().__init__(limit)


def _clone_args(x):
    """A call's argument with its tensors cloned (dicts and tuples too)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_args(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_args(v) for v in x)
    return x


# each entry's outputs by name, the memo's keys for chain_scan's dict
CALL_OUTPUTS = dict(
    chain_scan=("pool", "cursor", "ovf", "fq", "fc", "memo", "rnd",
                "alive_hist"),
    walk_pool_chain=("death", "fk", "fl", "fs", "ovf", "calls", "ngrp"))


class CallCapture:
    """While active (and every seeding call eager, seeder2.EagerCalls),
    keeps every call of ``entry`` (chain_scan or walk_pool_chain) as the
    caller's path runs it, up to ``limit``:
    ``calls``, a list of (args, kwargs, outputs), the arguments (the
    state the call's first segment starts from) cloned before the call
    and the outputs cloned after it.  With ``report_rounds`` a
    chain_scan call runs with report_rounds on (its round count and
    live-lane histogram kept; the caller gets what it asked for)."""

    def __init__(self, entry: str = "chain_scan", limit: int = 16,
                 report_rounds: bool = True):
        self.entry, self.limit, self.calls = entry, limit, []
        self.report = report_rounds and entry == "chain_scan"

    def __enter__(self):
        self._eager = seeder2.EagerCalls().__enter__()
        self._fn = fn = getattr(tss, self.entry)

        def call(*a, **kw):
            keep = len(self.calls) < self.limit
            if not keep:
                return fn(*a, **kw)
            a0, kw0 = _clone_args(a), _clone_args(kw)
            kwr = dict(kw, report_rounds=True) if self.report else kw
            kw0 = dict(kw0, **({"report_rounds": True} if self.report
                               else {}))
            out = fn(*a, **kwr)
            self.calls.append((a0, kw0, _clone_args(out)))
            return out[:6] if self.report and not kw.get(
                "report_rounds") else out

        setattr(tss, self.entry, call)
        return self

    def __exit__(self, *exc):
        setattr(tss, self.entry, self._fn)
        self._eager.__exit__()


def _flat_outputs(entry: str, out) -> dict:
    flat = {}
    for name, x in zip(CALL_OUTPUTS[entry], out):
        if isinstance(x, dict):
            flat.update({f"{name}.{k}": v for k, v in x.items()})
        else:
            flat[name] = x
    return flat


def call_vs_plain(entry: str, call, each_round=None) -> dict:
    """One captured call (CallCapture) run again from its arguments
    through the plain loop (the entry's ``_chain_round`` /
    ``_walk_round`` patched to the plain round): {output: max_abs_err}
    of the captured outputs against the plain loop's.  ``each_round(fm,
    c, st, *sizes)``, if given, is called before every plain round with
    its state (which it must not change)."""
    dispatch, plain = dict(
        chain_scan=("_chain_round", "_chain_round_plain"),
        walk_pool_chain=("_walk_round", "_walk_round_plain"))[entry]
    args, kw, out = call
    orig, plain_round = getattr(tss, dispatch), getattr(tss, plain)

    def rnd(fm, c, st, *sizes):
        if each_round is not None:
            each_round(fm, c, st, *sizes)
        return plain_round(fm, c, st, *sizes)

    setattr(tss, dispatch, lambda dev: rnd)
    try:
        ref = getattr(tss, entry)(*_clone_args(args), **_clone_args(kw))
    finally:
        setattr(tss, dispatch, orig)
    got, want = _flat_outputs(entry, out), _flat_outputs(entry, ref)
    if set(got) != set(want):
        raise ValueError(f"{entry}: outputs {sorted(got)} against "
                         f"{sorted(want)}")
    return {n: max_err(got[n], want[n]) for n in want}


def sort_check(rd, build, errs: list) -> None:
    """The round's sort (``build.sort``) of the keys its first kernel
    left, against torch.sort(key, stable=True): one max_abs_err over
    sorted_key and order appended to ``errs``."""
    build.sort(rd)
    sc = rd.scratch
    want_key, want_order = torch.sort(sc["key"], stable=True)
    errs.append(max(max_err(sc["sorted_key"], want_key),
                    max_err(sc["order"], want_order)))


def sort_vs_torch(build=chain_cuda):
    """An ``each_round`` for call_vs_plain: the round's keys by the probe
    kernel on a copy of the plain loop's state, sorted by the round's sort, against torch.sort; ``errs``
    collects one max_abs_err a round."""
    def check(fm, c, st, w, Uw):
        rd = build.ChainRound(fm, c, clone_state(st), w, Uw)
        build.probe(rd)
        sort_check(rd, build, check.errs)

    check.errs = []
    return check


def lossy(case, H: int = 1024, room: int = 200):
    """The same round over the table's first H slots (a chain key's slot
    is its hash masked to H, so every entry kept stays findable) and a
    store with ``room`` free rows: slot collisions and a full store."""
    fm, const, st, w, Uw = case
    st = clone_state(st)
    st["tbl"] = st["tbl"][:H].clone()
    M = st["cst"].shape[0]
    st["cur"].fill_(max(M - room, int(st["cur"])))
    return fm, const, st, w, Uw


def narrow(case, n: int):
    """The same round cut to its first ``n`` lanes, n // 2
    representatives."""
    fm, const, st, w, _ = case
    st = clone_state(st)
    for k in _LANE:
        st[k] = st[k][:n].clone()
    st["live"] = st["alive"].sum().to(st["live"].dtype)
    return fm, const, st, n, n // 2


def padded(case, every: int = 4):
    """The same round with every lane free to lead a group (Uw = w) and
    only every ``every``-th lane alive: at most w / every groups, so the
    pads past n_w are most of the representatives."""
    fm, const, st, w, _ = case
    st = clone_state(st)
    lanes = torch.arange(w, device=st["alive"].device)
    st["alive"] &= lanes % every == 0
    st["live"] = st["alive"].sum().to(st["live"].dtype)
    return fm, const, st, w, w


def max_err(a, b) -> int:
    """The largest absolute difference of two integer tensors of one
    shape (0 when empty)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


def steps_vs_plain(case, build=chain_cuda) -> dict:
    """One round from the case's state through each kernel and through its
    plain step, each kernel fed what the plain steps computed before it:
    {kernel: max_abs_err over its outputs}, plus the round's data
    (``stats``: hits, applied lanes, pushes, n_u, n_w, stored reps).
    ``build`` launches the kernels (``probe``, ``group``, ``apply`` of a
    ``ChainRound``): chain_cuda's own, or another build of the source."""
    fm, const, st0, w, Uw = case
    ks, ps = clone_state(st0), clone_state(st0)
    rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
    return round_vs_plain(fm, const, rd, ks, ps, w, Uw, build)[0]


def round_vs_plain(fm, const, rd, ks, ps, w, Uw, build=chain_cuda) -> tuple:
    """steps_vs_plain's round on the launch arguments ``rd`` (a
    ChainRound over the kernels' state ``ks``) and the plain steps' state
    ``ps``: (its dict, the plain state after the round).  Called again
    with the same ``rd`` and that state, it runs a segment's next round
    on the same launch arguments, as chain_scan does."""
    sc = rd.scratch
    errs = {}

    build.probe(rd)
    pr = tss._chain_probe_plain(fm, const, ps)
    hit = pr["hit"]
    errs["chain_probe_kernel"] = max(
        max_err(sc["p_wv"], pr["wv"]), max_err(sc["p_slot"], pr["slot"]),
        max_err(sc["p_hit"], hit), max_err(sc["key"], pr["key"]),
        max_err(sc["p_ptr"][hit], pr["ptr"][hit]),
        max_err(sc["p_hk0"][hit], pr["hk0"][hit]),
        max_err(sc["p_hln"][hit], pr["hln"][hit]))

    order = torch.argsort(pr["key"], stable=True)
    sc["order"].copy_(order)
    build.group(rd)
    gr = tss._chain_group_plain(ps, pr, order, Uw)
    n_w = int(gr["n_w"])
    M = ps["cst"].shape[0]
    stored = max(0, min(n_w, M - int(ps["cur"])))
    errs["chain_group_kernel"] = max(
        max_err(sc["gidx"], gr["gidx"]),
        *(max_err(sc[n], gr[n]) for n in ("rep_wv", "rep_k", "rep_l",
                                          "rep_s", "rep_valid", "rep_slot")),
        max_err(sc["sc"][[0, 1, 3, 7]], torch.stack(
            [gr["n_w"], ps["cur"].to(torch.int64), gr["n_u"],
             ps["cursor"].to(torch.int64)])),
        max_err(ks["cur"], ps["cur"] + stored))

    walk = tss._chain_walk(fm, gr["rep_wv"], const["W"], gr["rep_k"],
                           gr["rep_l"], gr["rep_s"], gr["rep_valid"])
    rd.set_walk(*walk)
    build.apply(rd)
    ps2 = tss._chain_apply_plain(fm, const, ps, pr, gr, walk, w, Uw)
    errs["chain_apply_kernel"] = max(
        *(max_err(ks[n], ps2[n]) for n in _LANE + tss.MEMO_KEYS +
          tss.POOL_KEYS),
        max_err(ks["ctr"], torch.stack([ps2["fq"], ps2["fc"],
                                        ps2["cursor"],
                                        ps2["povf"].to(torch.int32)])),
        max_err(rd.live, ps2["alive"].sum()))
    applied = hit | (pr["miss"] & (gr["gidx"] < gr["n_w"]))
    lived = applied & ps2["alive"]
    respawned = lived & (ps2["pivot"] != ps["pivot"])
    rs = gr["rep_slot"][:stored]
    errs["stats"] = dict(
        w=w, Uw=Uw, live=int(ps["alive"].sum()), hits=int(hit.sum()),
        misses=int(pr["miss"].sum()),
        hit_rows=int(pr["ptr"][hit].unique().numel()),
        applied=int(applied.sum()), lived=int(lived.sum()),
        respawned=int(respawned.sum()),
        pushes=int(ps2["cursor"]) - int(ps["cursor"]),
        n_u=int(gr["n_u"]), n_w=n_w, stored=stored,
        tbl_rows=int((rs[1:] != rs[:-1]).sum()) + 1 if stored else 0,
        advance=bool(const["advance"]),
        ovf=bool(ps2["povf"]), H=ps["tbl"].shape[0], M=M)
    return errs, ps2


def round_work(stats: dict, es: int, W: int) -> dict:
    """What each kernel's work needs on a round's data (``stats`` of
    steps_vs_plain; es: the index type's size): kernel -> (bytes, integer
    operations).  Bytes: each input the kernel needs read once and each
    output written once, counted by distinct element.

    probe, per lane: its read id (lane_rid, not lane0 or lane_rid0),
    its read's window word, pos, l, s, alive (not pivot or k), and its
    outputs; a table row per live lane; per
    pad (a representative past n_w, lane 0's): six outputs.
    group, per lane: its sorted position and key, its group index
    written; per live miss: window, l and s (a miss's sorted predecessor
    is a miss too); per representative below n_w: k and slot read, six
    outputs.
    apply, per lane: alive, hit and group index; per applied lane: its
    state and per-read constants; per hit: ptr, k0, len, and each store
    row it reads once however many hits share it; per representative
    that walked: its walk (3 W words), length and k, once however many
    lanes apply it; per stored representative: the store row written and
    the inputs of its table row, and per table row written 8 words; per
    stopped lane (with ``advance``): its next pivot, and per respawn its
    base; the state each lane changes (a lane that goes through writes
    k, l, s, pos; a respawn also pivot; a lane that stops writes alive);
    six pool words per push.  Operations, per lane: the probe's slot
    hash and compares 40; the group's head test and scan 16; the
    apply's scan 4, its chain pick, re-base and push / stop rule
    12 + 8 W for an applied lane, and 8 per push."""
    w, Uw, live = stats["w"], stats["Uw"], stats["live"]
    applied, pushes = stats["applied"], stats["pushes"]
    hits, n_w, stored = stats["hits"], stats["n_w"], stats["stored"]
    lived, respawned = stats["lived"], stats["respawned"]
    through = lived - respawned
    stops = applied - through
    rep = 8 + 3 * es + 1 + 4                # a representative's six outputs
    probe = w * (4 + 4 + 8 + 2 * es + 1) + live * 8 * es + \
        w * (8 + 4 + 1 + 4 + es + 4 + 4) + (Uw - n_w) * rep
    group = w * (8 + 4 + 4) + stats["misses"] * (8 + 2 * es) + \
        n_w * (es + 4 + rep)
    apply = w * (1 + 1 + 4) + \
        applied * (3 * es + 4 + 4 + 4 + 4 + 4 + 4 + es) + \
        hits * (4 + es + 4) + stats["hit_rows"] * 3 * W * es + \
        Uw + n_w * (3 * W * es + 4 + es) + \
        stored * (3 * W * es + 8 + 2 * es + 4) + \
        stats["tbl_rows"] * 8 * es + \
        (stops * 4 if stats["advance"] else 0) + respawned + \
        through * (3 * es + 4) + respawned * (3 * es + 8) + \
        (applied - lived) + pushes * 6 * es
    return dict(chain_probe_kernel=(probe, 40 * w),
                chain_group_kernel=(group, 16 * w),
                chain_apply_kernel=(apply, 8 * w + applied * (12 + 8 * W)
                                    + 8 * pushes))
