"""Rounds of walk_pool_chain for checking the kernels of csrc/walk_chain.cu
against their plain steps (used by chip_smoke.py and
tests/test_torch_cuda.py).

``RoundCapture`` keeps the state before the first round of each width of
each walk_pool_chain call while a run goes through the plain round (the
main path's own rounds at its own widths; chain_cases says why the plain
round); ``sort_vs_torch`` holds the round's sort to torch.sort on every
round of a call that chain_cases.call_vs_plain runs again; ``forced`` writes into
such a state the forms a run rarely shows: two lanes whose keys collide
while their (window, k, s) differ, a live lane whose key is INT32_MAX and
one that follows a dead lane of the same (window, k, s); ``capped``
gives a round fewer representatives than groups; ``narrow`` cuts one to
its first lanes; ``padded`` leaves a quarter of its lanes alive and lets
each lead a group; ``width`` walks it W chars a round; ``EveryRound``
keeps the state before every round of a run; ``steps_vs_plain`` runs
one round from a state through each kernel and through the plain steps
(``seedscan._walk_key_plain`` and the rest), step by step, and returns
each kernel's largest difference; ``round_work`` counts the bytes and
operations each kernel's work needs on this round's data."""

from __future__ import annotations

import numpy as np
import torch

from compseed_tpu_torch.ops import chain_cases, walk_cuda
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.chain_cases import max_err

_RESULTS = ("death", "fk", "fl", "fs")
_MIX = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)
_M32 = (1 << 32) - 1


def clone_state(st: dict) -> dict:
    """A copy of walk_pool_chain's state (contiguous), the counters as one
    tensor with calls and ngrp its views."""
    out = {n: st[n].clone(memory_format=torch.contiguous_format)
           for n in tss.WALK_LANE_KEYS + _RESULTS + ("live",)}
    out["ctr"] = torch.stack([st["calls"], st["ngrp"]]).to(torch.int32)
    out["calls"], out["ngrp"] = out["ctr"]
    return out


class RoundCapture(chain_cases.RoundCapture):
    """While active, runs every walk_pool_chain call through the plain
    round and keeps (fm, constants, state, Uw) before the first round of
    every width of every call, up to ``limit`` states, numbered by call
    and keyed by the lane count: ``states[(call, n)]``."""

    def __init__(self, limit: int = 8):
        super().__init__(limit, "walk_pool_chain", "_walk_round",
                         "_walk_round_plain", clone_state,
                         lambda st, sizes: st["k"].shape[0])


def sort_vs_torch(build=walk_cuda):
    """chain_cases.sort_vs_torch for walk_pool_chain: the round's keys by
    the key kernel on a copy of the plain loop's state, sorted by the round's
    sort, against torch.sort; ``errs`` collects one max_abs_err a
    round."""
    def check(fm, c, st, Uw):
        rd = build.WalkRound(fm, c, clone_state(st), Uw)
        build.key(rd)
        chain_cases.sort_check(rd, build, check.errs)

    check.errs = []
    return check


class EveryRound(RoundCapture):
    """RoundCapture keeping the state before every round (not only the
    first of each width), numbered by call and by round within the call,
    from 1: ``states[(call, round)]``."""

    every_round = True

    def __init__(self, limit: int = 64):
        super().__init__(limit)


def mix_np(rw, k, s) -> np.ndarray:
    """The sort key's 32-bit mix (walk_chain.cu's walk_mix) in numpy, for
    int64 arrays: window words, k and s sign-extended."""
    def fold(x):
        return (x & _M32) ^ ((x >> 31) & _M32)
    m = ((rw & _M32) ^ ((fold(k) * _MIX[0]) & _M32) ^
         ((fold(s) * _MIX[1]) & _M32)).astype(np.uint64)
    return (((m ^ (m >> np.uint64(15))) * np.uint64(_MIX[2])) &
            np.uint64(_M32)).astype(np.int64)


def key_collision(rw: int, hi: int, rng) -> tuple:
    """Two (k, s) pairs with k in [1, hi), s in [1, 64], that differ while
    the keys of (rw, k, s) agree (mix >> 1): a birthday search."""
    while True:
        n = 1 << 18
        k = rng.integers(1, hi, n, dtype=np.int64)
        s = rng.integers(1, 65, n, dtype=np.int64)
        key = mix_np(np.full(n, rw, np.int64), k, s) >> 1
        order = np.argsort(key, kind="stable")
        ks = key[order]
        same = np.nonzero((ks[1:] == ks[:-1]) &
                          ((k[order][1:] != k[order][:-1]) |
                           (s[order][1:] != s[order][:-1])))[0]
        if same.size:
            a, b = order[same[0]], order[same[0] + 1]
            return (int(k[a]), int(s[a])), (int(k[b]), int(s[b]))


def max_key_window(hi: int, rng) -> tuple:
    """(rw, k, s) whose key is INT32_MAX (mix >> 1 == 2^31 - 1), with k in
    [1, hi), s in [1, 64] and rw a 24-bit window word: the last multiply
    and the xorshift are inverted and rw solved for."""
    inv = pow(_MIX[2], -1, 1 << 32)
    while True:
        k = int(rng.integers(1, hi))
        s = int(rng.integers(1, 65))
        for target in (0xFFFFFFFE, 0xFFFFFFFF):
            m = (target * inv) & _M32           # m ^ (m >> 15)
            m ^= m >> 15
            m ^= m >> 30                        # its inverse
            rw = m ^ ((k * _MIX[0]) & _M32) ^ ((s * _MIX[1]) & _M32)
            if rw < 1 << 24:
                return rw, k, s


def forced(case, seed: int = 0):
    """The round with lanes 0-4 rewritten (their pool rows kept): lanes 0
    and 1 share a window and their keys but not their (k, s), so their
    group splits; lane 2 is dead and lane 3, live, has its (window, k, s)
    and the key INT32_MAX, so it joins the group before lane 2; lane 4,
    live, has the key INT32_MAX and heads a group of its own among the
    dead lanes.  The windows are written into a copy of rwflat.  Needs
    five live lanes."""
    fm, const, st, Uw = case
    st = clone_state(st)
    const = dict(const, rwflat=const["rwflat"].clone())
    if int(st["alive"][:5].sum()) < 5:
        raise ValueError("forced: the round needs lanes 0-4 alive")
    rng = np.random.default_rng(seed)
    hi = fm.seq_len - 70                   # k + s - 1 stays in the BWT
    L, rwflat = const["L"], const["rwflat"]
    n_rw = rwflat.shape[0]
    if n_rw < 3:
        raise ValueError("forced: rwflat needs three window words")
    # lanes 0 and 1 read window word f0, lanes 2 and 3 f0 + 1, lane 4
    # f0 + 2 (distinct words, the last two rewritten)
    f0 = min(int(st["rid"][0]) * L + int(st["i"][0].clamp(0, L - 1)),
             n_rw - 3)
    for j, f in ((0, f0), (1, f0), (3, f0 + 1), (4, f0 + 2)):
        st["rid"][j], st["i"][j] = f // L, f % L
    (k0, s0), (k1, s1) = key_collision(int(rwflat[f0]), hi, rng)
    for j, (k, s) in ((0, (k0, s0)), (1, (k1, s1))):
        st["k"][j], st["s"][j] = k, s
    for j in (3, 4):
        rw, k, s = max_key_window(hi, rng)
        rwflat[f0 + j - 2] = rw
        st["k"][j], st["s"][j] = k, s
    for n in ("rid", "i", "k", "s"):
        st[n][2] = st[n][3]
    st["alive"][2] = False
    st["live"] = st["alive"].sum()
    key = tss._walk_key_plain(const, st)["key"]
    if not (key[0] == key[1] and key[3] == key[4] == 2**31 - 1 and
            (k0, s0) != (k1, s1)):
        raise AssertionError("forced: the forms did not come out")
    return fm, const, st, Uw


def capped(case, Uw: int = 64):
    """The same round with ``Uw`` representatives (fewer than its groups):
    the groups past them wait a round."""
    fm, const, st, _ = case
    return fm, const, clone_state(st), Uw


def narrow(case, n: int):
    """The same round cut to its first ``n`` lanes, n // 2
    representatives."""
    fm, const, st, _ = case
    st = clone_state(st)
    for k in tss.WALK_LANE_KEYS:
        st[k] = st[k][:n].clone()
    st["live"] = st["alive"].sum()
    return fm, const, st, max(n // 2, 1)


def padded(case, every: int = 4):
    """The same round with every lane free to lead a group (Uw = w) and
    only every ``every``-th lane alive, lanes 0-4 as they were (the forced
    forms rewrite them): at most about w / every groups, so the pads past
    n_w are most of the representatives."""
    fm, const, st, _ = case
    st = clone_state(st)
    lanes = torch.arange(st["alive"].shape[0], device=st["alive"].device)
    st["alive"] &= (lanes % every == 0) | (lanes < 5)
    st["live"] = st["alive"].sum()
    return fm, const, st, st["alive"].shape[0]


def width(case, W: int):
    """The same round walked W chars a round (the low W chars of each
    window word): another width of the apply's chain rows."""
    fm, const, st, Uw = case
    return fm, dict(const, W=W), clone_state(st), Uw


def steps_vs_plain(case, build=walk_cuda) -> dict:
    """One round from the case's state through each kernel and through its
    plain step, each kernel fed the sort of the plain keys: {kernel:
    max_abs_err over its outputs} (the group minima on the walked
    representatives' rows), plus the round's data (``stats``).
    ``build`` launches the kernels (``key``, ``group``, ``apply`` of a
    ``WalkRound``): walk_cuda's own, or another build of the source."""
    fm, const, st0, Uw = case
    W = const["W"]
    ks, ps = clone_state(st0), clone_state(st0)
    rd = walk_cuda.WalkRound(fm, const, ks, Uw)
    sc = rd.scratch
    errs = {}

    build.key(rd)
    kr = tss._walk_key_plain(const, ps)
    errs["walk_key_kernel"] = max(max_err(sc["rw"], kr["rw"]),
                                  max_err(sc["key"], kr["key"]))

    order = torch.argsort(kr["key"], stable=True)
    sc["order"].copy_(order)
    build.group(rd)
    gr = tss._walk_group_plain(ps, kr, order, Uw)
    n_w = int(gr["n_w"])
    errs["walk_group_kernel"] = max(
        max_err(sc["gidx"], gr["gidx"]),
        *(max_err(sc[n], gr[n]) for n in ("rep_rw", "rep_k", "rep_l",
                                          "rep_s", "rep_valid")),
        max_err(sc["gmin"][:n_w], gr["gmin"][:n_w]),
        max_err(sc["sc"][[walk_cuda.SC_NW, walk_cuda.SC_NU]],
                torch.stack([gr["n_w"], gr["n_u"]])),
        max_err(ks["ngrp"], ps["ngrp"] + gr["n_w"]))

    walk = tss._chain_walk(fm, gr["rep_rw"], W, gr["rep_k"], gr["rep_l"],
                           gr["rep_s"], gr["rep_valid"], is_back=True,
                           stop_s=gr["gmin"])
    rd.set_walk(*walk)
    build.apply(rd)
    ps2 = tss._walk_apply_plain(const, ps, gr, walk, Uw)
    errs["walk_apply_kernel"] = max(
        *(max_err(ks[n], ps2[n]) for n in tss.WALK_LANE_KEYS + _RESULTS),
        max_err(ks["ctr"], torch.stack([ps2["calls"], ps2["ngrp"]])),
        max_err(rd.live, ps2["live"]))

    alive = ps["alive"]
    vs = alive[order]
    pred = torch.zeros_like(vs)
    pred[:-1] = vs[1:]
    walked = alive & (gr["gidx"] < gr["n_w"])
    died = walked & ~ps2["alive"]
    # what the apply reads of the chains: per group the s column up to its
    # members' last test, and the k and l columns its members keep
    grp = gr["gidx"].clamp(0, Uw - 1)
    lng = walk[3][grp]
    GP = ps["death"].shape[0]
    dj = torch.where(died, ps["i"] - ps2["death"][
        ps["slot"].to(torch.int64).clamp(0, GP - 1)], W)
    tested = torch.where(died, torch.minimum(lng, dj + 1), W)
    cs_words = torch.zeros(Uw, dtype=tested.dtype,
                           device=tested.device).scatter_reduce(
        0, grp[walked], tested[walked], "amax").sum()
    col = torch.where(died, dj - 1, W - 1)
    kept = walked & (col >= 0)
    errs["stats"] = dict(
        w=int(alive.shape[0]), Uw=Uw, live=int(alive.sum()),
        windows=int((ps["i"] >= 0).sum()),
        compared=int((vs | pred).sum()),
        members=int((vs & (gr["gidx"][order] < Uw)).sum()),
        n_u=int(gr["n_u"]), n_w=n_w, walked=int(walked.sum()),
        died=int(died.sum()), died_first=int((died & (dj == 0)).sum()),
        through=int((walked & ~died).sum()),
        cs_words=int(cs_words),
        kept_cols=int((grp[kept] * W + col[kept]).unique().numel()), GP=GP)
    return errs


def round_work(stats: dict, es: int, W: int) -> dict:
    """What each kernel's work needs on a round's data (``stats`` of
    steps_vs_plain; es: the index type's size): kernel -> (bytes, integer
    operations).  Bytes: each input the kernel needs read once and each
    output written once, counted by distinct element.

    key, per lane: alive, rid and i, and its window word and key
    written; per live lane: k and s; per lane at a position >= 0: its
    window word read; per representative slot: the group minimum reset;
    per pad (a representative past n_w, lane 0's): its five outputs
    (window, k, l, s, valid).
    group, per sorted position: its order entry, alive, its group index
    written; window, k and s of each lane a head test reads (the live
    lanes and the lanes just before them in sorted order); mh of each
    member below Uw; per walked representative its five outputs, its l
    read and its minimum written.  apply, per lane: alive; per live lane:
    its group index; per walked lane: its l, i and mh; per walked
    representative: its length and l, and its chain's s column up to the
    last column a member tests (``cs_words`` in all), once however many
    lanes apply it; the k and l words of each distinct chain column a
    member keeps (``kept_cols``: the one before its death, or the last);
    per representative slot: valid; per death: its slot read, the four
    words of its pool row and alive written, and its own k and s read
    when it dies at its first step (``died_first``: the state before the
    death is the lane's own; a later death keeps a chain column); per
    survivor: k, l, s and i written (its new k, l and s come from the
    chain).  Operations: the key's mix and window index 20 a lane;
    the group's head test and scan 16 a position and its min 4 a member;
    the apply's 4 a lane and 12 + 8 W a walked lane."""
    w, Uw, live = stats["w"], stats["Uw"], stats["live"]
    n_w, walked = stats["n_w"], stats["walked"]
    rep = 8 + 3 * es + 1                    # a representative's outputs
    key = w * (1 + 4 + 4) + live * 2 * es + stats["windows"] * 8 + \
        w * (8 + 4) + Uw * es + (Uw - n_w) * rep
    group = w * (8 + 1 + 4) + stats["compared"] * (8 + 2 * es) + \
        stats["members"] * es + n_w * (rep + 2 * es)
    apply = w + live * 4 + walked * (2 * es + 4) + \
        n_w * (4 + es) + stats["cs_words"] * es + \
        stats["kept_cols"] * 2 * es + Uw + \
        stats["died"] * (4 + 4 + 3 * es + 1) + \
        stats["died_first"] * 2 * es + stats["through"] * (3 * es + 4)
    return dict(walk_key_kernel=(key, 20 * w),
                walk_group_kernel=(group, 16 * w + 4 * stats["members"]),
                walk_apply_kernel=(apply, 4 * w + walked * (12 + 8 * W)))
