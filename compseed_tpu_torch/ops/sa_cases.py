"""The boundaries between the stages of sa_batch_compact's suffix-array
walk, for checking sa_stage_entry_kernel (csrc/fm_walk.cu) against its
plain version, ops/fm.py::_sa_boundary_plain (used by chip_smoke.py and
the tests).

``BoundaryCapture`` runs every sa_batch_compact call through its plain
version (every seeding call eager) and keeps every boundary: (the index,
the call's lanes N, the stage s that ended (0-3; after the last, s = 3,
no next stage), the state as the stage left it: kk, steps, alive, slot,
out_steps, out_k (N + 1, the last the drop slot), ovf).  ``source`` gives
a boundary's state in one of ``forms(case)``: as captured, no live lane,
cap // 2, cap and cap + 37 live lanes (ovf set), the live lanes chosen by
a seed.  ``stage_vs_plain`` runs the kernel (on an ``fm_cuda.SaLoop``
whose stage s holds the state, every word it may write filled with
garbage first) and the plain version from one form: max_abs_err over the
outputs, ovf, the next stage's alive bytes and slots (fillers included),
its live lanes' positions and steps, and go at the boundary before the
last stage.  ``stage_work`` counts what the kernel's work needs.

The last stage's loop alone: ``long_rows`` finds the index's longest
walks, ``last_loop`` puts rows into the stage before the last of an
SaLoop and ``run_last_loop`` runs the loop from there (the stage entry
that runs its first test, then the walk with its folded test a round),
for holding the loop's rounds to the plain loop (fm._sa_loop_plain)."""

from __future__ import annotations

import torch

from compseed_tpu_torch.ops import cuda_lib, fm_cuda, seeder2
from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops.chain_cases import max_err

FORMS = ("captured", "no live lane", "half cap live", "cap live",
         "cap + 37 live")
GARBAGE = -7


class BoundaryCapture:
    """While active, runs every sa_batch_compact call through its plain
    version (and every seeding call eager, seeder2.EagerCalls) and keeps
    up to ``limit`` boundaries, in order: ``cases``, a list of (fm, N, s,
    state)."""

    def __init__(self, limit: int = 64):
        self.limit, self.cases = limit, []

    def __enter__(self):
        self._eager = seeder2.EagerCalls().__enter__()
        names = ("_sa_compact", "_sa_batch_compact_plain",
                 "_sa_boundary_plain")
        self._orig = {n: getattr(dfm, n) for n in names}
        call = {}

        def plain(fm, k):
            call.update(fm=fm, s=0)
            return self._orig["_sa_batch_compact_plain"](fm, k)

        def boundary(st, N, cap):
            if N and len(self.cases) < self.limit:
                self.cases.append((call["fm"], N, call["s"],
                                   {n: v.clone() for n, v in st.items()}))
            call["s"] += 1
            return self._orig["_sa_boundary_plain"](st, N, cap)

        dfm._sa_batch_compact_plain = plain
        dfm._sa_boundary_plain = boundary
        dfm._sa_compact = lambda dev: plain
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(dfm, n, fn)
        self._eager.__exit__()


def next_width(case):
    """The next stage's lanes after a boundary; None after the last."""
    _, N, s, _ = case
    return fm_cuda.sa_widths(N)[s + 1] if s < 3 else None


def forms(case) -> tuple:
    """The FORMS a boundary takes: each whose live lanes fit its stage
    (after the last stage, as captured and no live lane)."""
    return tuple(f for f in FORMS if _live_of(case, f) is None or
                 _live_of(case, f) <= case[3]["alive"].shape[0])


def _live_of(case, form: str):
    w = next_width(case)
    if form in ("captured", "no live lane"):
        return None if form == "captured" else 0
    if w is None:
        return 1 << 62                    # no cap: the form does not apply
    return {"half cap live": w // 2, "cap live": w,
            "cap + 37 live": w + 37}[form]


def source(case, form: str, seed: int = 19) -> dict:
    """A boundary's state in one of forms(case): a copy, the alive bytes
    of every form but "captured" set (that many live lanes, chosen by
    ``seed`` among all the stage's lanes)."""
    st = {n: v.clone() for n, v in case[3].items()}
    live = _live_of(case, form)
    if live is not None:
        n = st["alive"].shape[0]
        g = torch.Generator().manual_seed(seed)
        alive = torch.zeros(n, dtype=torch.bool)
        alive[torch.randperm(n, generator=g)[:live]] = True
        st["alive"] = alive.to(st["alive"].device)
    return st


def plain(case, src: dict) -> dict:
    """The plain version of the boundary on a copy of ``src``: the state
    after it."""
    st = {n: v.clone() for n, v in src.items()}
    dfm._sa_boundary_plain(st, case[1], next_width(case))
    return st


def stage_loop(case, src: dict) -> fm_cuda.SaLoop:
    """An SaLoop whose stage s holds ``src`` (its slots as int32; the
    first stage's are the lane indices, which the kernel takes for
    granted), its outputs and ovf the state's from the second boundary
    on (the first writes every output and sets ovf: garbage there), the
    next stage's lanes and go garbage."""
    fm, N, s, _ = case
    kk0 = src["out_k"][:N].clone()          # untouched before the first
    lp = fm_cuda.SaLoop(fm, kk0, torch.zeros_like(kk0),
                        torch.zeros(N, dtype=torch.bool, device=kk0.device))
    for x, n in zip(lp.lanes[s], ("kk", "steps", "alive", "slot")):
        x.copy_(src[n])
    if s == 0:
        for x in (lp.out_steps, lp.out_k):
            x.fill_(GARBAGE)
        lp.ovf.fill_(True)
    else:
        lp.out_steps.copy_(src["out_steps"][:N])
        lp.out_k.copy_(src["out_k"][:N])
        lp.ovf.copy_(src["ovf"])
    if s < 3:
        for x in lp.lanes[s + 1]:
            x.fill_(True if x.dtype == torch.bool else GARBAGE)
    lp.go.fill_(-1)
    return lp


def stage_vs_plain(case, form: str, launch=None) -> dict:
    """sa_stage_entry_kernel (``launch(lp, s)``; None: the port's,
    ``SaLoop.boundary``) and its plain version from the same form of a
    boundary: {max_abs_err over the outputs, ovf, the next stage's alive
    bytes and slots and its live lanes' kk and steps, go before the last
    stage; live: the stage's live lanes; kept; ovf; go (None but before
    the last stage)}."""
    _, N, s, _ = case
    src = source(case, form)
    lp = stage_loop(case, src)
    (launch or fm_cuda.SaLoop.boundary)(lp, s)
    want = plain(case, src)
    errs = [max_err(lp.out_steps, want["out_steps"][:N]),
            max_err(lp.out_k, want["out_k"][:N]),
            max_err(lp.ovf, want["ovf"])]
    live = int(src["alive"].sum())
    w = next_width(case)
    kept = min(live, w or 0)
    go = None
    if w is not None:
        kk, steps, alive, slot = lp.lanes[s + 1]
        errs += [max_err(alive, want["alive"]), max_err(slot, want["slot"]),
                 max_err(kk[:kept], want["kk"][:kept]),
                 max_err(steps[:kept], want["steps"][:kept])]
        if s == 2:
            go = int(want["alive"].any())
            errs.append(max_err(lp.go, torch.tensor(
                go, device=lp.go.device)))
    return dict(max_abs_err=max(errs), live=live, kept=kept,
                ovf=bool(want["ovf"]), go=go)


def stage_work(case, src: dict) -> tuple:
    """(bytes, operations) the boundary's work needs on a source: the
    alive bytes (and from the second stage on the slots) read; each done
    lane's kk and steps read and written out; each kept lane's words read
    (the first boundary's also its position, and its outputs' first values
    written); the next stage's lanes written once; ovf and go; a compare
    and a scan addition a lane."""
    _, N, s, st = case
    tb = st["kk"].element_size()
    n = src["alive"].shape[0]
    live = int(src["alive"].sum())
    done = int((~src["alive"] & (src["slot"] >= 0)).sum())
    w = next_width(case) or 0
    kept = min(live, w)
    nbytes = n + (4 * n if s else 0) + done * 4 * tb + kept * 2 * tb \
        + (live * 3 * tb if s == 0 else 0) + w * (2 * tb + 5) \
        + (1 if w else 0) + (4 if s == 2 else 0)
    return nbytes, 2 * n


def long_rows(fm, n: int) -> tuple:
    """The n rows of the index whose inverse-Psi walk to a sampled row is
    longest, longest first, and their walks' steps: every row walked to
    its end (fm._walk: the kernel for an index on a card)."""
    k = torch.arange(fm.seq_len, dtype=fm.dtype, device=fm.L2.device)
    kk, steps = k.clone(), torch.zeros_like(k)
    alive = (k & (fm.sa_intv - 1)) != 0
    while bool(alive.any()):
        kk, steps, alive = dfm._walk(fm, kk, steps, alive, 2 * fm.sa_intv)
    order = torch.argsort(steps, descending=True, stable=True)[:n]
    return k[order], steps[order]


def last_loop(fm, rows: torch.Tensor) -> fm_cuda.SaLoop:
    """An SaLoop whose last stage is as wide as ``rows`` (N = 64 of them)
    and whose stage before it holds them: lane i the position rows[i],
    steps 0, alive where unsampled, slot i; every other lane of that
    stage dead with slot -1; ovf clear, the outputs garbage."""
    n = rows.shape[0]
    N = 64 * n
    k0 = torch.zeros(N, dtype=fm.dtype, device=rows.device)
    lp = fm_cuda.SaLoop(fm, k0, torch.zeros_like(k0),
                        torch.zeros(N, dtype=torch.bool, device=rows.device))
    kk, steps, alive, slot = lp.lanes[2]
    for x in (kk, steps, alive):
        x.zero_()
    slot.fill_(-1)
    kk[:n] = rows
    alive[:n] = (rows & (fm.sa_intv - 1)) != 0
    slot[:n] = torch.arange(n, dtype=torch.int32, device=rows.device)
    for x in (lp.out_steps, lp.out_k):
        x.fill_(GARBAGE)
    lp.ovf.fill_(False)
    return lp


def run_last_loop(lp: fm_cuda.SaLoop) -> None:
    """The last stage's loop of ``lp`` as sa_batch_compact runs it
    (cuda_lib.run_loop: on a card one graph, its WHILE node's test set
    by the stage entry, then by the walk's last block a round)."""
    cuda_lib.run_loop(lp, fm_cuda.LIB, "fm", lambda lp: lp.boundary(2),
                      lambda lp: lp.walk(3, loop=True))
