"""The lockstep engines' scan and walk-stage calls and fwd_staged's
forward stages, for holding scan_lanes_kernel, walk_stage_kernel,
walk_stage_entry_kernel and fwd_stage_kernel (csrc/lockstep.cu) to their
plain versions and for counting what a call's work needs (used by
chip_smoke.py and the tests).

``Capture`` keeps the calls of ``seedscan._scan_lanes``, of
``lockstep_cuda.WalkLoop.run`` (a stage's loop: walk_stage's, or a stage
of walk_pool's) and of ``seedscan._fwd_stage_walk`` (a stage of
forward_scan_dedup) while it is active: ``calls``, a list of
``ScanCall``, ``WalkCall`` and ``FwdCall`` with their inputs cloned; each
call still runs as it would.  ``run(call, route)`` runs one again by
"kernel" or "plain": a scan by ``seedscan._scan_lanes_kernel`` or
``_scan_lanes_plain``; a stage by a new WalkLoop, or by its plain version,
``walk_entry_plain`` (the entry: the source's live lanes compacted, pads
after them) and ``seedscan._walk_stage_plain``; a forward stage by
``seedscan._fwd_stage_walk_kernel`` or ``_fwd_stage_walk_plain``;
``vs_plain`` holds the kernel to the plain version (a scan's cnt, ovf,
rows < cnt and the pools built from both: ``scan_vs``; a forward stage's
pf everywhere, its other records where j < steps: ``fwd_vs``);
``entry_vs_plain`` a stage's entry alone.  ``HostTwin``
is the source built with g++ into its host loops; ``launch`` runs a walk
or forward-stage launch by them (what the CPU tests put in place of
``lockstep_cuda._launch``); ``work`` counts, from the host loops' record
of a call, the distinct occ rows its extensions read and their bytes, the
lanes' bytes in and out (with a forward stage's records), the ranks and
words ranked, and each lane's dependent extensions (the longest lane's
set the latency floor).
"""

from __future__ import annotations

import contextlib
import ctypes as ct
import dataclasses
import glob
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import torch

from compseed_tpu_torch.ops import lockstep_cuda
from compseed_tpu_torch.ops import seedscan as ss
from compseed_tpu_torch.ops.cuda_lib import (BUILD, Poisoned, launcher_of,
                                             sentinel)

KEPT = 64                   # calls of each kind a Capture keeps


@dataclasses.dataclass
class ScanCall:
    """One _scan_lanes call: the index, L, capl, advance and (q, rlen,
    pivot0, min_hits, active)."""
    fm: object
    L: int
    capl: int
    advance: bool
    args: tuple

    kind = "scan"

    @property
    def lanes(self) -> int:
        return self.args[0].shape[0]


@dataclasses.dataclass
class WalkCall:
    """One stage's loop: its loop's constants (the index, L, max_steps,
    the bases, the widest stage), t before it, fit, and either its lanes
    (``st``: a call's first stage) or its source's (``src``, with
    ``live_in`` its live count) and its width ``w``."""
    fm: object
    L: int
    max_steps: int
    qflat: object
    rwflat: object
    width: int
    t0: int
    fit: int
    w: int
    st: dict | None
    src: dict | None
    live_in: int | None

    kind = "walk"

    @property
    def lanes(self) -> int:
        return self.w


@dataclasses.dataclass
class FwdCall:
    """One forward stage (_fwd_stage_walk's arguments): the index, the
    bases qflat and nxtflat, L, B, the representatives ``state``, ``mh``,
    advance and the mode's ``kw`` (mode, min_len, max_intv)."""
    fm: object
    qflat: object
    nxtflat: object
    L: int
    B: int
    state: dict
    mh: object
    advance: bool
    kw: dict

    kind = "fwd"

    @property
    def lanes(self) -> int:
        return self.state["k"].shape[0]

    def args(self) -> tuple:
        return (self.fm, self.qflat, self.nxtflat, self.L, self.B,
                self.state, self.mh, self.advance)


class Capture:
    """While active, keeps up to KEPT calls of each kind, in order, in
    ``calls``; every call is counted in ``counts``."""

    def __init__(self):
        self.calls = []
        self.counts = dict(scan=0, walk=0, fwd=0)

    def _keep(self, kind) -> bool:
        self.counts[kind] += 1
        return sum(c.kind == kind for c in self.calls) < KEPT

    def __enter__(self):
        self._scan = ss._scan_lanes
        self._run = lockstep_cuda.WalkLoop.run
        cap = self

        def scan(fm, L, capl, advance, *args):
            if cap._keep("scan"):
                cap.calls.append(ScanCall(fm, L, capl, advance, tuple(
                    a.clone() for a in args)))
            return cap._scan(fm, L, capl, advance, *args)

        def run(lp, st, fit, src=None):
            if cap._keep("walk"):
                w = st["alive"].shape[0]
                rw = lp.args[lp.AT["rwflat"]]
                cap.calls.append(WalkCall(
                    lp.fm, int(lp.args[lp.AT["L"]]),
                    int(lp.args[lp.AT["rcap"]]),
                    None if rw else lp.bases, lp.bases if rw else None,
                    lp.width, int(lp.t), int(fit), w,
                    None if src is not None else
                    {n: x.clone() for n, x in st.items()},
                    None if src is None else
                    {n: x.clone() for n, x in src.items()},
                    None if src is None else int(lp.live)))
            return cap._run(lp, st, fit, src)

        self._fwd = ss._fwd_stage_walk

        def fwd(fm, qflat, nxtflat, L, B, state, mh, advance, **kw):
            if cap._keep("fwd"):
                cap.calls.append(FwdCall(
                    fm, qflat.clone(), nxtflat.clone(), L, B,
                    {n: x.clone() for n, x in state.items()}, mh.clone(),
                    advance, dict(kw)))
            return cap._fwd(fm, qflat, nxtflat, L, B, state, mh, advance,
                            **kw)

        ss._scan_lanes = scan
        lockstep_cuda.WalkLoop.run = run
        ss._fwd_stage_walk = fwd
        return self

    def __exit__(self, *exc):
        ss._scan_lanes = self._scan
        lockstep_cuda.WalkLoop.run = self._run
        ss._fwd_stage_walk = self._fwd


class _Merge(Exception):
    """Raised in place of a run's merge (run_forward)."""


def run_forward(sd, fns, qd, rd) -> None:
    """DeviceSeeder ``sd``'s eager _run of the programs ``fns`` on one
    chunk's reads up to its merge: rounds 1 to 3 run, with every forward
    stage of the staged engine; the merge, the merged suffix-array lookup
    and the pack do not.  On a chunk that overflows fwd_staged's rep caps,
    the seeds of the garbage intervals it carries send the suffix-array
    walk to positions past the text, and at int64 some of those walks
    never reach a sampled row: the JAX package's sa_batch_compact loops
    on them as the port's does, so a capture of the forward stages stops
    before it."""
    def merge(*a):
        raise _Merge
    try:
        sd._run(dict(fns, merge=merge), qd, rd)
    except _Merge:
        return
    raise RuntimeError("run_forward: the run did not reach its merge")


def walk_entry_plain(src: dict, w: int) -> dict:
    """The plain version of the walk entry's compaction: src's live lanes
    first, in their order (at most w), then pads: dead, slot -1, the rest
    0 (seedscan._compact_lanes)."""
    st = dict(src)
    slot = src["slot"]
    ss._compact_lanes(st, lockstep_cuda.LANE_KEYS, w,
                      {"slot": slot.new_full((1,), -1)})
    st.pop("live")
    return st


def run(call, route: str):
    """One captured call again by "kernel" or "plain": a scan's (lep, cnt,
    ovf); a stage's (lanes, t, live), by the kernels t and live one int32
    each on the device (read by nothing here, so that the call can be
    captured), by the plain version Python ints; a forward stage's dict
    (the state and the records)."""
    if call.kind == "fwd":
        fn = ss._fwd_stage_walk_kernel if route == "kernel" else \
            ss._fwd_stage_walk_plain
        return fn(*call.args(), **call.kw)
    if call.kind == "scan":
        fn = ss._scan_lanes_kernel if route == "kernel" else \
            ss._scan_lanes_plain
        return fn(call.fm, call.L, call.capl, call.advance, *call.args)
    if route == "kernel":
        lp = lockstep_cuda.WalkLoop(call.fm, call.L, call.max_steps,
                                    call.qflat, call.rwflat, call.t0,
                                    call.width)
        if call.src is None:
            st = lp.lanes(call.st)
        else:
            st = lp.empty_lanes(call.w)
            lp.live.fill_(call.live_in)
        lp.run(st, call.fit, call.src)
        return st, lp.t, lp.live
    st = dict(call.st) if call.src is None else \
        walk_entry_plain(call.src, call.w)
    st, t = ss._walk_stage_plain(call.fm, call.qflat, call.L, call.max_steps,
                                 st, call.t0, call.fit, call.rwflat)
    return st, int(t), int(st["alive"].sum())


def _err(g, w) -> int:
    """max |g - w| of two tensors of one shape and dtype (1 << 62 if they
    differ in either), w moved to g's device."""
    if g.shape != w.shape or g.dtype != w.dtype:
        return 1 << 62
    if not g.numel():
        return 0
    return int((g.to(torch.int64) - w.to(g.device).to(torch.int64)).abs()
               .max())


def scan_vs(got, want) -> int:
    """max |got - want| over a scan's outputs (0: equal): cnt and ovf
    exactly, each lane's rows < cnt (every row once cnt is capl); the rows
    past cnt are unspecified (the kernel's contract: it does not write
    them).  Also the pools ``seedscan.build_pool`` makes of both, every
    row (GP = R * capl, so that the invalid rows after n_valid are all
    there), exactly: what the engines read of a scan."""
    (lep_g, cnt_g, ovf_g), (lep_w, cnt_w, ovf_w) = got, want
    if lep_g.shape != lep_w.shape or lep_g.dtype != lep_w.dtype:
        return 1 << 62
    worst = max(_err(cnt_g, cnt_w), _err(ovf_g, ovf_w))
    R, capl, _ = lep_w.shape
    cnt = cnt_w.to(lep_g.device).to(torch.int64)
    mask = (torch.arange(capl, device=lep_g.device)[None, :] <
            cnt[:, None])[..., None]
    worst = max(worst, _err(torch.where(mask, lep_g, 0),
                            torch.where(mask, lep_w.to(lep_g.device), 0)))
    GP = max(R * capl, 1)
    pools = [ss.build_pool(lep, c, GP)
             for lep, c in ((lep_g, cnt_g), (lep_w.to(lep_g.device),
                                            cnt_w.to(lep_g.device)))]
    for a, b in zip(*pools):
        worst = max(worst, _err(a, b))
    return worst


def fwd_vs(got: dict, want: dict) -> int:
    """max |got - want| over a forward stage's outputs (0: equal): the
    state exactly, pf exactly (so false past a lane's steps), the other
    records where j < steps; past the steps those are unspecified (the
    kernel's contract: it does not write them)."""
    if set(got) != set(want):
        return 1 << 62
    steps = want["steps"].to(torch.int64)
    B = want["pf"].shape[1]
    mask = torch.arange(B, device=steps.device)[None, :] < steps[:, None]
    worst = 0
    for n in want:
        g, w = got[n], want[n].to(got[n].device)
        if g.shape != w.shape or g.dtype != w.dtype:
            return 1 << 62
        if not g.numel():
            continue
        g, w = g.to(torch.int64), w.to(torch.int64)
        if n in lockstep_cuda.FWD_RECORDS and n != "pf":
            m = mask.to(g.device)
            g, w = torch.where(m, g, 0), torch.where(m, w, 0)
        worst = max(worst, int((g - w).abs().max()))
    return worst


def vs_plain(call) -> int:
    """max |kernel - plain| over the call's outputs (0: bit-equal; a
    scan's as ``scan_vs``, a forward stage's as ``fwd_vs``), the kernel's
    outputs from ``cuda_lib.empty`` poisoned before its launch
    (cuda_lib.Poisoned)."""
    with Poisoned():
        got = run(call, "kernel")
    want = run(call, "plain")
    if call.kind == "fwd":
        return fwd_vs(got, want)
    if call.kind == "scan":
        return scan_vs(got, want)
    if [int(x) for x in got[1:]] != list(want[1:]) or \
            set(got[0]) != set(want[0]):
        return 1 << 62
    return max((_err(got[0][n], want[0][n]) for n in want[0]), default=0)


def entry_vs_plain(call: WalkCall, epoch: int = 1000) -> int:
    """A stage's entry alone (``walk_stage_entry_kernel`` as the stage's
    loop launches it, outside any graph) against
    the plain version: the stage's lanes (a compaction's filled with
    cuda_lib.sentinel's values first: walk_entry_plain's; a count's, the
    stage's own, untouched), the live word (min(live, w)), go (the loop's
    test at t0) and the epoch, ``epoch`` before and one more after; the
    ticket and the retire word left 0.  max abs err (0: equal)."""
    lp = lockstep_cuda.WalkLoop(call.fm, call.L, call.max_steps, call.qflat,
                                call.rwflat, call.t0, call.width)
    if call.src is None:
        st = lp.lanes(call.st)
        want = call.st
    else:
        st = lp.empty_lanes(call.w)
        for x in st.values():
            x.fill_(sentinel(x.dtype))
        lp.live.fill_(call.live_in)
        want = walk_entry_plain(call.src, call.w)
    lp._point(st, call.fit, call.src)
    sc = lp.sc.view(torch.int32)
    sc[2] = epoch
    lockstep_cuda._launch("walk_stage_entry_kernel", lp.dev, lp.args)
    live = int(want["alive"].sum())
    go = int(call.t0 < call.max_steps and live > call.fit)
    words = [int(sc[0]) - live, int(lp.go) - go, int(sc[2]) - epoch - 1,
             int(sc[1]), int(lp.sc[2])]
    return max([abs(x) for x in words] +
               [_err(st[n], want[n]) for n in want])


class HostTwin:
    """csrc/lockstep.cu built with g++ into its host loops (scan_lanes_host,
    walk_stage_host, walk_stage_entry_host, walk_stage_trace_host,
    fwd_stage_host, fwd_stage_trace_host) in ``so`` (rebuilt when the
    source or a header beside it is newer)."""

    def __init__(self, so: str | None = None):
        src = lockstep_cuda.LIB.src
        self.so = so or os.path.join(BUILD, "liblockstep_host.so")
        deps = [src] + glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))
        if not os.path.exists(self.so) or os.path.getmtime(self.so) < max(
                map(os.path.getmtime, deps)):
            os.makedirs(os.path.dirname(self.so), exist_ok=True)
            tmp = f"{self.so}.tmp.{os.getpid()}"
            subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                            "-shared", "-fPIC", "-o", tmp, src], check=True,
                           capture_output=True)
            os.replace(tmp, self.so)
        lib = self.lib = ct.CDLL(self.so)
        p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
        lib.scan_lanes_host.argtypes = [p, ll, p, ll, i] + \
            [p, i, p, p, p, i, p, i, i, p, p, p, ll, i, p, ll, p, p]
        lib.walk_stage_trace_host.argtypes = [p, p, ll, p, p]
        lib.fwd_stage_trace_host.argtypes = [p, p, ll, p, p]
        for fn in (lib.walk_stage_host, lib.walk_stage_entry_host,
                   lib.fwd_stage_host):
            fn.argtypes = [p]
        for fn in (lib.scan_lanes_host, lib.walk_stage_host,
                   lib.walk_stage_entry_host, lib.walk_stage_trace_host,
                   lib.fwd_stage_host, lib.fwd_stage_trace_host,
                   lib.lockstep_walk_args_words,
                   lib.lockstep_fwd_args_words):
            fn.restype = i
        self.trace = None           # (pos, n_pos, steps) while work records

    def scan(self, fm, L, capl, advance, q, rlen, pivot0, min_hits, active,
             trace=False):
        """seedscan._scan_lanes' outputs by the host loop, on CPU tensors
        (with ``trace`` also the positions ranked and each lane's
        extensions); lep is filled with cuda_lib.sentinel's value before
        the call, so that the rows past cnt, which the loop does not
        write (the kernel's contract), hold no zeros."""
        occ = fm.occ_packed.cpu().contiguous()
        L2 = fm.L2.cpu().contiguous()
        R = q.shape[0]
        arrs = [q.cpu().contiguous(), rlen.to(torch.int32).cpu().contiguous(),
                pivot0.to(torch.int32).cpu().contiguous(),
                (min_hits if min_hits.dtype in (torch.int32, torch.int64)
                 else min_hits.to(torch.int32)).cpu().contiguous(),
                active.to(torch.bool).cpu().contiguous()]
        dt = fm.dtype
        lep = torch.full((R, capl, 5), sentinel(dt), dtype=dt)
        cnt, ovf = torch.empty(R, dtype=dt), torch.empty(R, dtype=dt)
        steps = np.zeros(R, np.int32)
        n_pos = ct.c_longlong(0)
        pos = np.empty(0, np.int64)
        for _ in range(2 if trace else 1):   # count, then record
            rec = [pos.ctypes.data, len(pos), ct.addressof(n_pos),
                   steps.ctypes.data] if trace else [None, 0, None, None]
            steps[:] = 0
            e = self.lib.scan_lanes_host(
                occ.data_ptr(), fm.n_rows, L2.data_ptr(), int(fm.primary),
                int(bool(fm.fill_oob)), arrs[0].data_ptr(), L,
                arrs[1].data_ptr(), arrs[2].data_ptr(), arrs[3].data_ptr(),
                int(arrs[3].dtype == torch.int64), arrs[4].data_ptr(), capl,
                int(bool(advance)), lep.data_ptr(), cnt.data_ptr(),
                ovf.data_ptr(), R, int(dt == torch.int64), *rec)
            if e:
                raise RuntimeError(f"scan_lanes_host returned {e}")
            if trace and len(pos) < n_pos.value:
                pos = np.empty(n_pos.value, np.int64)
        out = (lep, cnt, ovf)
        return (out, (pos[:n_pos.value], steps)) if trace else out

    def launch(self, kernel: str, dev, args) -> None:
        """A walk or forward-stage launch (``lockstep_cuda._launch``'s
        arguments) by its host loop, on CPU tensors; while ``work``
        records, the segments and stages are recorded."""
        assert dev.type == "cpu", dev
        if kernel in ("walk_stage_kernel", "fwd_stage_kernel") and \
                self.trace is not None:
            pos, n_pos, steps = self.trace
            e = getattr(self.lib, launcher_of(kernel, "_trace_host"))(
                ct.addressof(args), pos.ctypes.data, len(pos),
                ct.addressof(n_pos), steps.ctypes.data)
        else:
            e = getattr(self.lib, launcher_of(kernel, "_host"))(
                ct.addressof(args))
        if e:
            raise RuntimeError(f"{launcher_of(kernel, '_host')} returned {e}")

    @contextlib.contextmanager
    def in_place(self):
        """lockstep_cuda._launch run by the host loops for the block."""
        orig = lockstep_cuda._launch
        lockstep_cuda._launch = self.launch
        try:
            yield self
        finally:
            lockstep_cuda._launch = orig


def _cpu_fm(fm):
    """The index's tables on the CPU, as WalkLoop reads them."""
    return SimpleNamespace(occ_packed=fm.occ_packed.cpu(), n_rows=fm.n_rows,
                           L2=fm.L2.cpu(), primary=fm.primary,
                           fill_oob=fm.fill_oob, dtype=fm.dtype)


def _cpu(x):
    return None if x is None else x.cpu()


def walk_on_host(call: WalkCall, twin: HostTwin, trace=None):
    """A stage's call by the host loops on the CPU (run_loop's CPU branch,
    the twin at lockstep_cuda._launch; ``trace`` (pos, n_pos, steps) to
    record its segments): (lanes, t, live)."""
    cpu = SimpleNamespace(**{f.name: getattr(call, f.name)
                             for f in dataclasses.fields(call)})
    cpu.fm, cpu.qflat, cpu.rwflat = (_cpu_fm(call.fm), _cpu(call.qflat),
                                     _cpu(call.rwflat))
    cpu.kind = "walk"
    cpu.st = None if call.st is None else {n: x.cpu()
                                           for n, x in call.st.items()}
    cpu.src = None if call.src is None else {n: x.cpu()
                                             for n, x in call.src.items()}
    twin.trace = trace
    try:
        with twin.in_place():
            return run(cpu, "kernel")
    finally:
        twin.trace = None


def fwd_on_host(call: FwdCall, twin: HostTwin, trace=None) -> dict:
    """A forward stage by its host loop on the CPU (the kernel route, the
    twin at lockstep_cuda._launch; ``trace`` (pos, n_pos, steps) to
    record it): the kernel's outputs."""
    cpu = dataclasses.replace(
        call, fm=_cpu_fm(call.fm), qflat=call.qflat.cpu(),
        nxtflat=call.nxtflat.cpu(), mh=call.mh.cpu(),
        state={n: x.cpu() for n, x in call.state.items()})
    twin.trace = trace
    try:
        with twin.in_place():
            return run(cpu, "kernel")
    finally:
        twin.trace = None


def work(call, twin: HostTwin) -> dict:
    """What the call's work needs, from the host loops' record of it: the
    distinct occ rows its extensions rank in (row_bytes: 32 B a row, the
    counts and the first plane quarter, 48 B where a rank's offset is 64
    or more), the lanes' bytes in and out (lane_bytes), ranks, words
    ranked (hi / lo word pairs up to each rank's own word), extensions,
    and the lanes' dependent extensions (max_steps, the longest lane's;
    mean_steps over the lanes).  A scan's lanes write the rows they push;
    a stage's entry alone its entry_bytes."""
    fm = call.fm
    es = 8 if fm.dtype == torch.int64 else 4
    if call.kind == "scan":
        (_, cnt, _), (pos, steps) = twin.scan(
            fm, call.L, call.capl, call.advance, *call.args, trace=True)
        q, _, _, mh, _ = call.args
        R = call.lanes
        lane_in = R * call.L + 8 * R + mh.element_size() * R + R
        # the rows each lane pushes (cnt of them), cnt and ovf: what the
        # kernel writes
        lane_out = (int(cnt.sum()) * 5 + 2 * R) * es
    elif call.kind == "fwd":
        steps = np.zeros(call.lanes, np.int32)
        n_pos = ct.c_longlong(0)
        pos = np.empty(0, np.int64)
        for _ in range(2):                  # count, then record
            n_pos.value = 0
            out = fwd_on_host(call, twin, (pos, n_pos, steps))
            if len(pos) < n_pos.value:
                pos = np.empty(n_pos.value, np.int64)
        pos = pos[:n_pos.value]
        U, B = call.lanes, call.B
        # the representatives' words in (k, l, s, mh; pos, pivot, rid;
        # alive) and out (k, l, s; pos, pivot, wait_npv, steps; alive,
        # waiting), a base a step in (the jump targets' words not
        # counted); of the records pf for every column, the other five
        # for the steps taken (what the stage needs: nothing past them)
        n_steps = int(out["steps"].sum())
        lane_in = U * (4 * es + 12 + 1) + n_steps
        lane_out = U * (3 * es + 16 + 2) + U * B + n_steps * (3 * es + 8)
    else:
        steps = np.zeros(call.w, np.int32)
        n_pos = ct.c_longlong(0)
        pos = np.empty(0, np.int64)
        for _ in range(2):                  # count, then record
            steps[:] = 0
            n_pos.value = 0
            walk_on_host(call, twin, (pos, n_pos, steps))
            if len(pos) < n_pos.value:
                pos = np.empty(n_pos.value, np.int64)
        pos = pos[:n_pos.value]
        src = call.src if call.src is not None else call.st
        # every lane word read once and written once, the bases a lane
        # reads (a window word a segment, or a code a step) in
        n_src = src["alive"].shape[0]
        lane_words = 4 * es + 5 * 4 + 1
        lane_in = n_src * lane_words + int(steps.sum()) * (
            8 if call.rwflat is not None else 1)
        lane_out = call.w * lane_words
        # the entry alone: the source's alive bytes; with a source, the
        # kept lanes' words read and every lane of the stage written
        entry_bytes = n_src + (min(int(src["alive"].sum()), call.w) *
                               lane_words + lane_out
                               if call.src is not None else 0)
    k = pos[pos != -1]
    k = k - (k >= int(fm.primary))
    n = int(fm.n_rows)
    blk = k >> 7
    blk = np.where(blk < 0, blk + n, blk)
    off = k & 127
    rows = np.unique(blk)
    high = np.unique(blk[off >= 64])
    row_bytes = 32 * len(rows) + 16 * len(high)
    more = dict(entry_bytes=entry_bytes) if call.kind == "walk" else {}
    return dict(kind=call.kind, lanes=call.lanes, rows=int(len(rows)),
                row_bytes=int(row_bytes),
                lane_bytes=int(lane_in + lane_out + 5 * es),
                bytes=int(row_bytes + lane_in + lane_out + 5 * es),
                ranks=int(len(k)), words_ranked=int(((off >> 5) + 1).sum()),
                extensions=int(len(pos) // 2),
                max_steps=int(steps.max(initial=0)),
                mean_steps=float(steps.mean()) if len(steps) else 0.0,
                **more)
