"""The lockstep engines' loops on Hopper: launchers of ``csrc/lockstep.cu``.

The JAX package runs the forward LEP scan, the staged backward walk and
the staged forward walk as device while loops; the port launches
hand-written kernels:

  ``scan``     -> ``scan_lanes_kernel``, for ``ops/seedscan.py::
      _scan_lanes`` (plain version ``_scan_lanes_plain``): a pair of
      threads a lane, each lane's program to its end in one launch, only
      the rows a lane pushes written (``scan``);
  ``WalkLoop`` -> ``walk_stage_entry_kernel`` and ``walk_stage_kernel``,
      for ``ops/seedscan.py::walk_stage`` and ``walk_pool`` (plain version
      ``_walk_stage_plain``, with ``compact_state`` between walk_pool's
      stages): a stage's loop as one CUDA graph loop
      (``cuda_lib.run_loop``), the entry (the previous stage's lanes
      compacted, or the call's counted, and the loop's first test) then a
      WHILE node whose body is one segment, a thread a lane, its two
      occ-row reads of a step issued before either is ranked, the segment
      kernel's last block to retire advancing t and testing the next;
  ``fwd_stage`` -> ``fwd_stage_kernel``, for ``ops/seedscan.py::
      _fwd_stage_walk`` (plain version ``_fwd_stage_walk_plain``): one
      launch a stage of fwd_staged's staged forward walk, a pair of
      threads a representative, each running its steps to its end, a
      warp's records staged in shared memory and stored a segment of 8
      steps at a time; the records are not zeroed (``fwd_stage``).

``ops/seedscan.py`` runs the plain versions for CPU tensors and comes here
for any other; each launcher takes CUDA tensors only and launches its
kernel or raises: nothing falls back from one to the other.  The kernels
read the index's packed occ table (``occ_packed``) as ``fm_walk.cu``'s do,
through ``csrc/fm_rank.cuh``.  The library is ``LIB``, an
``ops/cuda_lib.KernelLibrary`` (built with nvcc for sm_90a at first use
into build/compseed_tpu_torch/liblockstep.so).

``LAUNCHES`` counts kernel launches by kernel, and nothing else.  Every
launch goes to the device its tensors lie on, on that device's current
stream, with no synchronisation; outputs come from ``torch.empty``
(``cuda_lib.empty``: filled with a sentinel under ``cuda_lib.Poisoned``,
for the tests).
"""

from __future__ import annotations

import ctypes as ct

import torch

from compseed_tpu_torch.ops import cuda_lib
from compseed_tpu_torch.ops.cuda_lib import (ENTRY_TILE, KernelLibrary,
                                             bind_graphs, check_tensor, empty)
from compseed_tpu_torch.ops.fm_cuda import _cuda_device, _index_args

# a walk stage's words (csrc/lockstep.cu's struct WalkArgs), in order
WALK_ARGS = ("idx64", "rows", "n_rows", "L2", "primary", "fill_oob",
             "k", "l", "s", "mh", "rid", "i", "death", "slot", "steps",
             "alive", "w", "rwflat", "qflat", "n_q", "L",
             "rnd", "rcap", "nxtw", "seg", "hist", "sc", "lb_entry",
             "src_k", "src_l", "src_s", "src_mh", "src_rid", "src_i",
             "src_death", "src_slot", "src_steps", "src_alive", "src_w",
             "live_in", "cond", "go", "loop")
# a walk stage's lane arrays: index type, int32, bool
LANES_T = ("k", "l", "s", "mh")
LANES_I32 = ("rid", "i", "death", "slot", "steps")
LANE_KEYS = LANES_T + LANES_I32 + ("alive",)
# a forward stage's words (csrc/lockstep.cu's struct FwdArgs), in order
FWD_ARGS = ("idx64", "rows", "n_rows", "L2", "primary", "fill_oob",
            "k", "l", "s", "mh", "pos", "pivot", "rid", "alive", "U",
            "qflat", "nxtflat", "n_q", "L", "B",
            "r3", "advance", "min_len", "max_intv",
            "out_k", "out_l", "out_s", "out_pos", "out_pivot",
            "out_wait_npv", "out_steps", "out_alive", "out_waiting",
            "pf", "pk", "pl", "ps", "pe", "pp")
# a forward stage's representatives: index type, int32, bool
FWD_T = ("k", "l", "s")
FWD_I32 = ("pos", "pivot", "rid")
# what a forward stage returns beside its inputs' rid: the state, then
# the records
FWD_STATE = ("k", "l", "s", "pos", "pivot", "wait_npv", "steps", "alive",
             "waiting")
FWD_RECORDS = ("pf", "pk", "pl", "ps", "pe", "pp")
KERNELS = ("scan_lanes_kernel", "walk_stage_kernel",
           "walk_stage_entry_kernel", "fwd_stage_kernel")
MAX_SEG = 8                 # a packed reverse window's chars


def _bind(lib) -> None:
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    index = [p, ll, p, ll, i]       # rows, n_rows, L2, primary, oob
    lib.scan_lanes_launch.argtypes = index + \
        [p, i, p, p, p, i, p, i, i, p, p, p, ll, i, p]
    lib.scan_lanes_launch.restype = i
    for fn in (lib.walk_stage_launch, lib.walk_stage_entry_launch,
               lib.fwd_stage_launch):
        fn.argtypes, fn.restype = [p, p], i
    bind_graphs(lib, "lockstep")
    for name in ("fwd_stage_occupancy", "scan_lanes_occupancy",
                 "walk_stage_occupancy", "walk_stage_entry_occupancy"):
        if hasattr(lib, name):                    # an earlier build has none
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [i, ll, p], i
    for what, names in (("walk", WALK_ARGS), ("fwd", FWD_ARGS)):
        words = getattr(lib, f"lockstep_{what}_args_words")
        words.argtypes, words.restype = [], i
        if words() != len(names):
            raise RuntimeError(f"lockstep_{what}_args_words() says its "
                               f"struct has {words()} words, the launchers "
                               f"name {len(names)}")


LIB = KernelLibrary("lockstep.cu", KERNELS, _bind, "lockstep_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build
_launch = LIB.launch_args


def scan(fm, L: int, capl: int, advance: bool, q, rlen, pivot0, min_hits,
         active):
    """The lockstep LEP scan of every lane by ``scan_lanes_kernel``: q (R,
    L) uint8, rlen and pivot0 (R,) int32, min_hits (R,) int32 or int64,
    active (R,) bool, all contiguous on one card (checked, never
    converted) -> (lep (R, capl, 5), cnt (R,), ovf (R,)) in the index
    dtype, as ``seedscan._scan_lanes_plain`` where it matters: cnt, ovf
    and each lane's rows < cnt (all capl once cnt reaches capl); the rows
    past cnt are unspecified (the plain version's zeros there are read by
    nothing: ``seedscan.build_pool`` writes the pool's invalid rows as
    zeros itself).  The outputs come from the caching allocator and
    nothing zeroes them."""
    dev = _cuda_device("scan", q.device)
    R = q.shape[0] if q.dim() == 2 else -1
    check_tensor("q", q, torch.uint8, (R, L), dev)
    if L < 1 or capl < 1:
        raise ValueError(f"scan: L={L} and capl={capl} must be at least 1")
    check_tensor("rlen", rlen, torch.int32, (R,), dev)
    check_tensor("pivot0", pivot0, torch.int32, (R,), dev)
    if min_hits.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"min_hits has dtype {min_hits.dtype}, expected "
                        f"int32 or int64")
    check_tensor("min_hits", min_hits, min_hits.dtype, (R,), dev)
    check_tensor("active", active, torch.bool, (R,), dev)
    index = _index_args(fm, dev)
    dt = fm.dtype
    lep = empty((R, capl, 5), dt, dev)
    cnt = empty(R, dt, dev)
    ovf = empty(R, dt, dev)
    if R:
        LIB.launch("scan_lanes_kernel", dev, "scan_lanes_launch", *index,
                   q.data_ptr(), L, rlen.data_ptr(), pivot0.data_ptr(),
                   min_hits.data_ptr(), int(min_hits.dtype == torch.int64),
                   active.data_ptr(), capl, int(bool(advance)),
                   lep.data_ptr(), cnt.data_ptr(), ovf.data_ptr(), R,
                   int(dt == torch.int64))
    return lep, cnt, ovf


def _index_words(fm, dev) -> list:
    """The index's words: on a card after the index's checks (64-byte
    rows); the CPU tests' host loops read the rows as they lie."""
    if dev.type == "cuda":
        return _index_args(fm, dev)
    return [fm.occ_packed.data_ptr(), fm.n_rows, fm.L2.data_ptr(),
            int(fm.primary), int(bool(fm.fill_oob))]


def fwd_stage(fm, qflat, nxtflat, L: int, B: int, state: dict, mh,
              advance: bool, r3: bool, min_len: int = 0,
              max_intv: int = 0) -> dict:
    """One stage of the staged forward walk by ``fwd_stage_kernel``: the
    representatives ``state`` (k, l, s in the index dtype; pos, pivot, rid
    int32; alive bool; U each) and ``mh`` (U,) in the index dtype, the
    bases qflat (uint8) and nxtflat (int32) of the (R, L) reads, flat,
    all contiguous on one device (checked, never converted) -> the state
    after at most B steps a lane (FWD_STATE, rid the input's) and the
    records (FWD_RECORDS, (U, B)), as ``seedscan._fwd_stage_walk_plain``
    (round 3's greedy segment with ``r3``) where it matters: pf in every
    column (false from a lane's steps on), pk, pl, ps, pe and pp where j <
    steps, unspecified after (the plain version's frozen values there
    have pf false, and forward_scan_dedup drops every such record).  The
    outputs come from the caching allocator (inside a call graph's
    capture, from its pool), ``_records`` the records, and nothing zeroes
    them.  A CPU tensor reaches ``_launch``, which refuses it unless a
    test put a host loop there."""
    dev = state["k"].device
    dt = fm.dtype
    U = state["k"].shape[0] if state["k"].dim() == 1 else -1
    if L < 1 or B < 1:
        raise ValueError(f"fwd_stage: L={L} and B={B} must be at least 1")
    n_q = qflat.shape[0] if qflat.dim() == 1 else -1
    check_tensor("qflat", qflat, torch.uint8, (n_q,), dev)
    check_tensor("nxtflat", nxtflat, torch.int32, (n_q,), dev)
    if n_q < 1:
        raise ValueError("fwd_stage: no bases")
    for n in FWD_T:
        check_tensor(n, state[n], dt, (U,), dev)
    for n in FWD_I32:
        check_tensor(n, state[n], torch.int32, (U,), dev)
    check_tensor("alive", state["alive"], torch.bool, (U,), dev)
    check_tensor("mh", mh, dt, (U,), dev)
    i32, b8 = torch.int32, torch.bool
    out = {n: empty(U, dt if n in FWD_T else b8 if n in (
        "alive", "waiting") else i32, dev) for n in FWD_STATE}
    out["rid"] = state["rid"]
    out.update(_records(U, B, dt, dev))
    if U == 0:
        return out
    args = (ct.c_longlong * len(FWD_ARGS))()
    at = {n: i for i, n in enumerate(FWD_ARGS)}
    for name, x in zip(("rows", "n_rows", "L2", "primary", "fill_oob"),
                       _index_words(fm, dev)):
        args[at[name]] = x
    for name in FWD_T + FWD_I32 + ("alive",):
        args[at[name]] = state[name].data_ptr()
    for name in FWD_STATE:
        args[at[f"out_{name}"]] = out[name].data_ptr()
    for name in FWD_RECORDS:
        args[at[name]] = out[name].data_ptr()
    for name, x in (("idx64", int(dt == torch.int64)),
                    ("mh", mh.data_ptr()), ("U", U),
                    ("qflat", qflat.data_ptr()),
                    ("nxtflat", nxtflat.data_ptr()), ("n_q", n_q),
                    ("L", L), ("B", B), ("r3", int(bool(r3))),
                    ("advance", int(bool(advance))),
                    ("min_len", int(min_len)), ("max_intv", int(max_intv))):
        args[at[name]] = x
    _launch("fwd_stage_kernel", dev, args)
    return out


def _records(U: int, B: int, dt: torch.dtype, dev) -> dict:
    """A forward stage's record arrays (FWD_RECORDS, (U, B) each: pf bool,
    pk, pl, ps ``dt``, pe, pp int32), uninitialised."""
    return {n: empty((U, B), torch.bool if n == "pf" else dt if n in (
        "pk", "pl", "ps") else torch.int32, dev) for n in FWD_RECORDS}


def occupancy(kernel: str, dtype: torch.dtype, dev) -> dict:
    """What card ``dev`` gives ``kernel`` (``scan_lanes_kernel``,
    ``walk_stage_kernel``, ``walk_stage_entry_kernel`` or
    ``fwd_stage_kernel``) over an index of ``dtype``:
    ``KernelLibrary.occupancy``'s numbers."""
    entry = kernel.replace("_kernel", "_occupancy")
    return LIB.occupancy(entry, dtype == torch.int64, 0, torch.device(dev))


class WalkLoop:
    """The staged backward walk of one ``walk_stage`` or ``walk_pool``
    call on the kernels: the index ``fm``, the read length ``L``, the
    call's ``max_steps``, the bases (``rwflat``, int64 packed reverse
    windows, or, when None, ``qflat``, uint8 codes) and ``t0``, the steps
    already spent (an int, or one int32 on the device); ``width``: the
    widest stage's lanes.  Allocates, at its construction (outside any
    loop's capture), ``t`` (one int32: the steps spent, which every stage
    advances), its scan words (``sc``: the live count, ``live``, the
    entry's ticket and epoch, the stage kernel's 64-bit retire word), the
    entry's look-back words and ``go`` (the condition's last value).
    ``run(st, fit, src)`` runs one stage on the lanes ``st`` (LANE_KEYS,
    as ``lanes`` or ``empty_lanes`` make them) by ``cuda_lib.run_loop``:
    the entry (``src``: the previous stage's lanes, compacted into st's;
    None: st's own counted) and the stage's segments while t < max_steps
    and more than ``fit`` lanes live; on a card one graph, captured,
    launched and freed here, or joining a call's capture.  ``args`` (the
    struct WalkArgs, one 64-bit word a field, ``AT``: field -> word;
    ``AT["cond"]`` the condition handle), ``go``, ``dev`` and ``graph`` are
    what run_loop reads."""

    AT = {n: i for i, n in enumerate(WALK_ARGS)}
    graph = None

    def __init__(self, fm, L: int, max_steps: int, qflat, rwflat, t0,
                 width: int):
        dev = (qflat if rwflat is None else rwflat).device
        if L < 1 or max_steps < 0:
            raise ValueError(f"WalkLoop: L={L}, max_steps={max_steps}")
        self.fm, self.dev, self.dt = fm, dev, fm.dtype
        i32 = torch.int32
        if isinstance(t0, torch.Tensor):
            check_tensor("t0", t0, i32, (), dev)
            self.t = t0.clone()
        else:
            self.t = torch.full((), int(t0), dtype=i32, device=dev)
        if rwflat is None:
            bases = qflat.contiguous()
            check_tensor("qflat", bases, torch.uint8, (bases.numel(),), dev)
        else:
            bases = rwflat.contiguous()
            check_tensor("rwflat", bases, torch.int64, (bases.numel(),), dev)
        if bases.numel() < 1:
            raise ValueError("WalkLoop: no bases")
        self.bases = bases
        self.sc = torch.zeros(3, dtype=torch.int64, device=dev)
        self.live = self.sc.view(i32)[0]
        self.lb = torch.zeros(max(-(-width // ENTRY_TILE), 1),
                              dtype=torch.int64, device=dev)
        self.go = torch.zeros((), dtype=i32, device=dev)
        self.args = (ct.c_longlong * len(WALK_ARGS))()
        for name, x in zip(("rows", "n_rows", "L2", "primary", "fill_oob"),
                           _index_words(fm, dev)):
            self.args[self.AT[name]] = x
        for name, x in (("idx64", int(self.dt == torch.int64)),
                        ("rwflat", 0 if rwflat is None else bases.data_ptr()),
                        ("qflat", bases.data_ptr() if rwflat is None else 0),
                        ("n_q", bases.numel()), ("L", L),
                        ("rnd", self.t.data_ptr()), ("rcap", max_steps),
                        ("seg", max(1, min(MAX_SEG, max_steps))),
                        ("hist", 0), ("sc", self.sc.data_ptr()),
                        ("lb_entry", self.lb.data_ptr()),
                        ("go", self.go.data_ptr()), ("loop", 1)):
            self.args[self.AT[name]] = x
        self.width = width

    def _dtype(self, name: str) -> torch.dtype:
        """The dtype of lane array ``name``."""
        return self.dt if name in LANES_T else torch.bool \
            if name == "alive" else torch.int32

    def lanes(self, state: dict) -> dict:
        """The lanes of ``state`` (LANE_KEYS, ``steps`` optional) as the
        kernels read them: contiguous copies in the index dtype, int32 and
        bool (the caller's tensors are never written)."""
        extra = set(state) - set(LANE_KEYS)
        if extra:
            raise ValueError(f"WalkLoop: unknown lane arrays {sorted(extra)}")
        return {n: x.to(self._dtype(n)).clone(
                    memory_format=torch.contiguous_format)
                for n, x in state.items()}

    def empty_lanes(self, w: int) -> dict:
        """w uninitialised lanes of every array (an entry with a source
        writes them all)."""
        return {n: torch.empty(w, dtype=self._dtype(n), device=self.dev)
                for n in LANE_KEYS}

    def _point(self, st: dict, fit: int, src) -> int:
        """Set the stage's words: its lanes, fit and its source's."""
        w = st["alive"].shape[0] if st["alive"].dim() else -1
        if not 0 <= w <= self.width:
            raise ValueError(f"WalkLoop: a stage of {w} lanes, at most "
                             f"{self.width}")
        for n in LANE_KEYS:
            if n == "steps" and n not in st:
                self.args[self.AT[n]] = 0
                continue
            check_tensor(n, st[n], self._dtype(n), (w,), self.dev)
            self.args[self.AT[n]] = st[n].data_ptr()
        src_w = 0
        if src is not None:
            src_w = src["alive"].shape[0]
            if not w <= src_w <= self.width or "steps" not in st:
                raise ValueError(f"WalkLoop: a source of {src_w} lanes for "
                                 f"{w}, with steps")
            for n in LANE_KEYS:
                check_tensor(f"src {n}", src[n], st[n].dtype, (src_w,),
                             self.dev)
                self.args[self.AT[f"src_{n}"]] = src[n].data_ptr()
        self.args[self.AT["src_w"]] = src_w
        self.args[self.AT["live_in"]] = self.live.data_ptr() if src_w else 0
        self.args[self.AT["w"]] = w
        self.args[self.AT["nxtw"]] = int(fit)
        self.args[self.AT["cond"]] = 0
        self._keep = (st, src)            # the words' tensors, alive
        return w

    def run(self, st: dict, fit: int, src=None) -> None:
        """One stage's loop on the lanes ``st`` (updated in place): the
        entry, then segments while t < max_steps and live > ``fit``;
        ``live`` then holds the stage's live lanes and ``t`` the steps
        spent.  A stage of no lanes runs nothing."""
        if self._point(st, fit, src) == 0:
            return
        cuda_lib.run_loop(
            self, LIB, "lockstep",
            lambda lp: _launch("walk_stage_entry_kernel", lp.dev, lp.args),
            lambda lp: _launch("walk_stage_kernel", lp.dev, lp.args))
        self.close()            # the next stage's words are its own

    def close(self) -> None:
        """Free the stage's graph (after its last launch)."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None
