"""The port's libraries of hand-written CUDA kernels: build, load, launch,
and the round loops' CUDA graphs.

A ``KernelLibrary`` is one source under ``compseed_tpu_torch/csrc/``,
built with nvcc for sm_90a at first use into
build/compseed_tpu_torch/lib<source>.so (rebuilt when the source or a
header beside it, ``csrc/*.cuh``, is newer) and loaded once per process
with ctypes.  Its C launchers take the CUDA stream as their last
argument and return the CUDA error code;
``launch`` calls one with the tensors' device current in the calling
thread and that device's current stream, raises on a non-zero code and
counts the launch in ``launches``, and counts nothing else.  Worker
threads of the sharded path launch side by side, so the counts and the
one-time load take a lock.

A round source (chain_scan.cu, walk_chain.cu) runs a segment of its loop
as one ``LoopGraph`` (csrc/loop_graph.cuh): an entry kernel (a round
source's segment entry, csrc/compact.cuh: the previous segment's lanes
compacted into the segment's, ``RoundArgs.entry``), then a WHILE node
whose body is one round's launches, captured once from the calling
thread and replayed on the card until its last kernel (a round source's
apply; the suffix-array walk's fm_inv_psi_walk_kernel) clears the
condition; fm_walk.cu runs the suffix-array walk's last stage the same
way, its entry the stage entry kernel before it, and lockstep.cu each
stage of the lockstep walk (its entry kernel, then a segment a round).
``run_loop`` builds and launches it, or, inside the capture of a whole
call (``CallGraph``: the seeder's call as one torch.cuda.CUDAGraph), adds
the loop to that capture; ``NoTorchOps`` guards every body's
capture.  ``Kept`` keeps such graphs per (thread, call shape).
``NoHostReads`` is the CPU tests' guard for what a capture refuses on a
card: host reads and shape-dependent operations.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes as ct
import gc
import glob
import os
import shutil
import subprocess
import sys
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build", "compseed_tpu_torch")
# csrc/compact.cuh: the lanes a block of the segment entry takes (blocks of
# kEntryBlock threads, kEntryItems lanes each)
ENTRY_TILE = 512
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc(src: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to build "
                       f"{src}")


def compile_source(src: str, so: str, defines: tuple = (),
                   includes: tuple = ()) -> str:
    """nvcc ``src`` into the shared library ``so`` with NVCC_FLAGS, the
    given -D defines and -I directories (searched after ``src``'s own);
    returns nvcc's output (ptxas' registers, shared memory and spills of
    every kernel).  Raises if nvcc fails."""
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(src), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           *(f"-I{d}" for d in includes), "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)           # atomic: a loaded old copy stays valid
    return r.stdout + r.stderr


def sentinel(dtype: torch.dtype, byte: int = 0x5A):
    """The value of ``dtype`` whose every byte is ``byte`` (True for bool):
    what ``Poisoned`` fills outputs with."""
    if dtype == torch.bool:
        return True
    size = torch.empty((), dtype=dtype).element_size()
    return int.from_bytes(bytes([byte]) * size, "little", signed=True)


def empty(shape, dtype, device) -> torch.Tensor:
    """torch.empty for a kernel's outputs; inside ``Poisoned`` (in the
    calling thread) filled with its sentinel, so that a test sees every
    word the kernel was to write written."""
    x = torch.empty(shape, dtype=dtype, device=device)
    byte = getattr(_TLS, "poison", None)
    if byte is not None:
        x.fill_(sentinel(dtype, byte))
    return x


class Poisoned:
    """Kernel outputs from ``empty`` filled with the byte ``byte`` in every
    word (True for bool) while active in the calling thread."""

    def __init__(self, byte: int = 0x5A):
        self.byte = byte

    def __enter__(self):
        self.was = getattr(_TLS, "poison", None)
        _TLS.poison = self.byte
        return self

    def __exit__(self, *exc):
        _TLS.poison = self.was


def check_tensor(name, x, dtype, shape, dev) -> None:
    """Raise unless ``x`` has ``dtype`` and ``shape``, is contiguous and
    lies on ``dev``: what a launcher checks of a kernel argument."""
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")


def launcher_of(kernel: str, suffix: str = "_launch") -> str:
    """The C entry of a round source's kernel (or library call):
    ``<name>_launch`` for ``<name>_kernel`` or ``<name>``; ``suffix``
    "_host" names its host loop."""
    return kernel.removesuffix("_kernel") + suffix


def bind_round(lib, kernels, args_words: str, names,
               prefix: bool = False, graphs: str | None = None) -> None:
    """Bind a round source's launchers (``<kernel>_launch`` for each
    ``<kernel>_kernel``: its Args words and a stream, returning the CUDA
    error code) and check that its struct Args (``args_words`` names the
    C function that gives its size in words) has one word for each of
    ``names``; with ``prefix``, for each of the first of them (another
    build of the source whose launchers read only their own words).
    ``graphs``: the prefix of its loop-graph entries, bound too."""
    for kernel in kernels:
        fn = getattr(lib, launcher_of(kernel))
        fn.argtypes = [ct.c_void_p, ct.c_void_p]
        fn.restype = ct.c_int
    if graphs:
        bind_graphs(lib, graphs)
        fn = getattr(lib, f"{graphs}_sort_bytes")
        fn.argtypes, fn.restype = [ct.c_longlong, ct.c_int], ct.c_longlong
    words = getattr(lib, args_words)
    words.argtypes = []
    words.restype = ct.c_int
    if not (0 < words() <= len(names) if prefix else
            words() == len(names)):
        raise RuntimeError(f"{args_words}() says struct Args has {words()} "
                           f"words, the launchers name {len(names)}")


def bind_graphs(lib, prefix: str) -> None:
    """Bind a source's loop-graph entries, ``<prefix>_graph_*``
    (csrc/loop_graph.cuh's LOOP_GRAPH_ENTRIES)."""
    p, pp = ct.c_void_p, ct.POINTER(ct.c_void_p)
    handle = ct.POINTER(ct.c_ulonglong)
    for name, args, res in (
            ("streams", [pp, pp], ct.c_int),
            ("begin", [p, p, pp, handle], ct.c_int),
            ("nest", [p, p, pp, handle], ct.c_int),
            ("body", [p, ct.c_ulonglong], ct.c_int),
            ("end", [p], ct.c_int), ("launch", [p, p], ct.c_int),
            ("nodes", [p, ct.POINTER(ct.c_int)], ct.c_int),
            ("close", [p], None)):
        fn = getattr(lib, f"{prefix}_graph_{name}")
        fn.argtypes, fn.restype = args, res


class RoundArgs:
    """What the launch arguments of a round's kernels share
    (chain_cuda.ChainRound, walk_cuda.WalkRound): ``args``, the source's
    struct Args as one 64-bit word a field (``AT``: field -> word), kept
    at fixed addresses from round to round: every word a round changes
    lives in device memory, so one set of words serves every round of a
    segment and a graph of them.  An instance sets ``args``, ``dev``,
    ``w`` (its lanes), ``Uw``, ``W``, ``scratch`` and ``_held`` (its
    state's tensors, ``k`` among them, and its lane arrays, ``LANE_KEYS``);
    ``init_sort`` and ``set_loop`` add the sort's and the loop's words,
    ``set_walk`` the walk's; ``launch(kernel)`` launches one of its
    source's kernels on them, ``entry`` the segment's entry kernel
    (``ENTRY``)."""

    AT: dict = {}
    LANE_KEYS: tuple = ()   # the lane arrays the segment entry moves
    ENTRY = ""              # the source's segment entry kernel
    ENTRY_LB = ""           # the scratch look-back words it may share
    pads: dict = {}         # lane name -> a pad lane's value (default 0)
    graph = None            # the segment's LoopGraph, once run on a card
    _src = None             # the previous segment's lanes, once set_loop

    def init_sort(self, bits: int, sort_bytes) -> None:
        """The round's sort: sorted_key (w) int32, the lane indices iota
        (w) int64 and CUB's temporary storage, ``sort_bytes(w, bits)``
        bytes on a card (none on the CPU, whose host build sorts in
        place), allocated once here, outside any capture."""
        dev, w = self.dev, self.w
        nbytes = int(sort_bytes(w, bits)) if dev.type == "cuda" else 0
        s = self.scratch
        s["sorted_key"] = torch.empty(w, dtype=torch.int32, device=dev)
        s["iota"] = torch.arange(w, dtype=torch.int64, device=dev)
        s["sort_tmp"] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                    device=dev)
        for n in ("sorted_key", "iota", "sort_tmp"):
            self.args[self.AT[n]] = s[n].data_ptr()
        self.args[self.AT["sort_bytes"]] = nbytes
        self.args[self.AT["key_bits"]] = bits
        self.key_bits = bits

    def set_loop(self, rnd, live_in, nxtw: int, rcap: int,
                 hist=None, src=None) -> None:
        """The segment's loop words: ``rnd`` the call's round counter (one
        int32 on the device), the next segment's width, RCAP and the
        live-lane histogram (RCAP int32) or None; the condition's last
        value goes to ``go`` (one int32 of the round's own).  ``src``: the
        previous segment's lane arrays (LANE_KEYS -> its lanes, one width)
        and ``live_in`` its live count (one int32 on the device), which
        the segment's entry compacts into the round's lanes; None for a
        call's first segment (``live_in`` then unread, may be None: the
        entry counts the round's own live lanes).  Sets the loop word: from
        here on the round's apply kernel ends a loop's body, counting the
        round and testing the next (a round without it leaves every loop
        word alone)."""
        i32 = torch.int32
        check_tensor("rnd", rnd, i32, (), self.dev)
        if live_in is not None:
            check_tensor("live_in", live_in, i32, (), self.dev)
        if hist is not None:
            check_tensor("hist", hist, i32, (rcap,), self.dev)
        src_w = 0
        if src is not None:
            if live_in is None:
                raise ValueError("set_loop: a source's lanes need its live "
                                 "count")
            src_w = src["alive"].shape[0] if src["alive"].dim() else 0
            if not self.w <= src_w < 2**31:
                raise ValueError(f"set_loop: a source of {src_w} lanes for "
                                 f"{self.w}")
            for n in self.LANE_KEYS:
                mine = self._held[n]
                check_tensor(f"src {n}", src[n], mine.dtype, (src_w,),
                             self.dev)
                self.args[self.AT[f"src_{n}"]] = src[n].data_ptr()
        # the entry's look-back words, a word a block of its launch: a
        # round's scan's where they are enough (the entry counts the
        # round's epoch on, so the words' tags never repeat), else its own
        need = -(-max(src_w, self.w, 1) // ENTRY_TILE)
        lb = self.scratch[self.ENTRY_LB]
        if lb.shape[0] < need:
            lb = torch.zeros(need, dtype=torch.int64, device=self.dev)
        self.scratch["lb_entry"] = lb
        self.go = torch.zeros((), dtype=i32, device=self.dev)
        self._loop = (rnd, live_in, hist)       # kept alive with the args
        self._src = src
        for n, x in (("rnd", rnd.data_ptr()),
                     ("live_in", 0 if live_in is None else live_in.data_ptr()),
                     ("nxtw", nxtw), ("rcap", rcap),
                     ("hist", 0 if hist is None else hist.data_ptr()),
                     ("cond", 0), ("go", self.go.data_ptr()), ("loop", 1),
                     ("src_w", src_w),
                     ("lb_entry", self.scratch["lb_entry"].data_ptr())):
            self.args[self.AT[n]] = x

    def launch(self, kernel: str) -> None:
        """Launch ``kernel`` of the round's source on its Args words (each
        source's module launcher, which the CPU tests patch)."""
        raise NotImplementedError

    def entry(self) -> None:
        """The segment's entry kernel (``ENTRY``, csrc/compact.cuh) on
        set_loop's words: with a source, its live lanes compacted into
        the round's lanes in their order (at most w; the lanes after them
        pads, dead); without, the round's live lanes counted; then the
        round's live count (the lanes kept) and the loop's test before
        the segment's first round, go and the histogram word, and inside
        a graph the WHILE node's condition."""
        self.launch(self.ENTRY)

    def set_walk(self, ck, cl, cs, ln) -> None:
        """Point the apply kernel at the representatives' walk: ck, cl, cs
        (Uw, W) in the index dtype, ln (Uw,) int32."""
        dt = self._held["k"].dtype
        for name, x, xdt, shape in (("ck", ck, dt, (self.Uw, self.W)),
                                    ("cl", cl, dt, (self.Uw, self.W)),
                                    ("cs", cs, dt, (self.Uw, self.W)),
                                    ("ln", ln, torch.int32, (self.Uw,))):
            check_tensor(name, x, xdt, shape, self.dev)
            self.args[self.AT[name]] = x.data_ptr()
        self._walk = (ck, cl, cs, ln)           # kept alive until replaced

    def walk_out(self) -> tuple:
        """The representatives' walk as the round holds it: ck, cl, cs
        (Uw, W) in the index dtype and ln (Uw,) int32, allocated once (a
        captured walk writes into them every round) and set_walk."""
        dt, dev = self._held["k"].dtype, self.dev
        out = tuple(torch.empty((self.Uw, self.W), dtype=dt, device=dev)
                    for _ in range(3)) + \
            (torch.empty(self.Uw, dtype=torch.int32, device=dev),)
        self.set_walk(*out)
        return out

    def close(self) -> None:
        """Free the segment's graph (after its last launch: a graph still
        running on the card is freed when it ends)."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None


class NoTorchOps(TorchDispatchMode):
    """Raises on any torch operation the calling thread issues while
    active: what guards a capture.  A captured body may launch only the
    port's kernels: a torch allocation in it (every torch operation with
    an output is one, torch.empty included) would give the graph an
    address that the caching allocator can hand to other work while the
    graph still writes there.  A dispatch mode is the thread's own, so the
    alignment tail's allocations on the main thread, beside a seeding
    worker's capture, do not count (the device-wide allocation count of
    torch.cuda.memory_stats would)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} inside a CUDA graph capture: a captured "
                           f"round body must not allocate or run torch "
                           f"operations")


class NoHostReads(TorchDispatchMode):
    """Raises on what a CUDA graph capture refuses, for tensors on any
    device, so that the CPU tests hold a program to what a card can
    capture: a read of a tensor's value by the host (``int(t)``,
    ``bool(t)``, ``t.item()``, ``torch.equal``) and an operation whose
    output shape depends on the values (``nonzero``, ``masked_select``,
    ``unique``, ``repeat_interleave`` without ``output_size``, indexing by
    a bool mask); with ``host_data``, also a tensor made from host data
    (``torch.tensor``, ``torch.as_tensor`` of Python values:
    ``lift_fresh``), which on a card is a copy from pageable host memory
    that a capture refuses (off by default: the plain versions that only
    the CPU runs, inside a kernel route's loop there, make such tensors).
    The loop test of ``run_loop``'s CPU branch, which stands in for a
    graph's conditional node, is let through.  The calling thread's own,
    as every dispatch mode."""

    _READS = ("_local_scalar_dense", "is_nonzero", "equal")

    def __init__(self, host_data: bool = False):
        super().__init__()
        self.host_data = host_data
    _SHAPES = ("nonzero", "masked_select", "unique_dim", "_unique",
               "_unique2", "unique_consecutive", "unique_dim_consecutive")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bad = None
        if name in self._READS and not getattr(_TLS, "loop_test", 0):
            bad = "reads a tensor's value on the host"
        elif name in self._SHAPES or (
                name == "repeat_interleave" and
                func._overloadname != "self_int" and
                kwargs.get("output_size") is None):
            bad = "has an output shape that depends on the values"
        elif name in ("index", "index_put", "index_put_") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())
                if i is not None):
            bad = "indexes by a bool mask (a shape that depends on it)"
        elif name == "lift_fresh" and self.host_data:
            bad = "makes a tensor from host data (a copy to the device)"
        if bad:
            raise RuntimeError(f"{func} {bad}: a CUDA graph capture "
                               f"refuses it")
        return func(*args, **kwargs)


_STREAMS: dict = {}             # device index -> free (outer, child) pairs
_STREAMS_LOCK = threading.Lock()
# per thread: ``recording``, the launch lists of the captures in progress
# (innermost last), and ``loop_test``, set while run_loop's CPU branch
# reads its condition
_TLS = threading.local()
# one capture at a time in the process (a thread's own streams and
# thread-local mode already keep captures apart; this keeps the host code
# they run, CUB's among it, off concurrent paths); reentrant, for a loop
# captured inside a call's capture
_CAPTURE_LOCK = threading.RLock()


class _NoGC:
    """Python's cyclic garbage collector off for the block (a capture): a
    kept graph of a seeder that has become garbage, freed by the
    collector mid-capture, would issue CUDA calls that invalidate the
    capture.  Nested blocks leave it to the outermost to turn it on."""

    def __enter__(self):
        self.was = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self.was:
            gc.enable()
        return False


def capturing(dev: torch.device) -> bool:
    """Whether the current stream of ``dev`` (a CUDA device) is being
    captured into a graph: false for any other device."""
    if dev.type != "cuda":
        return False
    with torch.cuda.device(dev):
        return torch.cuda.is_current_stream_capturing()


class _Recording:
    """The launches made while active, in the calling thread: a list of
    (library, kernel), every capture in progress records each launch."""

    def __enter__(self) -> list:
        self.launched = []
        stack = getattr(_TLS, "recording", None)
        if stack is None:
            stack = _TLS.recording = []
        stack.append(self.launched)
        return self.launched

    def __exit__(self, *exc):
        # by identity: an inner capture's list may equal its outer's
        stack = _TLS.recording
        del stack[next(i for i, x in enumerate(stack)
                       if x is self.launched)]
        return False


class LoopGraph:
    """One segment's loop as a CUDA graph (csrc/loop_graph.cuh): ``begin``
    starts capturing the outer graph and returns the WHILE node's
    condition handle; the entry kernel is launched with ``outer`` current;
    ``body`` adds the WHILE node and starts capturing its body, whose
    launches go out with ``child`` current; ``end`` ends both captures
    and instantiates; ``launch`` runs it on a stream; ``nodes`` counts
    the body's nodes by type; ``close`` frees it.  ``nest`` in place of
    ``begin`` joins a capture in progress on the caller's stream.
    The two capture streams are non-blocking streams of the library's own,
    taken from a pool for the capture only.  ``capture_s`` and
    ``instantiate_s``: the host seconds of the captures and of ending them
    and instantiating."""

    def __init__(self, lib: KernelLibrary, prefix: str, dev: torch.device):
        self._c = lib._lib or lib.load()
        self._p = prefix
        self.dev = dev
        self._state = ct.c_void_p()
        self._pair = None
        self.capture_s = self.instantiate_s = 0.0

    def _fn(self, name: str):
        return getattr(self._c, f"{self._p}_graph_{name}")

    def _check(self, what: str, err: int) -> None:
        if err:
            name = getattr(self._c, f"{self._p}_cuda_error_name")(err)
            raise RuntimeError(f"{self._p} loop graph: {what} failed on "
                               f"{self.dev}: CUDA error {err} "
                               f"({name.decode()})")

    def _take_pair(self) -> tuple:
        with _STREAMS_LOCK:
            free = _STREAMS.setdefault(self.dev.index, [])
            pair = free.pop() if free else None
        if pair is None:
            o, c = ct.c_void_p(), ct.c_void_p()
            with torch.cuda.device(self.dev):
                self._check("stream creation",
                            self._fn("streams")(ct.byref(o), ct.byref(c)))
            pair = (o.value, c.value)
        self._pair = pair
        return pair

    def begin(self) -> int:
        pair = self._take_pair()
        self.outer, self.child = (torch.cuda.ExternalStream(x, self.dev)
                                  for x in pair)
        self._t0 = time.perf_counter()
        handle = ct.c_ulonglong()
        with torch.cuda.device(self.dev):
            self._check("begin", self._fn("begin")(
                pair[0], pair[1], ct.byref(self._state), ct.byref(handle)))
        return handle.value

    def nest(self, stream) -> int:
        """``begin`` for a loop that joins the capture in progress on
        ``stream`` (the caller's): the entry kernel is launched on that
        stream, and ``end`` ends the body's capture alone (the enclosing
        capture instantiates the loop with the rest)."""
        pair = self._take_pair()
        self.outer = stream
        self.child = torch.cuda.ExternalStream(pair[1], self.dev)
        self._t0 = time.perf_counter()
        handle = ct.c_ulonglong()
        with torch.cuda.device(self.dev):
            self._check("nest", self._fn("nest")(
                stream.cuda_stream, pair[1], ct.byref(self._state),
                ct.byref(handle)))
        return handle.value

    def body(self, handle: int) -> None:
        self._check("the WHILE node", self._fn("body")(self._state, handle))

    def end(self) -> None:
        t1 = time.perf_counter()
        self._check("end / instantiate", self._fn("end")(self._state))
        self._release()
        t2 = time.perf_counter()
        self.capture_s, self.instantiate_s = t1 - self._t0, t2 - t1

    def launch(self, stream) -> None:
        self._check("launch", self._fn("launch")(self._state,
                                                 stream.cuda_stream))

    def nodes(self) -> dict:
        """The body graph's nodes by type (after ``end``): what the card
        runs every round."""
        out = (ct.c_int * 3)()
        self._check("counting the body's nodes",
                    self._fn("nodes")(self._state, out))
        return dict(kernels=out[0], memsets=out[1], other=out[2])

    def _release(self) -> None:
        if self._pair is not None:
            with _STREAMS_LOCK:
                _STREAMS[self.dev.index].append(self._pair)
            self._pair = None

    def close(self) -> None:
        if self._state:
            self._fn("close")(self._state)
            self._state = None
        self._release()

    def __enter__(self):
        """The capture: the launches made until ``__exit__`` are recorded
        as the graph's (``launched``); a capture that raises closes the
        graph (ending any capture still open) and the error propagates."""
        self._rec = _Recording()
        self.launched = self._rec.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._rec.__exit__()
        if exc_type is not None:
            self.close()
        return False


class _LoopTest:
    """Marks the calling thread's read of a loop's condition in
    run_loop's CPU branch, which NoHostReads lets through."""

    def __enter__(self):
        _TLS.loop_test = getattr(_TLS, "loop_test", 0) + 1

    def __exit__(self, *exc):
        _TLS.loop_test -= 1
        return False


def _loop_test(rd) -> bool:
    """The condition's last value, read by run_loop's CPU branch."""
    with _LoopTest():
        return bool(int(rd.go))


def run_loop(rd, lib: KernelLibrary, prefix: str, entry, body) -> None:
    """Run a loop: ``entry(rd)`` launches the entry kernel (a round
    source's: ``RoundArgs.entry``; the suffix-array walk's stage entry
    before its last stage), ``body(rd)``
    one round's launches, the last of which counts the round and sets the
    condition (a round source's apply, the suffix-array walk, each with
    its loop word set).  ``rd`` holds the
    launch arguments: ``dev``, ``args`` (its words, ``AT["cond"]`` the
    condition handle's), ``go`` (the condition's last value, one int32 on
    the device) and ``graph`` (a RoundArgs, or fm_cuda.SaLoop).  On a
    card: one LoopGraph, captured under NoTorchOps the first time (kept
    as ``rd.graph`` until ``rd.close()``: a round kept across calls runs
    its graph again) and launched on the current stream; the host waits
    on nothing.  Every launch of the graph counts each kernel captured in
    it once more in its library's launches.  When the current stream is
    itself being captured (a CallGraph), the loop joins that capture
    instead (``LoopGraph.nest``), is launched with it and keeps nothing.
    For CPU tensors (the sources' host builds, which the CPU tests put in
    place of the launches; the walk there is its plain version) the same
    launches run in turn while ``rd.go`` is set."""
    if rd.dev.type != "cuda":
        entry(rd)
        while _loop_test(rd):
            body(rd)
        return
    if capturing(rd.dev):
        stream = torch.cuda.current_stream(rd.dev)
        with _CAPTURE_LOCK, LoopGraph(lib, prefix, rd.dev) as g:
            handle = rd.args[rd.AT["cond"]] = g.nest(stream)
            with NoTorchOps():
                entry(rd)
            g.body(handle)
            with NoTorchOps(), torch.cuda.stream(g.child):
                body(rd)
            g.end()
        g.close()                       # the body belongs to the capture
        return
    g = rd.graph
    if g is None:
        # a capture that fails is closed by the graph's __exit__
        with _CAPTURE_LOCK, _NoGC(), LoopGraph(lib, prefix, rd.dev) as g:
            handle = rd.args[rd.AT["cond"]] = g.begin()
            with NoTorchOps(), torch.cuda.stream(g.outer):
                entry(rd)
            g.body(handle)
            with NoTorchOps(), torch.cuda.stream(g.child):
                body(rd)
            g.end()
        rd.graph = g
    else:
        for kernel_lib, kernel in g.launched:
            kernel_lib.launched(kernel)
    g.launch(torch.cuda.current_stream(rd.dev))


class KernelLibrary:
    """One kernel source, its shared library and its launch counts.

    ``bind(lib)`` sets the argtypes and restypes of the C functions the
    wrappers call; ``error_name`` is the C function that names a CUDA
    error code."""

    def __init__(self, source: str, kernels, bind, error_name: str):
        self.src = os.path.join(ROOT, "compseed_tpu_torch", "csrc", source)
        self.so = os.path.join(
            BUILD, f"lib{os.path.splitext(source)[0]}.so")
        # kernel launches since import (or the last reset), by kernel
        self.launches = dict.fromkeys(kernels, 0)
        self._bind = bind
        self._error_name = error_name
        self._lib = None
        self._lock = threading.Lock()    # the one-time load and launches
        self.log = None                  # nvcc's output of this process' build

    def build(self, force: bool = False) -> str:
        """Compile the source (when the library is missing or older than
        it or a header beside it); returns the library's path.  Raises if
        nvcc fails."""
        os.makedirs(os.path.dirname(self.so), exist_ok=True)
        deps = [self.src] + glob.glob(
            os.path.join(os.path.dirname(self.src), "*.cuh"))
        if force or not os.path.exists(self.so) or \
                os.path.getmtime(self.so) < max(map(os.path.getmtime, deps)):
            self.log = compile_source(self.src, self.so)
        return self.so

    def load(self) -> ct.CDLL:
        """The library, built if need be and loaded once per process."""
        with self._lock:
            if self._lib is None:
                lib = ct.CDLL(self.build())
                self._bind(lib)
                name = getattr(lib, self._error_name)
                name.restype = ct.c_char_p
                name.argtypes = [ct.c_int]
                self._lib = lib
            return self._lib

    def launched(self, kernel: str) -> None:
        with self._lock:
            self.launches[kernel] += 1
        for launched in getattr(_TLS, "recording", None) or ():
            launched.append((self, kernel))   # a capture: its graph's kernels

    def launch(self, kernel: str, dev: torch.device, launcher: str,
               *args) -> None:
        """Call the C function ``launcher`` with ``args`` and the raw
        handle of ``dev``'s current stream, ``dev`` current; raise on a
        non-zero CUDA error code, else count one launch of ``kernel``."""
        lib = self._lib or self.load()
        with torch.cuda.device(dev):
            err = getattr(lib, launcher)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            name = getattr(lib, self._error_name)(err).decode()
            raise RuntimeError(f"{kernel} launch failed on {dev} "
                               f"({self.so}): CUDA error {err} ({name})")
        self.launched(kernel)

    def occupancy(self, entry: str, idx64: bool, lanes: int,
                  dev: torch.device) -> dict:
        """What ``dev`` gives the kernel a call of ``lanes`` lanes launches
        (index type int64 with ``idx64``), by the library's C function
        ``entry`` (idx64, lanes, out: six ints): resident blocks an SM,
        lanes a block, registers and local (spill) bytes a thread, static
        shared bytes a block, threads a lane; with the card's SMs and the
        lanes resident at once on it."""
        lib = self._lib or self.load()
        out = (ct.c_int * 6)()
        with torch.cuda.device(dev):
            err = getattr(lib, entry)(int(bool(idx64)), int(lanes), out)
        if err:
            name = getattr(lib, self._error_name)(err).decode()
            raise RuntimeError(f"{entry} failed on {dev}: CUDA error {err} "
                               f"({name})")
        blocks, per_block, regs, local, shared, threads = out
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return dict(blocks_per_sm=blocks, lanes_per_block=per_block,
                    registers=regs, local_bytes=local, shared_bytes=shared,
                    threads_per_lane=threads, sms=sms,
                    resident_lanes=blocks * per_block * sms)

    def launch_args(self, kernel: str, dev: torch.device, args) -> None:
        """Launch ``kernel`` of a round source through its C launcher
        (``launcher_of``) with the Args words ``args``
        (a ctypes array) on ``dev``, which must be a CUDA device."""
        if dev.type != "cuda":
            raise ValueError(f"{kernel}: the kernel needs CUDA tensors, "
                             f"got {dev}")
        self.launch(kernel, dev, launcher_of(kernel), ct.addressof(args))


class Kept:
    """Objects kept per (thread, key): the loop graphs' tensors of a call
    shape (seedscan._held), a seeder's call graphs.  ``get`` returns the
    calling thread's object for ``key``, made by ``make()`` at its first
    call; beyond ``limit`` keys a thread's least recently used is closed.
    A thread that keeps nothing yet takes over what a thread that has
    ended kept (the next seeding worker of a stream, the last one's
    graphs; their work was queued on the device's default stream, so the
    new thread's comes after it), and the rest that ended threads kept is
    closed (a graph still running on the card is freed when it ends, and
    the memory it names is reused only by work queued after it).  The
    registry is the module's own, not thread-local storage, so that what
    a thread kept is freed by a live thread's call, never while the
    interpreter tears an ending thread down.  No two live threads share
    an object."""

    def __init__(self, limit: int):
        self.limit = limit
        self.by_thread: dict = {}       # ident -> key -> object, LRU first
        self.lock = threading.Lock()

    def get(self, key, make):
        me = threading.get_ident()
        with self.lock:
            live = {t.ident for t in threading.enumerate()}
            ended = [i for i in self.by_thread if i not in live]
            if ended and me not in self.by_thread:
                self.by_thread[me] = self.by_thread.pop(ended.pop())
            drop = [x for i in ended for x in self.by_thread.pop(i).values()]
            kept = self.by_thread.setdefault(me, collections.OrderedDict())
        x = kept.get(key)
        if x is not None:
            kept.move_to_end(key)
        while x is None and len(kept) >= self.limit:
            drop.append(kept.popitem(last=False)[1])
        for old in drop:                # before a new one is made
            old.close()
        if x is None:
            x = kept[key] = make()
        return x

    def drop_thread(self) -> None:
        """Close every object the calling thread kept."""
        with self.lock:
            kept = self.by_thread.pop(threading.get_ident(), {})
        for x in kept.values():
            x.close()


class _Capture:
    """A torch.cuda.CUDAGraph's capture on the current stream, in
    thread-local mode, for the block: a block that raises ends the capture
    (its own error, if any, is dropped) and the block's error
    propagates; one that returns leaves ending it to the caller."""

    def __init__(self, graph):
        self.graph = graph

    def __enter__(self):
        self.graph.capture_begin(capture_error_mode="thread_local")
        return self.graph

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # said first: ending a capture that CUDA invalidated can
            # abort the process
            print(f"CUDA graph capture failed: {exc!r}", file=sys.stderr,
                  flush=True)
            with contextlib.suppress(RuntimeError):
                self.graph.capture_end()
        return False


class CallGraph:
    """A whole call as one torch.cuda.CUDAGraph: ``fn(*inputs)``, a
    program of the port's kernels and static-shape torch operations that
    never waits on the host, captured once in thread-local mode from a
    stream of its own (the alignment tail's DP runs on the main thread
    beside a seeding worker's capture) and replayed by ``run``.  The
    capture holds the inputs' copies (``inputs``: ``run`` copies its
    arguments into them) and ``outputs``, the tensors ``fn`` returned,
    which every replay overwrites: a caller copies out what it keeps
    beyond the next replay.  The graph's private memory pool holds the
    call's working set for as long as the graph is kept.  Loops inside
    join the capture (run_loop).  Each replay after the first counts each
    kernel captured in it once more in its library's launches (the
    capture counted the first).  ``capture_s``: the host seconds of
    running ``fn`` under capture, ``instantiate_s``: of ending the capture
    and instantiating.  A failed capture raises, and the graph is not
    kept."""

    def __init__(self, dev: torch.device, fn, inputs):
        self.dev = dev
        self.inputs = tuple(torch.empty_like(
            x, memory_format=torch.contiguous_format) for x in inputs)
        self.graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with _CAPTURE_LOCK:
            # no capture is in progress (each holds the lock): garbage
            # graphs are freed and the allocator's cache is given back
            # now, so that neither happens inside this capture (an
            # allocation that finds no memory frees the cache, and a
            # cudaFree invalidates every capture on the device)
            gc.collect()
            torch.cuda.empty_cache()
            self._capture(dev, fn, side)
        cur.wait_stream(side)
        self.replays = 0
        self.stream = cur

    def _capture(self, dev, fn, side) -> None:
        with _NoGC(), _Recording() as launched, torch.cuda.device(dev), \
                torch.cuda.stream(side):
            t0 = time.perf_counter()
            with _Capture(self.graph):
                out = fn(*self.inputs)
            t1 = time.perf_counter()
            self.graph.capture_end()
            t2 = time.perf_counter()
        self.outputs = out
        self.launched = launched
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1

    def run(self, inputs):
        """Copy ``inputs`` into the graph's and replay it on the current
        stream (after the last replay, if that was on another stream);
        returns ``outputs``."""
        cur = torch.cuda.current_stream(self.dev)
        if cur != self.stream:
            cur.wait_stream(self.stream)
            self.stream = cur
        for mine, x in zip(self.inputs, inputs, strict=True):
            if x.shape != mine.shape or x.dtype != mine.dtype:
                raise ValueError(f"call graph input {tuple(x.shape)} "
                                 f"{x.dtype}, captured for "
                                 f"{tuple(mine.shape)} {mine.dtype}")
            mine.copy_(x)
        if self.replays:
            for lib, kernel in self.launched:
                lib.launched(kernel)
        with torch.cuda.device(self.dev):
            self.graph.replay()
        self.replays += 1
        return self.outputs

    def close(self) -> None:
        """Free the graph and its pool (a replay still running on the card
        finishes first: the pool's memory is reused only by work queued
        after it)."""
        self.graph.reset()
        self.outputs = self.inputs = ()
