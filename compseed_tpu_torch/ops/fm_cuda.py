"""The FM-index walks on Hopper: launchers of ``csrc/fm_walk.cu``.

The JAX package leaves these primitives to XLA, which fuses each into one
row gather plus one elementwise fusion; the port launches one
hand-written kernel per call instead of some hundred PyTorch operations:

  ``extend_sel_batch`` -> ``fm_extend_sel_kernel``, for
      ``ops/fm.py::extend_sel_batch`` (plain version ``_extend_sel_plain``);
  ``chain_walk``       -> ``fm_chain_walk_kernel``, for
      ``ops/seedscan.py::_chain_walk`` (plain version ``_chain_walk_plain``);
  ``inv_psi_walk``     -> ``fm_inv_psi_walk_kernel``, for ``ops/fm.py::_walk``
      (plain version ``_walk_plain``);
  ``SaLoop``           -> ``sa_stage_entry_kernel`` (by its SaArgs words)
      and ``fm_inv_psi_walk_kernel`` (``inv_psi_walk``): the suffix-array
      walk of ``sa_batch_compact`` on the card (``ops/fm.py::
      _sa_batch_compact_kernels``, plain version ``_sa_batch_compact_plain``):
      each stage's walk, the boundaries between the stages (the done lanes
      written out, the live ones compacted) and the last stage's loop, one
      CUDA graph loop (``cuda_lib.run_loop``) whose test the boundary
      before it and the walk's last block to retire set.

Those callers run the plain version for CPU tensors and come here for any
other; each launcher takes CUDA tensors only and launches its kernel or
raises: nothing falls back from one to the other.  Every kernel reads
the index's one occ table, ``occ_packed`` (``device_index.pack_occ_rows``:
64 bytes a row), a pair of threads a lane.  The library is ``LIB``,
an ``ops/cuda_lib.KernelLibrary`` (built with nvcc for sm_90a at first use
into build/compseed_tpu_torch/libfm_walk.so); ``DeviceSeeder`` loads it
when it is built on a CUDA device, so a failed build stops the seeder's
construction.

``LAUNCHES`` counts kernel launches by kernel, and nothing else.  Every
launch goes to the device its tensors lie on, on that device's current
stream, with no synchronisation; outputs come from ``torch.empty``.
"""

from __future__ import annotations

import ctypes as ct

import torch

from compseed_tpu_torch.ops import cuda_lib
from compseed_tpu_torch.ops.cuda_lib import KernelLibrary, bind_graphs

MAX_W = 10                  # a chain window packs into 30 bits
# a stage entry's words (csrc/fm_walk.cu's struct SaArgs), in order
SA_ARGS = ("idx64", "kk", "steps", "alive", "slot", "n",
           "next_kk", "next_steps", "next_alive", "next_slot", "w",
           "kk0", "out_steps", "out_k", "ovf", "sc", "lb",
           "open", "cond", "go")
SA_KERNELS = ("sa_stage_entry_kernel",)


def _bind(lib) -> None:
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    index = [p, ll, p, ll, i]       # rows, n_rows, L2, primary, oob
    lib.fm_extend_sel_launch.argtypes = index + [p, p, i, p, ll, i, p]
    lib.fm_chain_walk_launch.argtypes = index + \
        [p, p, p, p, p, p, i, i, p, p, p, p, ll, i, p]
    lib.fm_inv_psi_walk_launch.argtypes = index + \
        [p, p, p, i, ll, p, p, p, ll, i, p, ll, p, p]
    lib.sa_stage_entry_launch.argtypes = [p, p]
    for fn in (lib.fm_extend_sel_launch, lib.fm_chain_walk_launch,
               lib.fm_inv_psi_walk_launch, lib.sa_stage_entry_launch):
        fn.restype = i
    bind_graphs(lib, "fm")
    lib.fm_sa_args_words.argtypes, lib.fm_sa_args_words.restype = [], i
    if lib.fm_sa_args_words() != len(SA_ARGS):
        raise RuntimeError(f"fm_sa_args_words() says struct SaArgs has "
                           f"{lib.fm_sa_args_words()} words, the launchers "
                           f"name {len(SA_ARGS)}")


LIB = KernelLibrary(
    "fm_walk.cu",
    ("fm_extend_sel_kernel", "fm_chain_walk_kernel",
     "fm_inv_psi_walk_kernel") + SA_KERNELS,
    _bind, "fm_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build
_launch = LIB.launch_args


def _check(name, x, dtype, shape, device=None):
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def _index_args(fm, dev) -> list:
    """The index's launcher arguments, after checking that its tables lie
    on ``dev`` in the layout the kernels read: the (n_rows, 16) int32
    packed rows, 64-byte aligned."""
    n_rows = fm.n_rows
    rows = fm.occ_packed
    _check("occ_packed", rows, torch.int32, (n_rows, 16), dev)
    if rows.data_ptr() % 64:
        raise ValueError("occ_packed's rows must be 64-byte aligned")
    _check("L2", fm.L2, fm.dtype, (5,), dev)
    if fm.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"index dtype {fm.dtype} is neither int32 nor int64")
    return [rows.data_ptr(), n_rows, fm.L2.data_ptr(), int(fm.primary),
            int(bool(fm.fill_oob))]


def _cuda_device(fn: str, dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the kernel needs CUDA tensors, got {dev}")
    return dev


# ---------------------------------------------------------------------------
def extend_sel_batch(fm, ik: torch.Tensor, c: torch.Tensor,
                     is_back: bool) -> torch.Tensor:
    """One-child bidirectional extension by ``fm_extend_sel_kernel``, ik
    (..., 3) and c (...,) base codes in [0, 3] -> (..., 3) in the index
    dtype (ik is cast to the index dtype and c to int32, both flattened
    and made contiguous)."""
    lead = tuple(ik.shape[:-1])
    if ik.shape[-1:] != (3,) or tuple(c.shape) != lead:
        raise ValueError(f"extend_sel_batch: ik {tuple(ik.shape)} and c "
                         f"{tuple(c.shape)} do not match (..., 3) / (...,)")
    out = _launch_extend_sel(fm, ik.to(fm.dtype).reshape(-1, 3).contiguous(),
                             c.to(torch.int32).reshape(-1).contiguous(),
                             is_back)
    return out.reshape(lead + (3,))


def _launch_extend_sel(fm, ik, c, is_back: bool) -> torch.Tensor:
    """Check the flat tensors, launch, return (n, 3)."""
    dev = _cuda_device("extend_sel_batch", ik.device)
    n = ik.shape[0] if ik.dim() else 0
    _check("ik", ik, fm.dtype, (n, 3))
    _check("c", c, torch.int32, (n,), dev)
    index = _index_args(fm, dev)
    out = torch.empty((n, 3), dtype=fm.dtype, device=dev)
    if n:
        LIB.launch("fm_extend_sel_kernel", dev, "fm_extend_sel_launch",
                   *index, ik.data_ptr(), c.data_ptr(), int(bool(is_back)),
                   out.data_ptr(), n, int(fm.dtype == torch.int64))
    return out


# ---------------------------------------------------------------------------
def chain_walk(fm, wv: torch.Tensor, W: int, k, l, s, valid,
               is_back: bool = False, stop_s=None, out=None):
    """W pure extensions per lane by ``fm_chain_walk_kernel``, over the
    3-bit codes of its window word wv (U,) from (k, l, s) (U,).  Returns
    (ck, cl, cs (U, W), ln (U,) int32), as ``seedscan._chain_walk_plain``.
    With ``out`` (those four, held by a round) it writes them and
    returns them, and takes its inputs as the kernel reads them (wv
    int64, k, l, s and stop_s in the index dtype, valid bool, all
    contiguous: checked, never converted), so that it allocates nothing
    and can be captured into a round's graph."""
    dt = fm.dtype
    if out is not None:
        return _launch_chain_walk(fm, wv, W, k, l, s, valid, is_back,
                                  stop_s, out)
    return _launch_chain_walk(
        fm, wv.to(torch.int64).contiguous(), W, k.to(dt).contiguous(),
        l.to(dt).contiguous(), s.to(dt).contiguous(),
        valid.to(torch.bool).contiguous(), is_back,
        None if stop_s is None else stop_s.to(dt).contiguous())


def _launch_chain_walk(fm, wv, W: int, k, l, s, valid, is_back: bool,
                       stop_s, out=None):
    if not 1 <= W <= MAX_W:
        raise ValueError(f"chain_walk: W={W} is outside [1, {MAX_W}]")
    dev = _cuda_device("chain_walk", k.device)
    U = k.shape[0] if k.dim() else 0
    dt = fm.dtype
    _check("k", k, dt, (U,))
    _check("l", l, dt, (U,), dev)
    _check("s", s, dt, (U,), dev)
    _check("wv", wv, torch.int64, (U,), dev)
    _check("valid", valid, torch.bool, (U,), dev)
    if stop_s is not None:
        _check("stop_s", stop_s, dt, (U,), dev)
    index = _index_args(fm, dev)
    if out is None:
        ck, cl, cs = (torch.empty((U, W), dtype=dt, device=dev)
                      for _ in range(3))
        ln = torch.empty(U, dtype=torch.int32, device=dev)
    else:
        ck, cl, cs, ln = out
        for name, x in (("ck", ck), ("cl", cl), ("cs", cs)):
            _check(name, x, dt, (U, W), dev)
        _check("ln", ln, torch.int32, (U,), dev)
    if U:
        LIB.launch("fm_chain_walk_kernel", dev, "fm_chain_walk_launch",
                   *index, wv.data_ptr(), k.data_ptr(), l.data_ptr(),
                   s.data_ptr(), valid.data_ptr(),
                   None if stop_s is None else stop_s.data_ptr(),
                   int(bool(is_back)), W, ck.data_ptr(), cl.data_ptr(),
                   cs.data_ptr(), ln.data_ptr(), U, int(dt == torch.int64))
    return ck, cl, cs, ln


# ---------------------------------------------------------------------------
def inv_psi_walk(fm, kk: torch.Tensor, steps: torch.Tensor,
                 alive: torch.Tensor, n_steps: int, out=None, tail=None):
    """Up to ``n_steps`` masked inverse-Psi steps per lane by
    ``fm_inv_psi_walk_kernel``: kk, steps (N,) in the index dtype, alive
    (N,) bool -> the same three, new tensors, or ``out`` (three such
    tensors, the inputs themselves allowed: the walk then runs in place
    and allocates nothing, so that it can be captured into a loop's
    graph).  ``tail`` (the body of SaLoop's loop: its retire word, one
    int64 that is 0 between launches, the WHILE node's condition handle,
    0 outside a graph, and go, one int32) makes the walk's last block to
    retire run the loop's test, go = any lane alive after the walk."""
    dev = _cuda_device("inv_psi_walk", kk.device)
    N = kk.shape[0] if kk.dim() else 0
    dt = fm.dtype
    _check("kk", kk, dt, (N,))
    _check("steps", steps, dt, (N,), dev)
    _check("alive", alive, torch.bool, (N,), dev)
    if n_steps < 0:
        raise ValueError(f"inv_psi_walk: n_steps={n_steps} is negative")
    index = _index_args(fm, dev)
    if out is None:
        out = (torch.empty_like(kk), torch.empty_like(steps),
               torch.empty_like(alive))
    for name, x, like in zip(("kk_out", "steps_out", "alive_out"), out,
                             (kk, steps, alive)):
        _check(name, x, like.dtype, (N,), dev)
    kk_out, steps_out, alive_out = out
    retire, cond, go = tail or (None, 0, None)
    if tail is not None:
        if N < 1:
            raise ValueError("inv_psi_walk: a loop's test needs a lane")
        _check("retire", retire, torch.int64, (), dev)
        _check("go", go, torch.int32, (), dev)
    if N:
        LIB.launch("fm_inv_psi_walk_kernel", dev, "fm_inv_psi_walk_launch",
                   *index, kk.data_ptr(), steps.data_ptr(), alive.data_ptr(),
                   n_steps, fm.sa_intv - 1, kk_out.data_ptr(),
                   steps_out.data_ptr(), alive_out.data_ptr(), N,
                   int(dt == torch.int64),
                   None if retire is None else retire.data_ptr(), cond,
                   None if go is None else go.data_ptr())
    return kk_out, steps_out, alive_out


# ---------------------------------------------------------------------------
def sa_widths(N: int) -> tuple:
    """The lanes of sa_batch_compact's four stages over N lanes: N, then
    the caps max(N // div, 1) for div 4, 16, 64 (the JAX package's), none
    wider than the stage before (N = 0: all 0)."""
    out = [N]
    for div in (4, 16, 64):
        out.append(min(max(N // div, 1), out[-1]))
    return tuple(out)


class SaLoop:
    """The suffix-array walk of one sa_batch_compact call on the kernels,
    over N >= 1 lanes: the call's positions ``kk0`` (N,) in the index
    dtype, their zero steps ``steps0`` and first alive bytes ``alive0``.
    Allocates, at its construction (outside any loop's capture; inside a
    call's capture the graph's pool serves them), every stage's lanes
    (``lanes[s]``: kk, steps, alive, and slot (int32) from the second
    stage on), the outputs ``out_steps``, ``out_k`` (N) and ``ovf``, ``go``
    (one int32, the loop condition's last value) and its scan words
    (``words``: the int32 ticket and epoch words, the walk's 64-bit retire
    word ``retire``, then a look-back word a block, zeroed once).
    ``stages``: (lanes, steps) a stage, sa_batch_compact's by default
    (``sa_widths``; steps sa_intv, 2, 4 and 2 sa_intv a round); a first
    stage of 0 steps is the call's lanes themselves, walked by no launch
    (sa_batch's loop: ``fm._sa_loop_kernels``).  ``walk(s)``
    launches stage s's walk (``inv_psi_walk``, in place from the second
    stage on), ``boundary(s)`` the stage entry after it (after the last
    stage, the call's last launch); ``cuda_lib.run_loop`` takes it for the
    last stage's loop: ``args`` (the stage entry's struct SaArgs, one
    64-bit word a field, ``AT``: field -> word; ``AT["cond"]`` the
    condition handle, which the walk's tail reads too), ``go``, ``dev``
    and, run outside a call's capture, ``graph``."""

    AT = {n: i for i, n in enumerate(SA_ARGS)}
    graph = None

    def __init__(self, fm, kk0, steps0, alive0, stages=None):
        dev = kk0.device
        N = kk0.shape[0] if kk0.dim() else 0
        if N < 1:
            raise ValueError("SaLoop: no lanes")
        dt = fm.dtype
        _check("kk0", kk0, dt, (N,), dev)
        _check("steps0", steps0, dt, (N,), dev)
        _check("alive0", alive0, torch.bool, (N,), dev)
        self.fm, self.dev = fm, dev
        if stages is None:
            stages = tuple(zip(sa_widths(N), (
                fm.sa_intv, 2 * fm.sa_intv, 4 * fm.sa_intv, 2 * fm.sa_intv)))
        self.widths = tuple(w for w, _ in stages)
        self.n_steps = tuple(n for _, n in stages)
        if self.widths[0] != N or len(stages) < 2 or any(
                not 1 <= b <= a for a, b in zip(self.widths,
                                                self.widths[1:])):
            raise ValueError(f"SaLoop: stages {stages} over {N} lanes")
        i32 = torch.int32
        self.first = (kk0, steps0, alive0)
        self.lanes = [self.first if s == 0 and self.n_steps[0] == 0 else
                      tuple(torch.empty(w, dtype=d, device=dev)
                            for d in (dt, dt, torch.bool, i32)[:3 + (s > 0)])
                      for s, w in enumerate(self.widths)]
        self.out_steps = torch.empty(N, dtype=dt, device=dev)
        self.out_k = torch.empty(N, dtype=dt, device=dev)
        self.ovf = torch.empty((), dtype=torch.bool, device=dev)
        self.go = torch.empty((), dtype=i32, device=dev)
        tiles = -(-N // cuda_lib.ENTRY_TILE)
        self.words = torch.zeros(2 + tiles, dtype=torch.int64, device=dev)
        self.retire = self.words[1]
        self.args = (ct.c_longlong * len(SA_ARGS))()
        for name, x in (("idx64", int(dt == torch.int64)),
                        ("kk0", kk0.data_ptr()),
                        ("out_steps", self.out_steps.data_ptr()),
                        ("out_k", self.out_k.data_ptr()),
                        ("ovf", self.ovf.data_ptr()),
                        ("sc", self.words.data_ptr()),
                        ("lb", self.words[2:].data_ptr()),
                        ("go", self.go.data_ptr())):
            self.args[self.AT[name]] = x

    def _stage(self, s: int) -> None:
        """Point the lane words at stage s."""
        for name, x in zip(("kk", "steps", "alive"), self.lanes[s]):
            self.args[self.AT[name]] = x.data_ptr()
        self.args[self.AT["slot"]] = self.lanes[s][3].data_ptr() if s else 0
        self.args[self.AT["n"]] = self.widths[s]

    def tail(self) -> tuple:
        """The loop's test after a walk (``inv_psi_walk``'s ``tail``):
        the retire word, the condition handle (0 until run_loop sets it)
        and go."""
        return self.retire, self.args[self.AT["cond"]], self.go

    def walk(self, s: int, loop: bool = False) -> None:
        """fm_inv_psi_walk_kernel over stage s's lanes: the first stage's
        from the call's lanes into its own, the others' in place; with
        ``loop`` (the last stage's loop body) its last block to retire
        runs the loop's test after the round."""
        lanes = self.lanes[s][:3]
        inv_psi_walk(self.fm, *(self.first if s == 0 else lanes),
                     self.n_steps[s], out=lanes,
                     tail=self.tail() if loop else None)

    def boundary(self, s: int) -> None:
        """sa_stage_entry_kernel after stage s: its done lanes written
        out and, before the last stage, its live lanes compacted into the
        next stage's (ovf; before the last stage also the loop's first
        test, go and the WHILE node's condition)."""
        self._stage(s)
        last = s + 1 == len(self.widths)
        nxt = () if last else self.lanes[s + 1]
        for name, x in zip(("next_kk", "next_steps", "next_alive",
                            "next_slot"), nxt or (None,) * 4):
            self.args[self.AT[name]] = 0 if x is None else x.data_ptr()
        self.args[self.AT["w"]] = 0 if last else self.widths[s + 1]
        self.args[self.AT["open"]] = int(s + 2 == len(self.widths))
        if last:
            self.args[self.AT["cond"]] = 0
        _launch("sa_stage_entry_kernel", self.dev, self.args)

    def close(self) -> None:
        """Free the loop's graph (after its last launch)."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None
