"""The exact rerun's per-read programs on Hopper: launchers of
``csrc/smem_seed.cu``.

The JAX package runs the lockstep seeder's collect_mem and its fused
round-3 scan as per-read programs that BatchSeeder vmaps and jits, one
device program a call; the port launches one hand-written kernel a call:

  ``collect``  -> ``smem_collect_kernel``, for ``ops/smem.py::_collect_one``
      (plain version ``_collect_plain``): a warp a lane where the call
      runs in one wave so, else a group of 8 threads a lane (16,896 lanes
      resident on an H100), frontier slot j in thread j % group
      (``occupancy`` says what the card gives a call);
  ``strategy`` -> ``smem_strategy_kernel``, for
      ``ops/smem.py::_seed_strategy_one`` (plain version
      ``_seed_strategy_plain``): a pair of threads a lane, each thread's
      occ row read whole before it is ranked.

``ops/smem.py`` runs the plain versions for CPU tensors and comes here for
any other; each launcher takes CUDA tensors only and launches its kernel
or raises: nothing falls back from one to the other.  Both kernels read
the index's packed occ table (``occ_packed``) as ``fm_walk.cu``'s do,
through ``csrc/fm_rank.cuh``.  The caps (the module's MLEP, MMEM, MMEM3,
1 to 32) are launch arguments.  The library is ``LIB``, an
``ops/cuda_lib.KernelLibrary`` (built with nvcc for sm_90a at first use
into build/compseed_tpu_torch/libsmem_seed.so).

``LAUNCHES`` counts kernel launches by kernel, and nothing else.  Every
launch goes to the device its tensors lie on, on that device's current
stream, with no synchronisation; outputs come from ``torch.empty``
(``cuda_lib.empty``: filled with a sentinel under ``cuda_lib.Poisoned``,
for the tests), and the kernels write every word of them.
"""

from __future__ import annotations

import ctypes as ct

import torch

from compseed_tpu_torch.ops.cuda_lib import KernelLibrary, check_tensor, empty
from compseed_tpu_torch.ops.fm_cuda import _cuda_device, _index_args

MAX_CAP = 32                # csrc/smem_seed.cu: a frontier's slots
KERNELS = ("smem_collect_kernel", "smem_strategy_kernel")


def _bind(lib) -> None:
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    index = [p, ll, p, ll, i]       # rows, n_rows, L2, primary, oob
    lib.smem_collect_launch.argtypes = index + \
        [p, i, p, p, i, p, i, i, p, ll, i, p]
    lib.smem_strategy_launch.argtypes = index + \
        [p, i, i, ll, p, i, p, ll, i, p]
    for fn in (lib.smem_collect_launch, lib.smem_strategy_launch):
        fn.restype = i
    for name in ("smem_collect_occupancy", "smem_strategy_occupancy"):
        if hasattr(lib, name):                    # an earlier build has none
            getattr(lib, name).argtypes = [i, ll, p]
            getattr(lib, name).restype = i


LIB = KernelLibrary("smem_seed.cu", KERNELS, _bind, "smem_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build


def _caps(**caps) -> None:
    for name, v in caps.items():
        if not 1 <= v <= MAX_CAP:
            raise ValueError(f"{name}={v} is outside [1, {MAX_CAP}]")


def _lanes(fn: str, q: torch.Tensor, L: int):
    """The lanes' device and count after checking q, (P, L) uint8."""
    dev = _cuda_device(fn, q.device)
    P = q.shape[0] if q.dim() == 2 else -1
    check_tensor("q", q, torch.uint8, (P, L), dev)
    if L < 1:
        raise ValueError(f"{fn}: L={L} is below 1")
    return dev, P


def collect(fm, L: int, q, pivot, min_hits, active, mlep: int,
            mmem: int) -> torch.Tensor:
    """collect_mem for every lane by ``smem_collect_kernel``: q (P, L)
    uint8, pivot (P,) int32, min_hits (P,) int32 or int64, active (P,)
    bool, all contiguous on one card (checked, never converted) ->
    (P, mmem*5 + 3) in the index dtype, as ``smem._collect_plain``."""
    _caps(mlep=mlep, mmem=mmem)
    dev, P = _lanes("collect", q, L)
    check_tensor("pivot", pivot, torch.int32, (P,), dev)
    if min_hits.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"min_hits has dtype {min_hits.dtype}, expected "
                        f"int32 or int64")
    check_tensor("min_hits", min_hits, min_hits.dtype, (P,), dev)
    check_tensor("active", active, torch.bool, (P,), dev)
    index = _index_args(fm, dev)
    out = empty((P, mmem * 5 + 3), fm.dtype, dev)
    if P:
        LIB.launch("smem_collect_kernel", dev, "smem_collect_launch",
                   *index, q.data_ptr(), L, pivot.data_ptr(),
                   min_hits.data_ptr(), int(min_hits.dtype == torch.int64),
                   active.data_ptr(), mlep, mmem, out.data_ptr(), P,
                   int(fm.dtype == torch.int64))
    return out


def strategy(fm, L: int, min_len: int, max_intv: int, q, active,
             mmem3: int) -> torch.Tensor:
    """The fused round-3 scan for every lane by ``smem_strategy_kernel``:
    q (P, L) uint8, active (P,) bool, contiguous on one card (checked,
    never converted) -> (P, mmem3*5 + 2) in the index dtype, as
    ``smem._seed_strategy_plain``."""
    _caps(mmem3=mmem3)
    dev, P = _lanes("strategy", q, L)
    check_tensor("active", active, torch.bool, (P,), dev)
    index = _index_args(fm, dev)
    out = empty((P, mmem3 * 5 + 2), fm.dtype, dev)
    if P:
        LIB.launch("smem_strategy_kernel", dev, "smem_strategy_launch",
                   *index, q.data_ptr(), L, int(min_len), int(max_intv),
                   active.data_ptr(), mmem3, out.data_ptr(), P,
                   int(fm.dtype == torch.int64))
    return out


def occupancy(dtype: torch.dtype, dev, lanes: int,
              kernel: str = "smem_collect_kernel") -> dict:
    """What card ``dev`` gives ``kernel`` (``smem_collect_kernel`` or
    ``smem_strategy_kernel``) in a call of ``lanes`` lanes over an index of
    ``dtype`` (torch.int32 or torch.int64): ``KernelLibrary.occupancy`` of
    the kernel the launcher takes for it (threads_per_lane: the collect
    kernel's group), its blocks an SM, lanes a block, registers, spill
    bytes and the lanes resident at once (a call of at most that many
    lanes runs in one wave)."""
    return LIB.occupancy(kernel.replace("_kernel", "_occupancy"),
                         dtype == torch.int64, lanes, torch.device(dev))
