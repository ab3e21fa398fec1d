"""The banded-SW DP on Hopper: tile build + the hand-written CUDA kernels.

Port of compseed_tpu/ops/bsw_pallas.py.  ``bsw_extend_tiles`` is the DP
kernel's launcher: for CUDA tensors it launches
``csrc/bsw_extend.cu::bsw_extend_kernel`` — with int32 H/E rows, or with
int16 rows under ``state16=True`` — (built with nvcc for sm_90a on first
use into build/compseed_tpu_torch/, rebuilt when the source is newer) or
raises; for CPU tensors it runs the plain PyTorch version,
``ops/bsw.py::_extend_core``.  Nothing falls back from one to the other.
The kernel keeps a pair's H/E rows in shared memory, ``block_threads``
pairs a block; a query-length class whose rows do not fit (``block_threads``
gives 0) takes the same routine on a device-memory scratch, counted as
``bsw_extend_kernel_gmem``: a dispatch on (Q, storage type) alone.

``bsw_meta_dual`` launches ``bsw_meta_dual_kernel``: tile decode, both
band rounds and the retry acceptance for P pairs in one launch (plain
version: ``ops/bsw.py::_meta_dual_plain``).

``probe_add_one`` launches the library's one-tile probe kernel (x + 1;
plain version ``_probe_plain``), and ``self_check`` holds it to that
plain version: it runs once for each card a DP engine is built on
(``BswRunner.__init__``, ``ShardedBswRunner.__init__``), and a wrong tile
stops the run.  It takes the place of the JAX package's toolchain probe
(``pallas_available``), but its verdict never selects the plain version,
and there is no override.

``LAUNCHES`` counts kernel launches by kernel, and nothing else.

The library is ``LIB``, an ``ops/cuda_lib.KernelLibrary``: every launch
goes to the device its tensors lie on, made current in the calling thread
around the C launcher, which launches on the current device (and grants a
kernel more than 48 KB of shared memory once per device).

``build_tiles`` decodes the DP tiles on the device from pair metadata:
query rows from the chunk's read matrix (3-bit packed 8-char windows),
target rows from the 2-bit packed reference along both fold branches.
``clamp_band`` stays in numpy because it truncates from float64.
"""

from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from compseed_tpu_torch.ops.cuda_lib import KernelLibrary
from compseed_tpu_torch.ops.seedscan import packed_rev_windows, packed_windows

LT = 512            # pairs are padded to a multiple of this
PROBE_SHAPE = (8, 128)
# Shared memory of one Hopper SM that blocks can use, the most one block
# may ask for, what the hardware keeps back per resident block, and the
# kernels' static shared memory (the 5x5 matrix), rounded up.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
_SMEM_BLOCK_RESERVE = 1024
_SMEM_STATIC = 128


def _bind(lib) -> None:
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    for fn in (lib.bsw_extend_launch, lib.bsw_extend_launch_i16):
        fn.restype = i
        fn.argtypes = [p] * 10 + [i] * 9 + [p]
    for fn in (lib.bsw_meta_dual_launch, lib.bsw_meta_dual_launch_i16):
        fn.restype = i
        fn.argtypes = [p, p, ll, p, ll, p, p, i, i, i, i, ll] + [i] * 8 + [p]
    lib.probe_add_one_launch.restype = i
    lib.probe_add_one_launch.argtypes = [p, p, i, p]
    lib.bsw_pair_bytes.restype = ll
    lib.bsw_pair_bytes.argtypes = [i, i]


LIB = KernelLibrary(
    "bsw_extend.cu",
    ("bsw_extend_kernel", "bsw_extend_kernel_i16", "bsw_extend_kernel_gmem",
     "bsw_meta_dual_kernel", "bsw_meta_dual_kernel_i16",
     "probe_add_one_kernel"),
    _bind, "bsw_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build


def _probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's plain version."""
    return x + 1


def probe_add_one(x: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """x + 1 for one PROBE_SHAPE int32 tile: the probe kernel for a CUDA
    tensor, its plain version for a CPU tensor.  ``out`` is written and
    returned when given (same device, dtype, shape; 16-byte aligned like
    x), so a caller that launches often allocates once."""
    dev = x.device
    if dev.type == "cpu":
        y = _probe_plain(x)
        return y if out is None else out.copy_(y)
    if dev.type != "cuda":
        raise ValueError(f"probe_add_one: unsupported device {dev}")
    if out is None:
        out = torch.empty_like(x)
    _check("x", x, torch.int32, PROBE_SHAPE, dev)
    _check("out", out, torch.int32, PROBE_SHAPE, dev)
    px, py = x.data_ptr(), out.data_ptr()
    if (px | py) & 15:
        raise ValueError("probe_add_one: x and out must be 16-byte aligned")
    LIB.launch("probe_add_one_kernel", dev, "probe_add_one_launch", px, py,
               PROBE_SHAPE[0] * PROBE_SHAPE[1])
    return out


def self_check(device: torch.device) -> None:
    """Launch the probe kernel on ``device`` (the caller's stream), copy
    the tile back and raise unless every element is right.  A failure
    stops the run: nothing carries on with the plain version."""
    device = torch.device(device)
    x = torch.zeros(PROBE_SHAPE, dtype=torch.int32, device=device)
    got = probe_add_one(x).cpu()
    want = _probe_plain(x.cpu())
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(
            f"self-check of {LIB.so} failed on {device} "
            f"({torch.cuda.get_device_name(device)}): the probe kernel "
            f"returned {bad} of {got.numel()} wrong elements; the CUDA "
            f"kernels cannot be trusted on this device")


def clamp_band(qlens: np.ndarray, w: int, max_sc: int, end_bonus: int,
               o_del: int, e_del: int, o_ins: int, e_ins: int) -> np.ndarray:
    """Per-pair band clamp (ksw.c:398-407; C truncates from double)."""
    q = qlens.astype(np.float64)
    max_ins = np.maximum(((q * max_sc + end_bonus - o_ins) / e_ins
                          + 1.0).astype(np.int32), 1)
    max_del = np.maximum(((q * max_sc + end_bonus - o_del) / e_del
                          + 1.0).astype(np.int32), 1)
    return np.minimum(np.minimum(np.int32(w), max_ins), max_del)


def pair_bytes(Q: int, state16: bool = False) -> int:
    """Shared memory of one pair in the DP kernels: H and E rows of Q + 1
    columns and ceil(Q / 8) words of 3-bit query codes (equals
    csrc/bsw_extend.cu::pair_bytes)."""
    return (Q + 1) * 2 * (2 if state16 else 4) + (Q + 7) // 8 * 4


def block_threads(Q: int, state16: bool = False) -> int:
    """Pairs (threads) per block of the DP kernels for a query-length
    class: a pure function of (Q, storage type).  Of 32, 64, 128 and 256
    the size that keeps most pairs resident on an SM, the smallest on a
    tie (finer blocks spread better over the SMs); 0 when even 32 pairs'
    rows exceed a block's shared memory, which selects the
    device-memory-scratch variant."""
    b = pair_bytes(Q, state16)
    best = resident = 0
    for t in (32, 64, 128, 256):
        need = t * b + _SMEM_STATIC
        if need > SMEM_PER_BLOCK:
            break
        blocks = min(SMEM_PER_SM // (need + _SMEM_BLOCK_RESERVE),
                     2048 // t, 32)
        if t * blocks > resident:
            best, resident = t, t * blocks
    return best


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bsw_extend_tiles(mat: torch.Tensor,      # (5, 5) int32
                     queries: torch.Tensor,  # (P, Q) int8, padded with 4
                     qlens: torch.Tensor,    # (P, 1) int32, <= Q
                     targets: torch.Tensor,  # (P, T) int8, padded with 4
                     tlens: torch.Tensor,    # (P, 1) int32, <= T
                     h0s: torch.Tensor,      # (P, 1) int32
                     ws: torch.Tensor,       # (P, 1) int32, clamped band
                     *, o_del: int, e_del: int, o_ins: int, e_ins: int,
                     zdrop: int, state16: bool = False) -> torch.Tensor:
    """The DP for P pairs -> (P, 8) int32: score, qle, tle, gtle,
    gscore, max_off, 0, 0.  The kernel for CUDA tensors, the plain
    version for CPU tensors; state16 selects int16 H/E rows in both.
    On the card ``block_threads(Q, state16)`` pairs share a block, and a
    class it gives 0 for takes the device-memory-scratch kernel."""
    dev = queries.device
    if dev.type == "cpu":
        from compseed_tpu_torch.ops.bsw import _extend_tiles_plain
        return _extend_tiles_plain(
            mat, queries, qlens, targets, tlens, h0s, ws, o_del=o_del,
            e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop,
            state16=state16)
    if dev.type != "cuda":
        raise ValueError(f"bsw_extend_tiles: unsupported device {dev}")
    return _launch_extend(
        mat, queries, qlens, targets, tlens, h0s, ws, o_del=o_del,
        e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, state16=state16,
        threads=block_threads(queries.shape[1], state16))


def _launch_extend(mat, queries, qlens, targets, tlens, h0s, ws, *, o_del,
                   e_del, o_ins, e_ins, zdrop, state16, threads: int):
    """Check the CUDA tensors and launch the DP kernel with ``threads``
    pairs a block on shared-memory rows, or with ``threads`` = 0 on a
    device-memory scratch.  ``bsw_extend_tiles`` always passes
    ``block_threads``; the card tests and measurements name other sizes
    (the scratch kernel on a class that fits, a size the card refuses).
    Raises on a non-zero return."""
    dev = queries.device
    P, Q = queries.shape
    T = targets.shape[1]
    _check("mat", mat, torch.int32, (5, 5), dev)
    _check("queries", queries, torch.int8, (P, Q), dev)
    _check("targets", targets, torch.int8, (P, T), dev)
    for name, x in (("qlens", qlens), ("tlens", tlens), ("h0s", h0s),
                    ("ws", ws)):
        _check(name, x, torch.int32, (P, 1), dev)
    out = torch.empty((P, 8), dtype=torch.int32, device=dev)
    if threads:
        kernel = "bsw_extend_kernel_i16" if state16 else "bsw_extend_kernel"
        hptr = eptr = None
    else:
        # the class's rows do not fit in shared memory: [column][pair]
        # scratch in device memory
        kernel = "bsw_extend_kernel_gmem"
        hbuf = torch.empty(((Q + 1) * P,), device=dev,
                           dtype=torch.int16 if state16 else torch.int32)
        ebuf = torch.empty_like(hbuf)
        hptr, eptr = hbuf.data_ptr(), ebuf.data_ptr()
    LIB.launch(kernel, dev,
               "bsw_extend_launch_i16" if state16 else "bsw_extend_launch",
               mat.data_ptr(), queries.data_ptr(), qlens.data_ptr(),
               targets.data_ptr(), tlens.data_ptr(), h0s.data_ptr(),
               ws.data_ptr(), out.data_ptr(), hptr, eptr, P, Q, T, o_del,
               e_del, o_ins, e_ins, zdrop, threads)
    return out


def bsw_meta_dual(mat: torch.Tensor,      # (5, 5) int32
                  qflat: torch.Tensor,    # (R * L,) uint8 read matrix
                  pac: torch.Tensor,      # (n_words,) int64, uint32 words
                  meta: torch.Tensor,     # (P, 12) int32 pair table
                  *, Q: int, T: int, L: int, l_pac: int, o_del: int,
                  e_del: int, o_ins: int, e_ins: int, zdrop: int, w0: int,
                  wide_r0: bool = False,
                  state16: bool = False) -> torch.Tensor:
    """Tile decode + both band rounds + the retry acceptance for P pairs
    in ONE launch of bsw_meta_dual_kernel -> (P, 8) int32: the six DP
    results of the accepted round, the round index, 0.  CUDA tensors
    only (the plain version is ops/bsw.py::_meta_dual_plain), and only
    query-length classes whose rows fit in shared memory
    (``block_threads(Q, state16) > 0``).  meta's columns are listed at
    ops/bsw.py::_meta_dual_core; meta[:, 0] must be a row of the read
    matrix."""
    dev = meta.device
    if dev.type != "cuda":
        raise ValueError(f"bsw_meta_dual: unsupported device {dev}")
    P = meta.shape[0]
    if L <= 0 or qflat.numel() == 0 or qflat.numel() % L:
        raise ValueError(f"qflat has {qflat.numel()} elements, expected a "
                         f"positive multiple of L={L}")
    _check("mat", mat, torch.int32, (5, 5), dev)
    _check("qflat", qflat, torch.uint8, (qflat.numel(),), dev)
    _check("pac", pac, torch.int64, (pac.numel(),), dev)
    _check("meta", meta, torch.int32, (P, 12), dev)
    if pac.numel() == 0:
        raise ValueError("pac is empty")
    threads = block_threads(Q, state16)
    if threads <= 0:
        raise ValueError(f"bsw_meta_dual: the rows of Q={Q} "
                         f"(state16={state16}) do not fit in shared memory")
    kernel = "bsw_meta_dual_kernel_i16" if state16 else "bsw_meta_dual_kernel"
    out = torch.empty((P, 8), dtype=torch.int32, device=dev)
    LIB.launch(kernel, dev, "bsw_meta_dual_launch_i16" if state16 else
               "bsw_meta_dual_launch", mat.data_ptr(), qflat.data_ptr(),
               qflat.numel() // L, pac.data_ptr(), pac.numel(),
               meta.data_ptr(), out.data_ptr(), P, Q, T, L, l_pac, o_del,
               e_del, o_ins, e_ins, zdrop, w0, int(wide_r0), threads)
    return out


_SH_ASC = tuple(8 * (t >> 2) + 2 * (3 - (t & 3)) for t in range(16))


def _pac_run(pac, start, d, K: int, T: int, n_words: int):
    """Decode T reference codes per lane along the affine position run
    pf(j) = start + d*j (d: per-lane +/-1) from the 2-bit packed words,
    with K word gathers per lane: each word unpacks to 16 codes in
    j-order (reversed within the word for descending lanes), giving a
    (P, 16*K) strip whose lane offset is start & 15 (or its mirror); a
    16-way select aligns j = 0.  Exact for any start (out-of-range
    words clip; callers mask the elements)."""
    dev = pac.device
    k = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    w0 = (start.to(torch.int64) >> 4)[:, None]
    widx = (w0 + d.to(torch.int64)[:, None] * k).clamp(0, n_words - 1)
    words = pac[widx]                                    # (P, K)
    pos = d[:, None] == 1
    sh = torch.tensor(_SH_ASC, dtype=torch.int64, device=dev)
    asc = ((words[:, :, None] >> sh) & 3).to(torch.int8)  # (P, K, 16)
    strip = torch.where(pos[:, :, None], asc, asc.flip(2)) \
        .reshape(words.shape[0], 16 * K)
    s15 = (start & 15).to(torch.int64)
    off = torch.where(pos[:, 0], s15, 15 - s15)
    out = torch.zeros((words.shape[0], T), dtype=torch.int8, device=dev)
    for o in range(16):
        out = torch.where((off == o)[:, None], strip[:, o:o + T], out)
    return out


def build_tiles(qflat, pac, qmeta, r0, rlen, *, Q: int, T: int, L: int,
                l_pac: int):
    """Packed-word tile build: queries gather 3-bit 8-char window words
    (one word per 8 cells, forward lanes from packed_windows, reverse
    lanes from packed_rev_windows), targets gather 2-bit pac words along
    BOTH fold branches (pf = gp < l_pac ? gp : 2*l_pac-1-gp has one knee
    at the strand mirror; each element selects its branch).  qmeta (P, 4)
    = rid, q0, qlen, rev; r0 (P,) index dtype; rlen (P,).  Returns
    (qt (P, Q) int8, ql (P,), tt (P, T) int8)."""
    dev = qflat.device
    i64 = torch.int64
    rid = qmeta[:, 0].to(i64)
    q0 = qmeta[:, 1].to(i64)
    ql = qmeta[:, 2]
    rev = qmeta[:, 3]
    sign = torch.where(rev == 1, -1, 1).to(i64)
    P = rid.shape[0]

    qarr = qflat.reshape(-1, L)
    fw = packed_windows(qarr, 8)                 # (R*(L+2),)
    bw = packed_rev_windows(qarr)                # (R*L,)
    qcat = torch.cat([fw, bw])
    KQ = (Q + 7) // 8
    kq = torch.arange(KQ, dtype=i64, device=dev)[None, :]
    wposf = (q0[:, None] + 8 * kq).clamp(0, L + 1)
    wposr = (q0[:, None] - 8 * kq).clamp(0, L - 1)
    addr = torch.where((rev == 1)[:, None],
                       fw.shape[0] + rid[:, None] * L + wposr,
                       rid[:, None] * (L + 2) + wposf)
    wq = qcat[addr.clamp(0, qcat.shape[0] - 1)]           # (P, KQ)
    qsh = torch.arange(0, 24, 3, dtype=i64, device=dev)
    qdec = ((wq[:, :, None] >> qsh) & 7).to(torch.int8)  # (P, KQ, 8)
    qt = qdec.reshape(P, 8 * KQ)[:, :Q]
    j = torch.arange(Q, device=dev)[None, :]
    qt = torch.where(j < ql[:, None], qt, 4).to(torch.int8).contiguous()

    KT = T // 16 + 2
    n_words = pac.shape[0]
    mir = (2 * l_pac - 1) - r0
    A = _pac_run(pac, r0, sign, KT, T, n_words)
    B = _pac_run(pac, mir, -sign, KT, T, n_words)
    j2 = torch.arange(T, dtype=i64, device=dev)[None, :]
    gp = r0.to(i64)[:, None] + sign[:, None] * j2
    fwd = gp < l_pac
    tv = torch.where(fwd, A, (3 - B).to(torch.int8))
    tt = torch.where(j2 < rlen[:, None], tv, 4).to(torch.int8).contiguous()
    return qt, ql, tt
