"""The banded-SW DP on Hopper: tile build + the hand-written CUDA kernels.

Port of compseed_tpu/ops/bsw_pallas.py.  ``bsw_extend_tiles`` is the DP
kernel's launcher: for CUDA tensors it launches
``csrc/bsw_extend.cu::bsw_extend_kernel`` — with int32 H/E rows, or with
int16 rows under ``state16=True`` — (built with nvcc for sm_90a on first
use into build/compseed_tpu_torch/, rebuilt when the source is newer) or
raises; for CPU tensors it runs the plain PyTorch version,
``ops/bsw.py::_extend_core``.  Nothing falls back from one to the other.

``probe_add_one`` launches the library's one-tile probe kernel (x + 1;
plain version ``_probe_plain``), and ``self_check`` holds it to that
plain version: it runs once for each DP engine built on a card
(``BswRunner.__init__``), and a wrong tile stops the run.  It takes the
place of the JAX package's toolchain probe (``pallas_available``), but
its verdict never selects the plain version, and there is no override.

``LAUNCHES`` counts kernel launches by kernel, and nothing else.

``build_tiles`` decodes the DP tiles on the device from pair metadata:
query rows from the chunk's read matrix (3-bit packed 8-char windows),
target rows from the 2-bit packed reference along both fold branches.
``clamp_band`` stays in numpy because it truncates from float64.
"""

from __future__ import annotations

import ctypes as ct
import os
import shutil
import subprocess

import numpy as np
import torch

from compseed_tpu_torch.ops.seedscan import packed_rev_windows, packed_windows

LT = 512            # pairs are padded to a multiple of this
PROBE_SHAPE = (8, 128)
# kernel launches since import (or the last reset), by kernel
LAUNCHES = {"bsw_extend_kernel": 0, "bsw_extend_kernel_i16": 0,
            "probe_add_one_kernel": 0}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "compseed_tpu_torch", "csrc", "bsw_extend.cu")
_BUILD = os.path.join(_ROOT, "build", "compseed_tpu_torch")
_SO = os.path.join(_BUILD, "libbsw_extend.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{_SRC}")


def build_library(force: bool = False) -> str:
    """Compile the kernel into a shared library (when missing or older
    than its source); returns its path.  Raises if nvcc fails."""
    os.makedirs(_BUILD, exist_ok=True)
    if force or not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        tmp = f"{_SO}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, _SO)      # atomic: a loaded old copy stays valid
    return _SO


def _load():
    """The library, built if need be and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ct.CDLL(build_library())
        p, i = ct.c_void_p, ct.c_int
        for fn in (lib.bsw_extend_launch, lib.bsw_extend_launch_i16):
            fn.restype = i
            fn.argtypes = [p] * 10 + [i] * 8 + [p]
        lib.probe_add_one_launch.restype = i
        lib.probe_add_one_launch.argtypes = [p, p, i, p]
        lib.bsw_cuda_error_name.restype = ct.c_char_p
        lib.bsw_cuda_error_name.argtypes = [i]
        _lib = lib
    return _lib


def _launch_error(kernel: str, device, err: int) -> RuntimeError:
    name = _lib.bsw_cuda_error_name(err).decode()
    return RuntimeError(f"{kernel} launch failed on {device} ({_SO}): CUDA "
                        f"error {err} ({name})")


def _probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel's plain version."""
    return x + 1


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for one PROBE_SHAPE int32 tile: the probe kernel for a CUDA
    tensor, its plain version for a CPU tensor."""
    dev = x.device
    if dev.type == "cpu":
        return _probe_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"probe_add_one: unsupported device {dev}")
    _check("x", x, torch.int32, PROBE_SHAPE, dev)
    lib = _load()
    y = torch.empty_like(x)
    err = lib.probe_add_one_launch(
        x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _launch_error("probe_add_one_kernel", dev, err)
    LAUNCHES["probe_add_one_kernel"] += 1
    return y


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
            f"self-check of {_SO} failed on {device} "
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
    version for CPU tensors; state16 selects int16 H/E rows in both."""
    dev = queries.device
    P, Q = queries.shape
    T = targets.shape[1]
    if dev.type == "cpu":
        from compseed_tpu_torch.ops.bsw import _extend_core
        res = _extend_core(o_del, e_del, o_ins, e_ins, zdrop, mat,
                           ws[:, 0], queries, qlens[:, 0], targets,
                           tlens[:, 0], h0s[:, 0], state16=state16)
        return torch.cat([res.T, torch.zeros((P, 2), dtype=torch.int32)],
                         dim=1).contiguous()
    if dev.type != "cuda":
        raise ValueError(f"bsw_extend_tiles: unsupported device {dev}")
    _check("mat", mat, torch.int32, (5, 5), dev)
    _check("queries", queries, torch.int8, (P, Q), dev)
    _check("targets", targets, torch.int8, (P, T), dev)
    for name, x in (("qlens", qlens), ("tlens", tlens), ("h0s", h0s),
                    ("ws", ws)):
        _check(name, x, torch.int32, (P, 1), dev)
    lib = _load()
    kernel = "bsw_extend_kernel_i16" if state16 else "bsw_extend_kernel"
    launch = lib.bsw_extend_launch_i16 if state16 else lib.bsw_extend_launch
    out = torch.empty((P, 8), dtype=torch.int32, device=dev)
    hbuf = torch.empty(((Q + 1) * P,), device=dev,
                       dtype=torch.int16 if state16 else torch.int32)
    ebuf = torch.empty_like(hbuf)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(
        mat.data_ptr(), queries.data_ptr(), qlens.data_ptr(),
        targets.data_ptr(), tlens.data_ptr(), h0s.data_ptr(), ws.data_ptr(),
        out.data_ptr(), hbuf.data_ptr(), ebuf.data_ptr(), P, Q, T,
        o_del, e_del, o_ins, e_ins, zdrop, stream)
    if err != 0:
        raise _launch_error(kernel, dev, err)
    LAUNCHES[kernel] += 1
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
