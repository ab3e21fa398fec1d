"""The port's libraries of hand-written CUDA kernels: build, load, launch.

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
"""

from __future__ import annotations

import ctypes as ct
import glob
import os
import shutil
import subprocess
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build", "compseed_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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
                   includes: tuple = ()) -> None:
    """nvcc ``src`` into the shared library ``so`` with NVCC_FLAGS, the
    given -D defines and -I directories (searched after ``src``'s own).
    Raises if nvcc fails."""
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(src), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           *(f"-I{d}" for d in includes), "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)           # atomic: a loaded old copy stays valid


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


def bind_round(lib, kernels, args_words: str, names,
               prefix: bool = False) -> None:
    """Bind a round source's launchers (``<kernel>_launch`` for each
    ``<kernel>_kernel``: its Args words and a stream, returning the CUDA
    error code) and check that its struct Args (``args_words`` names the
    C function that gives its size in words) has one word for each of
    ``names``; with ``prefix``, for each of the first of them (another
    build of the source whose launchers read only their own words)."""
    for kernel in kernels:
        fn = getattr(lib, kernel.replace("_kernel", "_launch"))
        fn.argtypes = [ct.c_void_p, ct.c_void_p]
        fn.restype = ct.c_int
    words = getattr(lib, args_words)
    words.argtypes = []
    words.restype = ct.c_int
    if not (0 < words() <= len(names) if prefix else
            words() == len(names)):
        raise RuntimeError(f"{args_words}() says struct Args has {words()} "
                           f"words, the launchers name {len(names)}")


class RoundArgs:
    """What the launch arguments of a round's kernels share
    (chain_cuda.ChainRound, walk_cuda.WalkRound): ``args``, the source's
    struct Args as one 64-bit word a field (``AT``: field -> word), kept
    at fixed addresses from round to round, apart from the
    representatives' walk, which ``set_walk`` points to.  An instance
    sets ``args``, ``dev``, ``Uw``, ``W`` and ``_held`` (its state's
    tensors, ``k`` among them)."""

    AT: dict = {}

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

    def build(self, force: bool = False) -> str:
        """Compile the source (when the library is missing or older than
        it or a header beside it); returns the library's path.  Raises if
        nvcc fails."""
        os.makedirs(os.path.dirname(self.so), exist_ok=True)
        deps = [self.src] + glob.glob(
            os.path.join(os.path.dirname(self.src), "*.cuh"))
        if force or not os.path.exists(self.so) or \
                os.path.getmtime(self.so) < max(map(os.path.getmtime, deps)):
            compile_source(self.src, self.so)
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

    def launch_args(self, kernel: str, dev: torch.device, args) -> None:
        """Launch ``kernel`` of a round source through its C launcher
        (``_kernel`` replaced by ``_launch``) with the Args words ``args``
        (a ctypes array) on ``dev``, which must be a CUDA device."""
        if dev.type != "cuda":
            raise ValueError(f"{kernel}: the kernel needs CUDA tensors, "
                             f"got {dev}")
        self.launch(kernel, dev, kernel.replace("_kernel", "_launch"),
                    ct.addressof(args))
