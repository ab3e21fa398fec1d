"""The port's libraries of hand-written CUDA kernels: build, load, launch.

A ``KernelLibrary`` is one source under ``compseed_tpu_torch/csrc/``,
built with nvcc for sm_90a at first use into
build/compseed_tpu_torch/lib<source>.so (rebuilt when the source is
newer) and loaded once per process with ctypes.  Its C launchers take the
CUDA stream as their last argument and return the CUDA error code;
``launch`` calls one with the tensors' device current in the calling
thread and that device's current stream, raises on a non-zero code and
counts the launch in ``launches``, and counts nothing else.  Worker
threads of the sharded path launch side by side, so the counts and the
one-time load take a lock.
"""

from __future__ import annotations

import ctypes as ct
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


def compile_source(src: str, so: str, defines: tuple = ()) -> None:
    """nvcc ``src`` into the shared library ``so`` with NVCC_FLAGS and the
    given -D defines.  Raises if nvcc fails."""
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(src), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
           src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)           # atomic: a loaded old copy stays valid


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
        it); returns the library's path.  Raises if nvcc fails."""
        os.makedirs(os.path.dirname(self.so), exist_ok=True)
        if force or not os.path.exists(self.so) or \
                os.path.getmtime(self.so) < os.path.getmtime(self.src):
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
