"""The exact rerun's collect and round-3 calls, for holding
smem_collect_kernel and smem_strategy_kernel (csrc/smem_seed.cu) to their
plain versions, ops/smem.py::_collect_plain and _seed_strategy_plain, and
for counting what a call's work needs (used by chip_smoke.py and the
tests).

``Capture`` keeps every call of ``smem._collect_one`` and
``smem._seed_strategy_one`` while it is active: ``calls``, a list of
``Call`` (kind "collect" or "strategy", the index, L, the arguments,
cloned, and the caps in force); each call still runs through the
dispatcher, so on a card through the kernels.  ``run(call, route)`` runs
one again by "kernel" (ops/smem_cuda.py), "plain" (the plain version on
the call's own tensors) or "host" (the source's host loops, built with
g++: ``HostTwin``), each under the call's caps; ``vs_plain`` holds the
kernel, its output poisoned first, to the plain version.  ``work`` counts, from the host loops' record
of a call, the distinct occ rows its extensions read and their bytes, the
lanes' bytes in and out, the ranks and words ranked, and each lane's
dependent steps (the longest lane's steps set the latency floor).
"""

from __future__ import annotations

import contextlib
import ctypes as ct
import dataclasses
import glob
import os
import subprocess

import numpy as np
import torch

from compseed_tpu_torch.ops import smem, smem_cuda
from compseed_tpu_torch.ops.cuda_lib import BUILD, Poisoned

KINDS = ("collect", "strategy")
KEPT = 64                   # calls of each kind a Capture keeps
POISON = 0x5A               # HostTwin's outputs' bytes before a call


@dataclasses.dataclass
class Call:
    """One call: kind, index, L, the arguments after L ((q, pivot,
    min_hits, active) or (min_len, max_intv, q, active)) and the caps."""
    kind: str
    fm: object
    L: int
    args: tuple
    caps: dict

    @property
    def lanes(self) -> int:
        return self.args[0 if self.kind == "collect" else 2].shape[0]


def caps_now(kind: str) -> dict:
    """The module's caps a call of ``kind`` reads."""
    names = ("MLEP", "MMEM") if kind == "collect" else ("MMEM3",)
    return {n: getattr(smem, n) for n in names}


@contextlib.contextmanager
def caps(values: dict):
    """ops/smem's caps set to ``values`` for the block."""
    old = {n: getattr(smem, n) for n in values}
    for n, v in values.items():
        setattr(smem, n, v)
    try:
        yield
    finally:
        for n, v in old.items():
            setattr(smem, n, v)


class Capture:
    """While active, keeps up to KEPT calls of each kind, in order, in
    ``calls``; every call is counted in ``counts`` (by kind)."""

    def __init__(self):
        self.calls = []
        self.counts = dict.fromkeys(KINDS, 0)

    def __enter__(self):
        self._orig = dict(collect=smem._collect_one,
                          strategy=smem._seed_strategy_one)

        def keep(kind):
            fn = self._orig[kind]

            def wrapped(fm, L, *args):
                self.counts[kind] += 1
                if sum(c.kind == kind for c in self.calls) < KEPT:
                    self.calls.append(Call(kind, fm, L, tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args), caps_now(kind)))
                return fn(fm, L, *args)
            return wrapped

        smem._collect_one = keep("collect")
        smem._seed_strategy_one = keep("strategy")
        return self

    def __exit__(self, *exc):
        smem._collect_one = self._orig["collect"]
        smem._seed_strategy_one = self._orig["strategy"]


class HostTwin:
    """csrc/smem_seed.cu built with g++ into its host loops
    (smem_collect_host, smem_strategy_host) in ``so`` (rebuilt when the
    source or a header beside it is newer); ``collect`` and ``strategy``
    take smem_cuda's arguments, on CPU tensors, and give its outputs,
    whose every byte was POISON before the call."""

    def __init__(self, so: str | None = None):
        src = smem_cuda.LIB.src
        self.so = so or os.path.join(BUILD, "libsmem_seed_host.so")
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
        index = [p, ll, p, ll, i]
        trace = [p, ll, p, p]
        lib.smem_collect_host.argtypes = index + \
            [p, i, p, p, i, p, i, i, p, ll, i, i] + trace
        for fn in (lib.smem_strategy_host, lib.smem_strategy_rows_host):
            fn.argtypes = index + [p, i, i, ll, p, i, p, ll, i] + trace
            fn.restype = i
        lib.smem_collect_host.restype = i
        lib.fm_row_read_host.argtypes = index + [i, p, ll, p, p, p, p]
        lib.fm_row_read_host.restype = i

    @staticmethod
    def _index(fm) -> tuple:
        occ = np.ascontiguousarray(fm.occ_packed.cpu().numpy())
        L2 = np.ascontiguousarray(fm.L2.cpu().numpy())
        return (occ, L2), [occ.ctypes.data, occ.shape[0], L2.ctypes.data,
                           int(fm.primary), int(bool(fm.fill_oob))]

    def _call(self, kind, fm, L, args, cap, trace, group=8, rows=False):
        keep, index = self._index(fm)
        P = args[0 if kind == "collect" else 2].shape[0]
        width = cap[-1] * 5 + (3 if kind == "collect" else 2)
        arrs = [np.ascontiguousarray(a.cpu().numpy())
                if isinstance(a, torch.Tensor) else a for a in args]
        out = np.empty((P, width), dtype=np.int64 if fm.dtype == torch.int64
                       else np.int32)
        out.view(np.uint8).fill(POISON)      # every word must be written
        steps = np.zeros(P, np.int32)
        n_pos = ct.c_longlong(0)
        pos = np.empty(0, np.int64)
        idx64 = int(fm.dtype == torch.int64)
        for _ in range(2 if trace else 1):   # count, then record
            rec = [pos.ctypes.data, len(pos), ct.addressof(n_pos),
                   steps.ctypes.data] if trace else [None, 0, None, None]
            if kind == "collect":
                q, piv, mh, act = arrs
                e = self.lib.smem_collect_host(
                    *index, q.ctypes.data, L, piv.ctypes.data, mh.ctypes.data,
                    int(mh.dtype == np.int64), act.ctypes.data, cap[0],
                    cap[1], out.ctypes.data, P, idx64, group, *rec)
            else:
                min_len, max_intv, q, act = arrs
                fn = self.lib.smem_strategy_rows_host if rows else \
                    self.lib.smem_strategy_host
                e = fn(
                    *index, q.ctypes.data, L, int(min_len), int(max_intv),
                    act.ctypes.data, cap[0], out.ctypes.data, P, idx64, *rec)
            if e:
                raise RuntimeError(f"smem_{kind}_host returned {e}")
            if trace and len(pos) < n_pos.value:
                pos = np.empty(n_pos.value, np.int64)
        del keep
        return torch.from_numpy(out), (pos[:n_pos.value], steps)

    def collect(self, fm, L, q, pivot, min_hits, active, mlep, mmem,
                trace=False, group=8):
        """smem_cuda.collect's output by the host loops, each lane's group
        of ``group`` threads (8 or 32: the kernel's slot map and scan
        for that group) as loops (with ``trace`` also the positions ranked
        and each lane's steps)."""
        out, rec = self._call("collect", fm, L, (q, pivot, min_hits, active),
                              (mlep, mmem), trace, group)
        return (out, rec) if trace else out

    def strategy(self, fm, L, min_len, max_intv, q, active, mmem3,
                 trace=False, rows=False):
        """smem_cuda.strategy's output by the host loops, each extension
        ranked by ThreadRanks (occ_row: a row's quarters one after
        another) or, with ``rows``, by ThreadRowRanks (row_read and
        row_pc: a row read whole, then ranked, as the kernel's pair ranks
        each row)."""
        out, rec = self._call("strategy", fm, L,
                              (min_len, max_intv, q, active), (mmem3,), trace,
                              rows=rows)
        return (out, rec) if trace else out

    def row_reads(self, fm, k) -> tuple:
        """occ4 at each position of ``k`` (int64 numpy, taken in the
        index's dtype) two ways: row_pc(row_read(k)) and occ_row (the
        counts (n, 4) and the packed popcounts (n,) of each, uint32):
        ((cnt, pc) by row_read, (cnt, pc) by occ_row)."""
        keep, index = self._index(fm)
        k = np.ascontiguousarray(k, dtype=np.int64)
        n = len(k)
        out = [np.empty((n, 4), np.uint32), np.empty(n, np.uint32),
               np.empty((n, 4), np.uint32), np.empty(n, np.uint32)]
        e = self.lib.fm_row_read_host(*index, int(fm.dtype == torch.int64),
                                      k.ctypes.data, n,
                                      *(a.ctypes.data for a in out))
        del keep
        if e:
            raise RuntimeError(f"fm_row_read_host returned {e}")
        return (out[0], out[1]), (out[2], out[3])


def run(call: Call, route: str, twin: HostTwin | None = None):
    """One captured call again, by "kernel", "plain" or "host" (``twin``),
    under its caps."""
    cap = tuple(call.caps.values())
    if route == "kernel":
        fn = smem_cuda.collect if call.kind == "collect" else \
            smem_cuda.strategy
        return fn(call.fm, call.L, *call.args, *cap)
    if route == "host":
        fn = twin.collect if call.kind == "collect" else twin.strategy
        return fn(call.fm, call.L, *call.args, *cap)
    plain = smem._collect_plain if call.kind == "collect" else \
        smem._seed_strategy_plain
    with caps(call.caps):
        return plain(call.fm, call.L, *call.args)


def vs_plain(call: Call) -> int:
    """max |kernel - plain| over the call's output (0: bit-equal), the
    kernel's output poisoned before its launch (cuda_lib.Poisoned), so
    that a word it does not write shows."""
    with Poisoned():
        got = run(call, "kernel")
    want = run(call, "plain")
    if got.shape != want.shape or got.dtype != want.dtype:
        return 1 << 62
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def work(call: Call, twin: HostTwin) -> dict:
    """What the call's work needs, from the host loops' record of it: the
    distinct occ rows its extensions rank in (row_bytes: 32 B a row, the
    counts and the first plane quarter, 48 B where a rank's offset is 64
    or more), the lanes' bytes in and out (lane_bytes), ranks, words
    ranked (hi / lo word pairs up to each rank's own word), extensions,
    and the lanes' dependent steps (max_steps, the longest lane's;
    mean_steps)."""
    fm = call.fm
    fn = twin.collect if call.kind == "collect" else twin.strategy
    _, (pos, steps) = fn(fm, call.L, *call.args, *call.caps.values(),
                         trace=True)
    k = pos[pos != -1]
    k = k - (k >= int(fm.primary))
    n = int(fm.n_rows)
    blk = k >> 7
    blk = np.where(blk < 0, blk + n, blk)
    off = k & 127
    rows = np.unique(blk)
    high = np.unique(blk[off >= 64])
    es = 8 if fm.dtype == torch.int64 else 4
    P, L = call.lanes, call.L
    if call.kind == "collect":
        q, _, mh, _ = call.args
        lane_in = P * L + 4 * P + mh.element_size() * P + P
        lane_out = P * (call.caps["MMEM"] * 5 + 3) * es
    else:
        lane_in = P * L + P
        lane_out = P * (call.caps["MMEM3"] * 5 + 2) * es
    row_bytes = 32 * len(rows) + 16 * len(high)
    return dict(lanes=P, L=L, rows=int(len(rows)), row_bytes=int(row_bytes),
                lane_bytes=int(lane_in + lane_out + 5 * es),
                bytes=int(row_bytes + lane_in + lane_out + 5 * es),
                ranks=int(len(k)), words_ranked=int(((off >> 5) + 1).sum()),
                extensions=int(len(pos) // 2),
                max_steps=int(steps.max(initial=0)),
                mean_steps=float(steps.mean()) if P else 0.0)
