"""The backward chained walker's round on Hopper: launchers of
``csrc/walk_chain.cu``.

``seedscan.walk_pool_chain`` runs its round as the plain version,
``seedscan._walk_round_plain``, in a Python loop for CPU tensors, and
otherwise each segment as one CUDA graph (``cuda_lib.run_loop``): the
width's entry kernel, then a WHILE node whose body is
``seedscan._walk_round_kernels``, three hand-written kernels around one
sort and one ``fm_chain_walk_kernel`` launch, the last of which, the
apply, also runs the loop's test,

  ``key``   -> ``walk_key_kernel``    (window word, mix, sort key; the
               representatives past n_w, lane 0's);
  ``sort``  -> CUB's radix sort (csrc/key_sort.cuh: the lanes in key
               order, stable, over the key's KEY_BITS bits);
  ``group`` -> ``walk_group_kernel``  (group heads, scan, the heads'
               representatives, each group's smallest min_hits);
  ``apply`` -> ``walk_apply_kernel``  (deaths to the pool rows, survivors
               W chars on, calls, the live count; once ``set_loop`` has
               set the loop word, its last block to retire counts the
               round and runs the loop's test: rnd < RCAP and live > the
               next width);
  ``WalkRound.entry`` -> ``walk_segment_entry_kernel`` (csrc/compact.cuh:
               the previous width's lanes compacted into the width's,
               or before a call's first width its live lanes counted;
               the live count and that test before the width's first
               round).

A ``WalkRound`` holds one segment's launch arguments (the ``Args`` words
of the source, named by ``ARGS`` in order) and its scratch: the lane
state, the pool rows' results and the counters are updated in place and
the sort's storage and the representatives' walk are held by the round,
so the arguments stay fixed from round to round.  The library is
``LIB``, an ``ops/cuda_lib.KernelLibrary`` (built with nvcc for sm_90a at
first use into build/compseed_tpu_torch/libwalk_chain.so);
``DeviceSeeder`` loads it when it is built on a CUDA device.

``LAUNCHES`` counts kernel launches by kernel (and the sort's, under
``SORT``), and nothing else: a launch captured into a segment's graph
counts once, however many rounds the card replays it.  Every launch goes
to the device its tensors lie on, on that device's current stream, with
no synchronisation, under the library's lock (the sharded path's worker
threads share it); a launch on another device raises.
"""

from __future__ import annotations

import ctypes as ct

import torch

from compseed_tpu_torch.ops.cuda_lib import (KernelLibrary, RoundArgs,
                                             bind_round, check_tensor)

MAX_W = 10                  # a window packs into 30 bits

# csrc/walk_chain.cu's struct Args, one 64-bit word a field, in order
ARGS = (
    "k", "l", "s", "rid", "i", "mh", "slot", "alive",
    "rwflat", "death", "fk", "fl", "fs", "ctr",
    "rw", "key", "order",
    "gidx", "rep_rw", "rep_k", "rep_l", "rep_s", "rep_valid", "gmin",
    "ck", "cl", "cs", "ln",
    "lb_group", "sc",
    "w", "Uw", "W", "L", "n_rw", "GP", "idx64", "all4",
    "sorted_key", "iota", "sort_tmp", "sort_bytes", "key_bits",
    "rnd", "live_in", "nxtw", "rcap", "hist", "cond", "go", "loop")
# the lane arrays, in the order of their words above: what the width's
# entry moves from the previous width (its words src_<name>, after the
# loop word, so that an earlier build reads a prefix)
LANE_KEYS = ("k", "l", "s", "rid", "i", "mh", "slot", "alive")
ARGS += tuple(f"src_{n}" for n in LANE_KEYS) + ("src_w", "lb_entry")
_AT = {n: i for i, n in enumerate(ARGS)}
CALL_KEYS = ("death", "fk", "fl", "fs", "ctr")

KERNELS = ("walk_key_kernel", "walk_group_kernel", "walk_apply_kernel")
LOOP_KERNELS = ("walk_segment_entry_kernel",)
SORT = "walk_sort"          # CUB's radix sort, a library call
# the bits of a walk key: a live lane's 32-bit mix shifted right by one,
# or INT32_MAX (csrc/walk_chain.cu, key_lane)
KEY_BITS = 31
# threads a block of the group and the apply kernel (csrc/walk_chain.cu:
# kGroupBlock, kApplyBlock): a sorted position or a lane each
GROUP_BLOCK = 256
APPLY_BLOCK = 256
# words of ``sc`` (int32, csrc/walk_chain.cu: kScNw, kScNu, kScLive,
# kScEpoch, kScRetire: the apply's retire count, one 64-bit word at
# SC_RETIRE, 8-byte aligned; loop_graph.cuh)
SC_NW, SC_NU, SC_LIVE, SC_EPOCH, SC_RETIRE = 0, 1, 2, 3, 6
SC_WORDS = 8


def _bind(lib, prefix: bool = False) -> None:
    """Bind the launchers; ``prefix``: another build of the source whose
    Args is a prefix of ARGS (its round kernels only)."""
    if prefix:
        bind_round(lib, KERNELS, "walk_args_words", ARGS, prefix)
    else:
        bind_round(lib, KERNELS + LOOP_KERNELS + (SORT,), "walk_args_words",
                   ARGS, graphs="walk")


LIB = KernelLibrary("walk_chain.cu", KERNELS + LOOP_KERNELS + (SORT,), _bind,
                    "walk_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build


# launch a kernel with a round's Args words (tests patch it)
_launch = LIB.launch_args


class WalkRound(RoundArgs):
    """One segment of walk_pool_chain's loop (n lanes, ``Uw``
    representatives): the kernels' arguments and scratch.

    ``st`` is walk_pool_chain's state: the lanes (n,) ``k``, ``l``,
    ``s``, ``mh`` (index dtype), ``rid``, ``i``, ``slot`` (int32),
    ``alive`` (bool); the pool rows' results (GP,) ``death`` (int32),
    ``fk``, ``fl``, ``fs`` (index dtype); ``ctr`` (2,) int32 [calls,
    ngrp].  ``const`` holds the call's constants: ``rwflat`` (int64
    window words, R * L), ``L``, ``W`` and ``all4`` (the window word
    before the read).  The kernels update the state in place.  The round
    holds the sort's storage (``init_sort``, over KEY_BITS bits) and the
    representatives' walk (``walk``, which the apply kernel reads), and,
    once ``set_loop`` has named the segment's loop words and
    ``cuda_lib.run_loop`` has run it on a card, its graph."""

    AT = _AT
    LANE_KEYS = LANE_KEYS
    ENTRY = "walk_segment_entry_kernel"
    ENTRY_LB = "lb_group"

    def __init__(self, fm, const: dict, st: dict, Uw: int):
        dt = fm.dtype
        if dt not in (torch.int32, torch.int64):
            raise TypeError(f"index dtype {dt} is neither int32 nor int64")
        W = const["W"]
        if not 1 <= W <= MAX_W:
            raise ValueError(f"walk_pool_chain: W={W} is outside "
                             f"[1, {MAX_W}]")
        n = st["k"].shape[0] if st["k"].dim() else 0
        if not 1 <= Uw < 2**31 or n >= 2**31:
            raise ValueError(f"walk_pool_chain: Uw={Uw} or n={n} is outside "
                             f"[1, 2^31)")
        dev = st["k"].device
        GP = st["death"].shape[0] if st["death"].dim() else 0
        rwflat = const["rwflat"]
        if rwflat.dim() != 1 or rwflat.shape[0] < 1:
            raise ValueError("walk_pool_chain: rwflat must be a non-empty "
                             "vector")
        i32, i64 = torch.int32, torch.int64
        for name, x, xdt, shape in (
                ("k", st["k"], dt, (n,)), ("l", st["l"], dt, (n,)),
                ("s", st["s"], dt, (n,)), ("mh", st["mh"], dt, (n,)),
                ("rid", st["rid"], i32, (n,)), ("i", st["i"], i32, (n,)),
                ("slot", st["slot"], i32, (n,)),
                ("alive", st["alive"], torch.bool, (n,)),
                ("death", st["death"], i32, (GP,)),
                ("fk", st["fk"], dt, (GP,)), ("fl", st["fl"], dt, (GP,)),
                ("fs", st["fs"], dt, (GP,)),
                ("ctr", st["ctr"], i32, (2,)),
                ("rwflat", rwflat, i64, rwflat.shape)):
            check_tensor(name, x, xdt, shape, dev)
        self.dev, self.w, self.Uw, self.W = dev, n, Uw, W

        def e(m, dtype=i32):
            return torch.empty(m, dtype=dtype, device=dev)

        # scratch, one set per segment; the sort writes order (and
        # sorted_key, init_sort's); the look-back words (one a group
        # block) and sc start at zero (the apply's last block leaves its
        # retire count at zero again)
        n_blocks = -(-n // GROUP_BLOCK)
        self.scratch = dict(
            rw=e(n, i64), key=e(n), order=e(n, i64),
            gidx=e(n), rep_rw=e(Uw, i64), rep_k=e(Uw, dt),
            rep_l=e(Uw, dt), rep_s=e(Uw, dt), rep_valid=e(Uw, torch.bool),
            gmin=e(Uw, dt),
            lb_group=torch.zeros(max(n_blocks, 1), dtype=i64, device=dev),
            sc=torch.zeros(SC_WORDS, dtype=i32, device=dev))
        self.live = self.scratch["sc"][SC_LIVE]   # live count after apply
        self._held = {n_: st[n_] for n_ in LANE_KEYS + CALL_KEYS}
        args = (ct.c_longlong * len(ARGS))()
        for n_, x in list(self._held.items()) + list(self.scratch.items()):
            args[_AT[n_]] = x.data_ptr()
        args[_AT["rwflat"]] = rwflat.data_ptr()
        self._rwflat = rwflat                   # kept alive with the args
        for n_, x in (("w", n), ("Uw", Uw), ("W", W), ("L", const["L"]),
                      ("n_rw", rwflat.shape[0]), ("GP", GP),
                      ("idx64", int(dt == i64)), ("all4", const["all4"])):
            args[_AT[n_]] = x
        self.args = args
        self.init_sort(KEY_BITS, _sort_bytes)
        self.walk = self.walk_out()

    def launch(self, kernel: str) -> None:
        _launch(kernel, self.dev, self.args)


def _sort_bytes(n: int, bits: int) -> int:
    return LIB.load().walk_sort_bytes(n, bits)


def key(rd: WalkRound) -> None:
    """walk_key_kernel: every lane's window word and sort key."""
    _launch("walk_key_kernel", rd.dev, rd.args)


def sort(rd: WalkRound) -> None:
    """The lanes in key order (stable, over the key's bits), into the
    round's sorted_key and order arrays: CUB's radix sort (key_sort.cuh),
    equal to torch.sort(key, stable=True)."""
    _launch(SORT, rd.dev, rd.args)


def group(rd: WalkRound) -> None:
    """walk_group_kernel: groups, scan, representatives, group minima."""
    _launch("walk_group_kernel", rd.dev, rd.args)


def apply(rd: WalkRound) -> None:
    """walk_apply_kernel: deaths, survivors on, calls; the live count;
    after ``set_loop`` also the round counted and the loop's test, the
    last launch of a round."""
    _launch("walk_apply_kernel", rd.dev, rd.args)
