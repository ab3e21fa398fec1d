"""The forward chain-memo scan's round on Hopper: launchers of
``csrc/chain_scan.cu``.

``seedscan.chain_scan`` runs its round as the plain version,
``seedscan._chain_round_plain``, in a Python loop for CPU tensors, and
otherwise each segment as one CUDA graph (``cuda_lib.run_loop``): the
segment's entry kernel, then a WHILE node whose body is
``seedscan._chain_round_kernels``, three hand-written kernels around one
sort and one ``fm_chain_walk_kernel`` launch, the last of which, the
apply, also runs the loop's test,

  ``probe`` -> ``chain_probe_kernel``  (memo probe, slot hash, sort key,
               the representatives' pads);
  ``sort``  -> CUB's radix sort (csrc/key_sort.cuh: the lanes in slot
               order, stable, over the key's KEY_BITS bits);
  ``group`` -> ``chain_group_kernel``  (group heads, scan, representatives);
  ``apply`` -> ``chain_apply_kernel``  (insert, apply, push / stop,
               advance, and the pushes to the pool in order; one build a
               window width W; once ``set_loop`` has set the loop word,
               its last block to retire counts the round and runs the
               loop's test: rnd < RCAP and live > the next segment's
               width; the histogram word);
  ``ChainRound.entry`` -> ``chain_segment_entry_kernel`` (csrc/compact.cuh:
               the previous segment's lanes compacted into the
               segment's, or before a call's first segment its live
               lanes counted; the live count and that test before the
               segment's first round).

A ``ChainRound`` holds one segment's launch arguments (the ``Args``
words of the source, named by ``ARGS`` in order) and its scratch: the
lane state, the memo, the pool and the counters are updated in place and
the sort's storage and the representatives' walk are held by the round,
so the arguments stay fixed from round to round.  The library is
``LIB``, an ``ops/cuda_lib.KernelLibrary`` (built with nvcc for sm_90a at
first use into build/compseed_tpu_torch/libchain_scan.so);
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

MAX_W = 10                  # a chain window packs into 30 bits
POOL_COLS = 6               # k, l, s, end, pivot, row

# csrc/chain_scan.cu's struct Args, one 64-bit word a field, in order
ARGS = (
    "lane0", "pivot", "pos", "alive", "k", "l", "s",
    "lane_rid0", "lane_rlen0", "mh0", "row_id0", "winflat", "nxt", "qflat",
    "L2",
    "tbl", "cst", "cur", "pool", "ctr",
    "p_wv", "p_slot", "p_hit", "p_ptr", "p_hk0", "p_hln", "key", "order",
    "gidx", "rep_wv", "rep_k", "rep_l", "rep_s", "rep_valid", "rep_slot",
    "ck", "cl", "cs", "ln",
    "lb_group", "lb_apply", "sc",
    "w", "Uw", "W", "L", "H", "M", "GP", "nq", "r3", "advance", "min_len",
    "max_intv", "idx64",
    "lane_rid",
    "sorted_key", "iota", "sort_tmp", "sort_bytes", "key_bits",
    "rnd", "live_in", "nxtw", "rcap", "hist", "cond", "go", "loop")
# the lane arrays, in the order of their words above: what the segment
# entry moves from the previous segment (its words src_<name>, after the
# loop word, so that an earlier build reads a prefix)
LANE_KEYS = ("lane0", "lane_rid", "pivot", "pos", "k", "l", "s", "alive")
ARGS += tuple(f"src_{n}" for n in LANE_KEYS) + ("src_w", "lb_entry")
_AT = {n: i for i, n in enumerate(ARGS)}

KERNELS = ("chain_probe_kernel", "chain_group_kernel", "chain_apply_kernel")
LOOP_KERNELS = ("chain_segment_entry_kernel",)
SORT = "chain_sort"         # CUB's radix sort, a library call
PROBE_BLOCK = 256           # threads a block of the probe (a lane each)
BLOCK = 256                 # threads a block of the group
APPLY_BLOCK = 64            # threads a block of the apply (a lane each)
# words of ``sc`` (int32, csrc/chain_scan.cu: kScLive, kScRetire): the live
# count; the apply's retire count, one 64-bit word at SC_RETIRE (8-byte
# aligned: the blocks retired and their live lanes, loop_graph.cuh)
SC_LIVE, SC_RETIRE, SC_WORDS = 2, 8, 10


def _bind(lib, prefix: bool = False) -> None:
    """Bind the launchers; ``prefix``: another build of the source whose
    Args is a prefix of ARGS (its round kernels only)."""
    if prefix:
        bind_round(lib, KERNELS, "chain_args_words", ARGS, prefix)
    else:
        bind_round(lib, KERNELS + LOOP_KERNELS + (SORT,), "chain_args_words",
                   ARGS, graphs="chain")


def key_bits(H: int) -> int:
    """The bits of a chain key: a live miss's slot (below H) or H."""
    return H.bit_length()


LIB = KernelLibrary("chain_scan.cu", KERNELS + LOOP_KERNELS + (SORT,), _bind,
                    "chain_cuda_error_name")
LAUNCHES = LIB.launches
build_library = LIB.build


# launch a kernel with a round's Args words (tests patch it)
_launch = LIB.launch_args


class ChainRound(RoundArgs):
    """One segment of chain_scan's loop (``w`` lanes, ``Uw``
    representatives): the kernels' arguments and scratch.

    ``st`` is chain_scan's state: the lane state (w,) ``lane0``,
    ``lane_rid`` (each lane's read id, lane_rid0[lane0], which the
    kernels only read), ``pivot``, ``pos`` (int32), ``alive`` (bool),
    ``k``, ``l``, ``s``
    (index dtype); the memo ``tbl`` (H, 8), ``cst`` (M, 3W), ``cur``
    (int32); ``pool`` (6, GP); ``ctr`` (4,) int32 [fq, fc, cursor,
    povf].  ``const`` holds the call's constants: ``lane_rid0``,
    ``lane_rlen0``, ``row_id0`` (int32, by original lane), ``mh0`` (index
    dtype), ``winflat`` (int64), ``nxt`` (R, L) int32, ``qflat`` uint8,
    and the sizes ``W``, ``L``, ``GP``, ``r3``, ``advance``, ``min_len``,
    ``max_intv``.  The kernels update the state in place.  The round
    holds the sort's storage (``init_sort``, over ``key_bits(H)`` bits)
    and the representatives' walk (``walk``, which the apply kernel
    reads), and, once ``set_loop`` has named the segment's loop words and
    ``cuda_lib.run_loop`` has run it on a card, its graph.  A pad lane's
    read id is lane_rid0[0], lane 0's."""

    AT = _AT
    LANE_KEYS = LANE_KEYS
    ENTRY = "chain_segment_entry_kernel"
    ENTRY_LB = "lb_apply"

    def __init__(self, fm, const: dict, st: dict, w: int, Uw: int):
        dt = fm.dtype
        if dt not in (torch.int32, torch.int64):
            raise TypeError(f"index dtype {dt} is neither int32 nor int64")
        W = const["W"]
        if not 1 <= W <= MAX_W:
            raise ValueError(f"chain_scan: W={W} is outside [1, {MAX_W}]")
        if not 1 <= Uw <= w:
            raise ValueError(f"chain_scan: Uw={Uw} is outside [1, w={w}]")
        dev = st["k"].device
        H, M = st["tbl"].shape[0], st["cst"].shape[0]
        GP = const["GP"]
        i32, i64 = torch.int32, torch.int64
        for name, x, xdt, shape in (
                ("lane0", st["lane0"], i32, (w,)),
                ("lane_rid", st["lane_rid"], i32, (w,)),
                ("pivot", st["pivot"], i32, (w,)),
                ("pos", st["pos"], i32, (w,)),
                ("alive", st["alive"], torch.bool, (w,)),
                ("k", st["k"], dt, (w,)), ("l", st["l"], dt, (w,)),
                ("s", st["s"], dt, (w,)),
                ("tbl", st["tbl"], dt, (H, 8)),
                ("cst", st["cst"], dt, (M, 3 * W)),
                ("cur", st["cur"], i32, ()),
                ("pool", st["pool"], dt, (POOL_COLS, GP)),
                ("ctr", st["ctr"], i32, (4,)),
                ("lane_rid0", const["lane_rid0"], i32,
                 const["lane_rid0"].shape),
                ("lane_rlen0", const["lane_rlen0"], i32,
                 const["lane_rid0"].shape),
                ("row_id0", const["row_id0"], i32, const["lane_rid0"].shape),
                ("mh0", const["mh0"], dt, const["lane_rid0"].shape),
                ("winflat", const["winflat"], i64, const["winflat"].shape),
                ("nxt", const["nxt"], i32, const["nxt"].shape),
                ("qflat", const["qflat"], torch.uint8, const["qflat"].shape),
                ("L2", fm.L2, dt, (5,))):
            check_tensor(name, x, xdt, shape, dev)
        if H & (H - 1) or H >= 2**31 or M >= 2**31:
            raise ValueError(f"chain_scan: H={H} must be a power of two "
                             f"below 2^31 and M={M} below 2^31")
        if st["tbl"].data_ptr() % 16:
            raise ValueError("the memo table must be 16-byte aligned (its "
                             "rows are read as 16-byte words)")
        self.dev, self.w, self.Uw, self.W = dev, w, Uw, W

        def e(n, dtype=i32):
            return torch.empty(n, dtype=dtype, device=dev)

        # scratch, one set per segment; the sort writes order (and
        # sorted_key, init_sort's); the look-back words (a word a block of
        # the apply, the kernel with the most blocks) and sc start at zero
        # (the apply's last block leaves its retire count at zero again)
        n_blocks = -(-w // APPLY_BLOCK)
        self.scratch = dict(
            p_wv=e(w, i64), p_slot=e(w), p_hit=e(w, torch.uint8),
            p_ptr=e(w), p_hk0=e(w, dt), p_hln=e(w), key=e(w),
            order=e(w, i64), gidx=e(w),
            rep_wv=e(Uw, i64), rep_k=e(Uw, dt), rep_l=e(Uw, dt),
            rep_s=e(Uw, dt), rep_valid=e(Uw, torch.bool), rep_slot=e(Uw),
            lb_group=torch.zeros(n_blocks, dtype=i64, device=dev),
            lb_apply=torch.zeros(n_blocks, dtype=i64, device=dev),
            sc=torch.zeros(SC_WORDS, dtype=i32, device=dev))
        self.live = self.scratch["sc"][SC_LIVE]  # live count after apply
        self._held = {n: st[n] for n in LANE_KEYS + ("tbl", "cst", "cur",
                                                     "pool", "ctr")}
        self.pads = {"lane_rid": const["lane_rid0"][:1]}
        args = (ct.c_longlong * len(ARGS))()
        for n, x in list(self._held.items()) + list(self.scratch.items()):
            args[_AT[n]] = x.data_ptr()
        for n in ("lane_rid0", "lane_rlen0", "mh0", "row_id0", "winflat",
                  "nxt", "qflat"):
            args[_AT[n]] = const[n].data_ptr()
        args[_AT["L2"]] = fm.L2.data_ptr()
        for n, x in (("w", w), ("Uw", Uw), ("W", W), ("L", const["L"]),
                     ("H", H), ("M", M), ("GP", GP),
                     ("nq", const["qflat"].shape[0]),
                     ("r3", int(bool(const["r3"]))),
                     ("advance", int(bool(const["advance"]))),
                     ("min_len", int(const["min_len"])),
                     ("max_intv", int(const["max_intv"])),
                     ("idx64", int(dt == i64))):
            args[_AT[n]] = x
        self.args = args
        self.init_sort(key_bits(H), _sort_bytes)
        self.walk = self.walk_out()

    def launch(self, kernel: str) -> None:
        _launch(kernel, self.dev, self.args)


def _sort_bytes(n: int, bits: int) -> int:
    return LIB.load().chain_sort_bytes(n, bits)


def probe(rd: ChainRound) -> None:
    """chain_probe_kernel: every lane's memo probe and sort key."""
    _launch("chain_probe_kernel", rd.dev, rd.args)


def sort(rd: ChainRound) -> None:
    """The lanes in slot order (stable, over the key's bits), into the
    round's sorted_key and order arrays: CUB's radix sort (key_sort.cuh),
    equal to torch.sort(key, stable=True)."""
    _launch(SORT, rd.dev, rd.args)


def group(rd: ChainRound) -> None:
    """chain_group_kernel: groups, scan, representatives, store cursor."""
    _launch("chain_group_kernel", rd.dev, rd.args)


def apply(rd: ChainRound) -> None:
    """chain_apply_kernel: inserts, chains applied, lanes advanced, the
    pushes to the pool (cursor, povf); the live count; after ``set_loop``
    also the round counted and the loop's test, the last launch of a
    round."""
    _launch("chain_apply_kernel", rd.dev, rd.args)
