// The exact lockstep seeder's per-read programs on Hopper: collect_mem
// (rounds 1 and 2) and the fused round-3 scan of ops/smem.py.
//
// In the JAX package both are per-read programs of device loops that
// BatchSeeder vmaps and jits (compseed_tpu/ops/smem.py: _collect_fn
// :293-298, _round3_fn :300-307), so a collect call or a round-3 call is
// one device program; XLA fuses them, there is no Pallas source.  The
// port first ran each as batched eager PyTorch steps, a host test on
// every forward and backward step and one extension launch a step; here
// each call is one launch.
//
// smem_collect_kernel<T>
//   Replaces compseed_tpu/ops/smem.py:51-219 _collect_one (the forward
//   sweep, a lax.while_loop at :119, then the backward shrink over the
//   LEP frontier, a lax.while_loop at :210) for one lane.  Plain version:
//   compseed_tpu_torch/ops/smem.py::_collect_plain.  A group of G threads
//   a lane, G = 32 or 8 (smem_collect_kernel<T, G>): the frontier holds at
//   most MLEP <= 32 slots, slot j in thread j % G of the group (its
//   (j / G)-th), 32 / G a thread.
//     - The forward sweep is sequential: every pair of the group ranks the
//       two occ positions of each extension (PairRanks; the group's pairs
//       load the same two rows, which the warp's loads serve once), so
//       the state stays uniform in the group with one shuffle a word.  A
//       LEP push goes to the group's tile of shared memory.
//     - The list reversal reads the tile: slot j takes entry cnt - 1 - j.
//     - In the backward shrink each thread extends its slots below the
//       frontier's size n one after another, ranking both rows itself
//       (ThreadRanks), in place; slot 0's interval before the step (for
//       an emission) waits in shared memory.  fail0 is slot 0's size,
//       broadcast.  The running max of the dedup is an exclusive max-scan
//       over the slots in order: segment i (slots G i .. G i + G - 1, one
//       a thread) scanned across the group by shuffles, the max of the
//       segments before it carried in; segments at or past n are skipped.
//       Keep bits come from the group's bits of the warp's ballot, a
//       slot's new place the kept slots before it; the compaction goes
//       through the group's tile.
//     - Thread 0 of the group stores each emission's mems row as it is
//       found (JAX writes the row at min(n_mems, MMEM - 1), so on overflow
//       the last row is overwritten, and so here); at the end the group
//       zeroes the rows after the emitted ones and writes the three words
//       after the rows: every word of the lane's output row is written.
//   Why the group adapts: a warp a lane (the kernel's first design) kept
//   36 warps, 4,752 lanes, on an H100 SM at 56 registers, so a call of
//   8,192 lanes ran in two waves and one of 16,384 in four.  At <= 64 registers
//   (__launch_bounds__) and blocks of 128 threads, G = 8 keeps 16,896
//   lanes resident; but a frontier of n slots costs a backward step
//   ceil(n / G) extensions a thread one after another (the rerun's
//   frontiers hold 9-16 slots), so G = 8 made the narrow, backward-heavy
//   calls 30-50 % slower than a warp a lane (PERF.md).  The launcher
//   takes G = 32 for a call that runs in one wave so (collect_group: the
//   card's occupancy query times its SMs, asked once a device), else 8.
//   Slot j in thread j % G (not G consecutive slots a thread) gives
//   ceil(n / G) extensions a thread, never more than the blocked map.
// smem_strategy_kernel<T>
//   Replaces compseed_tpu/ops/smem.py:222-271 _seed_strategy_one (a
//   lax.fori_loop over the read's L columns, :268) for one lane.  Plain
//   version: ops/smem.py::_seed_strategy_plain.  A round-3 call is a few
//   thousand lanes (8,192 in the reruns), each a chain of up to L
//   dependent extensions: it runs in one wave, and its time is the
//   longest lane's steps times one step's latency.  A pair of threads a
//   lane (PairRowRanks): each thread issues its row's three quarters at
//   once (fm_rank.cuh's row_read) and ranks it, then the pair swaps the
//   counts and popcounts: the L columns in a loop, each hit's mems row
//   stored as it is found (at min(n, MMEM3 - 1)), the rows after the
//   last hit zeroed at the end by the lane's pair.  Measured against it
//   (PERF.md, H100; scripts/smem_strategy_variants.patch rebuilds them):
//   its first design (PairRanks, each row's quarters read one after
//   another) 9 % slower; one thread a lane ranking both rows
//   (ThreadRowRanks: no shuffles) 35-50 % slower, its step 0.76 us against
//   the pair's 0.61, though the card's dependent 16-byte load from L2 is
//   ~0.15 us: a step is mostly the rank's dependent arithmetic, which a
//   thread ranking two rows lengthens; the block's reads staged in
//   shared memory 1 % slower; the block writing its rows' tails word
//   after word slower than each lane's pair.
//
// The caps MLEP, MMEM and MMEM3 are launch arguments (1 to 32), read from
// the module at call time: the tests force them small to reach the
// overflows.  T is the index type (int32_t or int64_t); arithmetic on
// positions wraps in T as the plain version's tensors do, and the occ
// rows are read as fm_walk.cu reads them (fm_rank.cuh).  A lane that is
// inactive (run_collect's pad lanes, an inactive round-3 lane) reads no
// row.
//
// What bounds them: each lane is a chain of dependent extensions, one a
// column of the read, each two random occ rows; the bytes a call needs
// (ops/smem_cases.py counts them) are tens of kB to a few MB, so the
// bound by HBM bytes is microseconds and the latency of the longest
// lane's dependent steps decides (ops/smem_cases.py: the longest lane's
// steps times the dependent-step latency chip_smoke.py measures).
//
// The launchers allocate nothing, launch on the given stream of the
// calling thread's current device (ops/smem_cuda.py makes the tensors'
// device current) and return the CUDA error code.  Compiled as C++
// without nvcc, the same lane routines run in host loops
// (smem_collect_host, smem_strategy_host), the collect group written as a
// loop over its threads with the kernel's slot map, scan order and
// compaction, for the CPU tests.

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kMaxCap = 32;        // MLEP, MMEM, MMEM3

// L2[c] for c in [0, 4] by selects.
template <typename T>
FM_HD T l2_at(const FmPacked<T>& fm, int c) {
  return c == 4 ? fm.L2[4] : sel4(fm.L2, c);
}

// The bi-interval of the single base c (ops/smem.py::_set_intv).
template <typename T>
FM_HD void set_intv(const FmPacked<T>& fm, int c, T ik[3]) {
  ik[0] = wadd(l2_at(fm, c), (T)1);
  ik[1] = wadd(l2_at(fm, 3 - c), (T)1);
  ik[2] = wsub(l2_at(fm, c + 1), l2_at(fm, c));
}

// q[clip(i, 0, L - 1)] of a lane's read.
FM_HD int char_at(const uint8_t* q, int i, int L) {
  return q[i < 0 ? 0 : i > L - 1 ? L - 1 : i];
}

FM_HD int min_int(int a, int b) { return a < b ? a : b; }

// One lane's collect state outside the frontier's slots: the inputs, the
// forward sweep's interval, its end and stop, ret, the LEP count and the
// overflow.
template <typename T>
struct Collect {
  int pivot;
  T min_hits;
  bool bad_start;
  T ik[3];
  int end;
  bool stopped;
  int ret;
  int cnt;
  bool ovf;
};

// The lane's start (ops/smem.py::_collect_plain before the sweep).
template <typename T>
FM_HD Collect<T> collect_start(const FmPacked<T>& fm, const uint8_t* q,
                               int L, int pivot, T min_hits, bool active) {
  Collect<T> st;
  st.pivot = pivot;
  st.min_hits = min_hits < (T)1 ? (T)1 : min_hits;
  const int first = char_at(q, pivot, L);
  st.bad_start = first > 3 || !active;
  set_intv(fm, first > 3 ? 3 : first, st.ik);
  st.end = pivot + 1;
  st.stopped = st.bad_start;
  st.ret = st.bad_start ? pivot + 1 : L;
  st.cnt = 0;
  st.ovf = false;
  return st;
}

// A LEP push of (ik, end) at slot min(cnt, mlep - 1): push(slot, ik, end)
// stores it.
FM_FUNCTOR_CALLER
template <typename T, typename Push>
FM_HD void push_lep(Collect<T>& st, int mlep, const Push& push) {
  push(min_int(st.cnt, mlep - 1), st.ik, st.end);
  st.ovf = st.ovf || st.cnt >= mlep;
  if (st.cnt < mlep) ++st.cnt;
}

// The forward sweep (JAX smem.py:76-117 and the final push, :121-129):
// extend forward while the interval changes and stays at min_hits or
// more, pushing the interval before each change; an ambiguous base stops
// it (ret = i + 1), a too small interval too (ret = i).  ranks(a, b, tk,
// tl) gives occ4 at a and at b.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks, typename Push>
FM_HD void forward_sweep(const FmPacked<T>& fm, const uint8_t* q, int L,
                         int mlep, Collect<T>& st, const Ranks& ranks,
                         const Push& push) {
  for (int i = st.pivot + 1; !st.stopped && i < L; ++i) {
    const int base = char_at(q, i, L);
    if (base > 3) {
      push_lep(st, mlep, push);
      st.ret = i + 1;
      st.stopped = true;
      break;
    }
    T okc[3];
    extend_sel(fm, st.ik, 3 - base, false, okc, ranks);
    const bool changed = okc[2] != st.ik[2];
    if (changed) push_lep(st, mlep, push);
    if (changed && okc[2] < st.min_hits) {
      st.ret = i;
      st.stopped = true;
      break;
    }
    for (int k = 0; k < 3; ++k) st.ik[k] = okc[k];
    st.end = i + 1;
  }
  if (!st.stopped && !st.bad_start) push_lep(st, mlep, push);
}

// The backward shrink's step bookkeeping (JAX smem.py:160-173): whether
// the first slot's failure emits an SMEM (not when its begin equals the
// last emitted one's), and then its mems row min(n_mems, mmem - 1), the
// overflow and the counts.
struct Shrink {
  int n;                 // the frontier's size
  int n_mems;
  int last_beg;
  bool ovf;
  bool done;
};

FM_HD bool emit_step(Shrink& sh, int i, bool fail0, int mmem, int& slot) {
  if (!(fail0 && (sh.n_mems == 0 || i + 1 < sh.last_beg))) return false;
  slot = min_int(sh.n_mems, mmem - 1);
  sh.ovf = sh.ovf || sh.n_mems >= mmem;
  if (sh.n_mems < mmem) ++sh.n_mems;
  sh.last_beg = i + 1;
  return true;
}

// The base the backward shrink extends by at position i: -1 has none
// (4), as an ambiguous base.
FM_HD int back_base(const uint8_t* q, int i, int L) {
  return i >= 0 ? char_at(q, i, L) : 4;
}

// A collect lane's group of G threads (8 or 32) holds its frontier's
// kMaxCap slots, kMaxCap / G a thread: slot j lies in thread j % G, as that
// thread's (j / G)-th, slot_of<G>(t, i).
template <int G>
FM_HD int slot_of(int t, int i) { return t + G * i; }

// A thread's frontier slots: their intervals and ends.
template <typename T, int G>
struct Slots {
  static constexpr int kSlots = kMaxCap / G;
  T ik[kSlots][3];
  int end[kSlots];
};

// Thread t's slots of the reversed LEP list (ascending interval sizes):
// slot j < cnt takes entry cnt - 1 - j, which read(entry, ik, end) reads;
// the others are zero.
FM_FUNCTOR_CALLER
template <typename T, int G, typename Read>
FM_HD void reversed_slots(int cnt, int t, Slots<T, G>& cur,
                          const Read& read) {
  FM_UNROLL
  for (int i = 0; i < Slots<T, G>::kSlots; ++i) {
    for (int k = 0; k < 3; ++k) cur.ik[i][k] = 0;
    cur.end[i] = 0;
    const int j = slot_of<G>(t, i);
    if (j < cnt) read(cnt - 1 - j, cur.ik[i], cur.end[i]);
  }
}

// Thread t's part of a backward step (JAX smem.py:180-190): each of its
// slots below the frontier's size n extended by base c in place, one
// after another; survive[i] whether its size stays at min_hits or more.
// A c outside [0, 3] (an ambiguous base, or past the read's start)
// extends nothing and nothing survives.
FM_FUNCTOR_CALLER
template <typename T, int G, typename Ranks>
FM_HD void shrink_slots(const FmPacked<T>& fm, Slots<T, G>& cur,
                        bool* survive, int t, int n, int c, T min_hits,
                        const Ranks& ranks) {
  FM_UNROLL
  for (int i = 0; i < Slots<T, G>::kSlots; ++i) {
    survive[i] = false;
    if (c > 3 || slot_of<G>(t, i) >= n) continue;
    T okc[3];
    extend_sel(fm, cur.ik[i], c, true, okc, ranks);
    for (int k = 0; k < 3; ++k) cur.ik[i][k] = okc[k];
    survive[i] = okc[2] >= min_hits;
  }
}

// The size the dedup scans at a thread's i-th slot: -1 where the slot did
// not survive.
template <typename T, int G>
FM_HD T scan_size(const Slots<T, G>& cur, const bool* survive, int i) {
  return survive[i] ? cur.ik[i][2] : (T)-1;
}

// Thread t's slots' places in the compacted frontier from bits[i], the
// keep bits of segment i (slots G i .. G i + G - 1; bit u: slot
// slot_of<G>(u, i)): the kept slots before each, in slot order; n the kept
// slots.
template <int G>
FM_HD void keep_places(const unsigned* bits, int t, int* place, int& n) {
  n = 0;
  FM_UNROLL
  for (int i = 0; i < kMaxCap / G; ++i) {
    place[i] = n + popc(bits[i] & ((1u << t) - 1u));
    n += popc(bits[i]);
  }
}

// A mems row of the lane's output o at row `row`: the interval, its begin
// and its end.
template <typename T>
FM_HD void store_row(T* o, int row, const T ik[3], int beg, int end) {
  for (int k = 0; k < 3; ++k) o[5 * row + k] = ik[k];
  o[5 * row + 3] = (T)beg;
  o[5 * row + 4] = (T)end;
}

// The words of a lane's output o after its `rows` stored mems rows, part t
// of `parts` (every G-th word a group's thread t; parts = 1 on the host):
// the rows from `rows` on zeroed, then n_mems, ret and the overflow.
template <typename T>
FM_HD void finish_row(T* o, int mmem, int rows, int n_mems, int ret,
                      bool ovf, int t, int parts) {
  for (int w = rows * 5 + t; w < mmem * 5; w += parts) o[w] = (T)0;
  for (int w = t; w < 3; w += parts)
    o[mmem * 5 + w] = (T)(w == 0 ? n_mems : w == 1 ? ret : ovf ? 1 : 0);
}

// A hit of the round-3 scan at column i: its mems row min(n, mmem3 - 1)
// stored by store(slot, row), the overflow and the count.
FM_FUNCTOR_CALLER
template <typename T, typename Store>
FM_HD void strategy_hit(const T okc[3], int s0, int i, int mmem3, int& n,
                        bool& ovf, const Store& store) {
  const T r[5] = {okc[0], okc[1], okc[2], (T)s0, (T)(i + 1)};
  store(min_int(n, mmem3 - 1), r);
  ovf = ovf || n >= mmem3;
  if (n < mmem3) ++n;
}

// One lane's round-3 scan (JAX smem.py:240-266): at a restart column the
// single-base interval, then forward extensions until the interval is
// below max_intv with at least min_len bases (a hit, which restarts the
// scan after it) or an ambiguous base (which restarts it after that
// base).  The caller runs it on active lanes only.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks, typename Store>
FM_HD void strategy_lane(const FmPacked<T>& fm, const uint8_t* q, int L,
                         int min_len, long long max_intv, int mmem3,
                         const Ranks& ranks, const Store& store, int& n,
                         bool& ovf) {
  int s0 = 0;
  T ik[3] = {0, 0, 0};
  for (int i = 0; i < L; ++i) {
    const int base = q[i];
    if (base > 3) {
      s0 = i + 1;
      continue;
    }
    if (i == s0) {                    // s0 <= i always: a restart here
      set_intv(fm, base, ik);
      continue;
    }
    T okc[3];
    extend_sel(fm, ik, 3 - base, false, okc, ranks);
    if ((long long)okc[2] < max_intv && i - s0 >= min_len) {
      strategy_hit(okc, s0, i, mmem3, n, ovf, store);
      s0 = i + 1;
    } else {
      for (int k = 0; k < 3; ++k) ik[k] = okc[k];
    }
  }
}

// A lane's min_hits, int32 or int64 as given, in T (as .to(dt) casts it).
template <typename T>
FM_HD T hits_at(const void* min_hits, int hits64, long long lane) {
  return hits64 ? (T)((const int64_t*)min_hits)[lane]
                : (T)((const int32_t*)min_hits)[lane];
}

inline bool caps_ok(int a, int b) {
  return a >= 1 && a <= kMaxCap && b >= 1 && b <= kMaxCap;
}

#ifdef __CUDACC__
constexpr int kCollectBlock = 128;         // threads a block: 16 lanes
constexpr int kCollectBlocksPerSm = 8;     // so at most 64 registers
constexpr int kStrategyBlock = 64;         // threads a block, 2 a lane

template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  return a > b ? a : b;
}

// The dedup's keep bits of a backward step (JAX smem.py:192-207: a slot
// survives past the running max of the sizes before it, the first of
// equal sizes kept), by thread t of a group of G (mask gmask, its first
// thread gbase in the warp): segment i's exclusive max-scan across the
// group by shuffles, the max of the segments before it carried in;
// bits[i] the group's bits of the warp's ballot.  Segments at or past n
// are skipped (n is uniform in the group).
template <typename T, int G>
__device__ void keep_bits(const Slots<T, G>& cur, const bool* survive, int n,
                          int t, unsigned gmask, int gbase, unsigned* bits) {
  T carry = (T)-1;
#pragma unroll
  for (int i = 0; i < Slots<T, G>::kSlots; ++i) {
    bits[i] = 0;
    if (G * i >= n) continue;
    const T size = scan_size(cur, survive, i);
    T run = size;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const T v = __shfl_up_sync(gmask, run, d, G);
      if (t >= d) run = max_of(run, v);
    }
    const T before = __shfl_up_sync(gmask, run, 1, G);
    const T excl = t == 0 ? carry : max_of(carry, before);
    bits[i] = (__ballot_sync(gmask, survive[i] && size > excl) >> gbase) &
              (gmask >> gbase);
    if (i + 1 < Slots<T, G>::kSlots)
      carry = max_of(carry, __shfl_sync(gmask, run, G - 1, G));
  }
}

// A lane a group of G threads.  At G = 8 the index's words lie in shared
// memory, read where they are used, so that a thread's registers (at most
// 64) hold its four slots; at G = 32, one slot a thread, they stay in
// registers, off the dependent chain of every extension.  The group's
// tile holds the LEP list, then each step's compaction.
template <typename T, int G>
__global__ void __launch_bounds__(kCollectBlock, kCollectBlocksPerSm)
    smem_collect_kernel(const uint32_t* __restrict__ rows, long long n_rows,
                        const T* __restrict__ L2, long long primary,
                        int fill_oob, const uint8_t* __restrict__ q, int L,
                        const int32_t* __restrict__ pivot,
                        const void* __restrict__ min_hits, int hits64,
                        const uint8_t* __restrict__ active, int mlep,
                        int mmem, T* __restrict__ out, long long P) {
  constexpr int kLanes = kCollectBlock / G;
  constexpr int kSlots = Slots<T, G>::kSlots;
  __shared__ FmPacked<T> fm_shared;
  __shared__ T tile_ik[kLanes][3][kMaxCap];
  __shared__ int tile_end[kLanes][kMaxCap];
  __shared__ T first_ik[kLanes][3];     // slot 0's interval before a step
  FmPacked<T> fm_own;
  if constexpr (G < 32) {
    if (threadIdx.x == 0)
      fm_shared = make_fm(rows, n_rows, L2, primary, fill_oob);
    __syncthreads();
  } else {
    fm_own = make_fm(rows, n_rows, L2, primary, fill_oob);
  }
  const FmPacked<T>& fm = G < 32 ? fm_shared : fm_own;
  const int t = (int)(threadIdx.x % G), g = (int)(threadIdx.x / G);
  const long long lane = (long long)blockIdx.x * kLanes + g;
  if (lane >= P) return;                // a whole group
  const int gbase = (int)(threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask = (unsigned)(0xFFFFFFFFull >> (32 - G)) << gbase;
  T(*tk)[kMaxCap] = tile_ik[g];
  int* te = tile_end[g];
  const uint8_t* ql = q + lane * (long long)L;
  T* o = out + lane * (long long)(mmem * 5 + 3);
  Collect<T> st = collect_start(fm, ql, L, pivot[lane],
                                hits_at<T>(min_hits, hits64, lane),
                                active[lane] != 0);
  // the forward sweep, the LEP list into the tile
  forward_sweep(fm, ql, L, mlep, st, PairRanks<T>{fm, Pair()},
                [&](int slot, const T ik[3], int end) {
                  if (t == 0) {
                    for (int k = 0; k < 3; ++k) tk[k][slot] = ik[k];
                    te[slot] = end;
                  }
                });
  __syncwarp(gmask);
  Slots<T, G> cur;
  reversed_slots(st.cnt, t, cur, [&](int src, T ik[3], int& end) {
    for (int k = 0; k < 3; ++k) ik[k] = tk[k][src];
    end = te[src];
  });
  __syncwarp(gmask);
  const bool fast = st.pivot == 0 && !st.bad_start;
  if (fast && t == 0)                   // only the longest match
    store_row(o, 0, cur.ik[0], 0, cur.end[0]);
  Shrink sh{st.cnt, 0, L + 2, false, st.bad_start || fast};
  for (int u = 0; !sh.done && u <= st.pivot; ++u) {
    const int i = st.pivot - 1 - u;
    const int base = back_base(ql, i, L);
    if (t == 0)
      for (int k = 0; k < 3; ++k) first_ik[g][k] = cur.ik[0][k];
    bool survive[kSlots];
    shrink_slots(fm, cur, survive, t, sh.n, base, st.min_hits,
                 ThreadRanks<T>{fm});
    const T s0 = __shfl_sync(gmask, cur.ik[0][2], 0, G);
    const bool fail0 = sh.n > 0 && !(base < 4 && s0 >= st.min_hits);
    int slot;
    if (emit_step(sh, i, fail0, mmem, slot) && t == 0)  // uniform in the group
      store_row(o, slot, first_ik[g], i + 1, cur.end[0]);
    unsigned bits[kSlots];
    keep_bits(cur, survive, sh.n, t, gmask, gbase, bits);
    int place[kSlots], n;
    keep_places<G>(bits, t, place, n);
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if ((bits[s] >> t) & 1u) {
        for (int k = 0; k < 3; ++k) tk[k][place[s]] = cur.ik[s][k];
        te[place[s]] = cur.end[s];
      }
    __syncwarp(gmask);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = slot_of<G>(t, s);
      if (j < n) {
        for (int k = 0; k < 3; ++k) cur.ik[s][k] = tk[k][j];
        cur.end[s] = te[j];
      }
    }
    __syncwarp(gmask);
    sh.n = n;
    sh.done = n == 0;
  }
  const int n_mems = st.bad_start ? 0 : fast ? 1 : sh.n_mems;
  finish_row(o, mmem, n_mems, n_mems, st.ret, st.ovf || sh.ovf, t, G);
}

// The ranks of an extension by the pair of a lane: each thread issues its
// row's three quarters at once (row_read) and ranks it, then the two swap
// counts and popcounts.
template <typename T>
struct PairRowRanks {
  const FmPacked<T>& fm;
  Pair p;
  __device__ void operator()(T a, T b, T tk[4], T tl[4]) const {
    const bool second = p.t == 1;
    uint32_t cnt[4], other[4];
    const uint32_t pc = row_pc(row_read(fm, second ? b : a), cnt);
    const uint32_t pco = p.other(pc);
    for (int j = 0; j < 4; ++j) other[j] = p.other(cnt[j]);
    for (int j = 0; j < 4; ++j) {
      const T mine = rank_of<T>(cnt[j], pc, j);
      const T theirs = rank_of<T>(other[j], pco, j);
      tk[j] = second ? theirs : mine;
      tl[j] = second ? mine : theirs;
    }
  }
};

// Thread t of a lane's pair writes words t, t + 2, t + 4 of each row.
template <typename T>
__global__ void __launch_bounds__(kStrategyBlock) smem_strategy_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const uint8_t* __restrict__ q, int L, int min_len, long long max_intv,
    const uint8_t* __restrict__ active, int mmem3, T* __restrict__ out,
    long long P) {
  const long long lane =
      ((long long)blockIdx.x * kStrategyBlock + threadIdx.x) / 2;
  if (lane >= P) return;                // a whole pair
  const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
  const PairRowRanks<T> ranks{fm, Pair()};
  const int t = ranks.p.t;
  T* o = out + lane * (long long)(mmem3 * 5 + 2);
  int n = 0;
  bool ovf = false;
  if (active[lane])
    strategy_lane(fm, q + lane * (long long)L, L, min_len, max_intv, mmem3,
                  ranks,
                  [&](int slot, const T r[5]) {
                    FM_UNROLL
                    for (int k = 0; k < 5; ++k)
                      if ((k & 1) == t) o[5 * slot + k] = r[k];
                  },
                  n, ovf);
  for (int s = n; s < mmem3; ++s)
    for (int k = t; k < 5; k += 2) o[5 * s + k] = (T)0;
  o[mmem3 * 5 + t] = (T)(t ? (ovf ? 1 : 0) : n);
}

constexpr int kMaxDevices = 64;

// What the card gives smem_collect_kernel<T, G> (out, 6 ints): resident
// blocks an SM, lanes a block, registers a thread, local (spill) bytes a
// thread, static shared bytes a block, and G, the threads a lane.
template <typename T, int G>
int collect_occupancy(int* out) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, smem_collect_kernel<T, G>, kCollectBlock, 0);
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, smem_collect_kernel<T, G>);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = kCollectBlock / G;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = G;
  return 0;
}

// The lanes of smem_collect_kernel<T, G> the current device keeps resident
// at once (its blocks an SM x lanes a block x SMs), asked once a device;
// 0 when the query fails.
template <typename T, int G>
long long collect_resident() {
  static long long lanes[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0, occ[6];
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (!lanes[dev] &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      collect_occupancy<T, G>(occ) == 0)
    lanes[dev] = (long long)occ[0] * occ[1] * sms;
  return lanes[dev];
}

// The group a collect call of P lanes takes: a warp a lane (one frontier
// slot a thread) when the call runs in one wave so, else 8 threads a lane
// (16,896 lanes resident on an H100).  Not 16: on the rerun's 8,192-lane
// calls 16 threads a lane ran the forward sweep (the same steps in every
// thread of a group) with twice the warps an SM of 8 and took 0.157 ms
// where 8 took 0.108 (H100, PERF.md).
template <typename T>
int collect_group(long long P) {
  return P <= collect_resident<T, 32>() ? 32 : 8;
}

template <typename T, int G>
void launch_collect_group(const uint32_t* rows, long long n_rows,
                          const void* L2, long long primary, int fill_oob,
                          const uint8_t* q, int L, const int32_t* pivot,
                          const void* min_hits, int hits64,
                          const uint8_t* active, int mlep, int mmem,
                          void* out, long long P, void* stream) {
  constexpr int kLanes = kCollectBlock / G;
  smem_collect_kernel<T, G>
      <<<(unsigned)((P + kLanes - 1) / kLanes), kCollectBlock, 0,
         (cudaStream_t)stream>>>(rows, n_rows, (const T*)L2, primary,
                                 fill_oob, q, L, pivot, min_hits, hits64,
                                 active, mlep, mmem, (T*)out, P);
}

template <typename T>
int launch_collect(const uint32_t* rows, long long n_rows, const void* L2,
                   long long primary, int fill_oob, const uint8_t* q, int L,
                   const int32_t* pivot, const void* min_hits, int hits64,
                   const uint8_t* active, int mlep, int mmem, void* out,
                   long long P, void* stream) {
  if (collect_group<T>(P) == 32)
    launch_collect_group<T, 32>(rows, n_rows, L2, primary, fill_oob, q, L,
                                pivot, min_hits, hits64, active, mlep, mmem,
                                out, P, stream);
  else
    launch_collect_group<T, 8>(rows, n_rows, L2, primary, fill_oob, q, L,
                               pivot, min_hits, hits64, active, mlep, mmem,
                               out, P, stream);
  return (int)cudaGetLastError();
}

// collect_occupancy of the group a call of P lanes takes.
template <typename T>
int collect_call_occupancy(long long P, int* out) {
  return collect_group<T>(P) == 32 ? collect_occupancy<T, 32>(out)
                                   : collect_occupancy<T, 8>(out);
}

template <typename T>
int launch_strategy(const uint32_t* rows, long long n_rows, const void* L2,
                    long long primary, int fill_oob, const uint8_t* q, int L,
                    int min_len, long long max_intv, const uint8_t* active,
                    int mmem3, void* out, long long P, void* stream) {
  const long long threads = 2 * P;
  smem_strategy_kernel<T>
      <<<(unsigned)((threads + kStrategyBlock - 1) / kStrategyBlock),
         kStrategyBlock, 0, (cudaStream_t)stream>>>(
          rows, n_rows, (const T*)L2, primary, fill_oob, q, L, min_len,
          max_intv, active, mmem3, (T*)out, P);
  return (int)cudaGetLastError();
}

// What the card gives smem_strategy_kernel<T> (out, 6 ints, as
// collect_occupancy's): resident blocks an SM, lanes a block, registers,
// local bytes a thread, static shared bytes a block, threads a lane.
template <typename T>
int strategy_occupancy(int* out) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, smem_strategy_kernel<T>, kStrategyBlock, 0);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, smem_strategy_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = kStrategyBlock / 2;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = 2;
  return 0;
}
#else
// What a host loop may record of a call, for ops/smem_cases.py's work
// counts: the positions every rank asks occ4 at, in order (the first cap
// kept, n counts them all), and each lane's dependent steps (the forward
// extensions and the backward steps that extend a slot; round 3's
// extensions).
struct Trace {
  long long* pos;
  long long cap;
  long long n;
  int* steps;
  void add(long long k) {
    if (n < cap) pos[n] = k;
    ++n;
  }
};

// Ranks (ThreadRanks, or ThreadRowRanks: row_read and row_pc, as the
// round-3 kernel's pair reads and ranks a row) that record both positions
// when a trace is given.
template <typename T, typename R = ThreadRanks<T>>
struct HostRanks {
  R rank;
  Trace* tr;
  void operator()(T a, T b, T tk[4], T tl[4]) const {
    if (tr) {
      tr->add((long long)a);
      tr->add((long long)b);
    }
    rank(a, b, tk, tl);
  }
};

// The host loops run a lane after another, a collect lane's group as a
// loop over its threads; a lane that would trap on the card makes the
// call return -1.
template <typename F>
int host_lanes(long long n, F lane) {
  try {
    for (long long i = 0; i < n; ++i) lane(i);
  } catch (const Fault&) {
    return -1;
  }
  return 0;
}

// keep_bits of the kernel, the group's threads as a loop: segment i's
// running max across the threads, the segments before it carried in.
template <typename T, int G>
void keep_bits_host(const Slots<T, G>* cur, const bool (*survive)[kMaxCap / G],
                    int n, unsigned* bits) {
  T carry = (T)-1;
  for (int i = 0; i < kMaxCap / G; ++i) {
    bits[i] = 0;
    if (G * i >= n) continue;
    T run = carry;
    for (int t = 0; t < G; ++t) {
      const T size = scan_size(cur[t], survive[t], i);
      if (survive[t][i] && size > run) bits[i] |= 1u << t;
      if (size > run) run = size;
    }
    carry = run;
  }
}

// A collect call lane after lane, each lane's group of G threads as loops
// over its threads.
template <typename T, int G>
int host_collect(const uint32_t* rows, long long n_rows, const void* L2,
                 long long primary, int fill_oob, const uint8_t* q, int L,
                 const int32_t* pivot, const void* min_hits, int hits64,
                 const uint8_t* active, int mlep, int mmem, void* out,
                 long long P, Trace* tr) {
  constexpr int kSlots = kMaxCap / G;
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
  return host_lanes(P, [&](long long lane) {
    const long long n0 = tr ? tr->n : 0;
    const uint8_t* ql = q + lane * (long long)L;
    T* o = (T*)out + lane * (long long)(mmem * 5 + 3);
    Collect<T> st = collect_start(fm, ql, L, pivot[lane],
                                  hits_at<T>(min_hits, hits64, lane),
                                  active[lane] != 0);
    // the group's tile: the LEP list, then each step's compaction
    T tile[kMaxCap][3] = {};
    int tile_end[kMaxCap] = {};
    forward_sweep(fm, ql, L, mlep, st, ranks,
                  [&](int slot, const T ik[3], int end) {
                    for (int k = 0; k < 3; ++k) tile[slot][k] = ik[k];
                    tile_end[slot] = end;
                  });
    if (tr) tr->steps[lane] = (int)((tr->n - n0) / 2);
    Slots<T, G> cur[G];
    for (int t = 0; t < G; ++t)
      reversed_slots(st.cnt, t, cur[t], [&](int src, T ik[3], int& end) {
        for (int k = 0; k < 3; ++k) ik[k] = tile[src][k];
        end = tile_end[src];
      });
    const bool fast = st.pivot == 0 && !st.bad_start;
    if (fast) store_row(o, 0, cur[0].ik[0], 0, cur[0].end[0]);
    Shrink sh{st.cnt, 0, L + 2, false, st.bad_start || fast};
    for (int u = 0; !sh.done && u <= st.pivot; ++u) {
      const int i = st.pivot - 1 - u;
      const int base = back_base(ql, i, L);
      T first[3];
      for (int k = 0; k < 3; ++k) first[k] = cur[0].ik[0][k];
      bool survive[G][kSlots];
      for (int t = 0; t < G; ++t)
        shrink_slots(fm, cur[t], survive[t], t, sh.n, base, st.min_hits,
                     ranks);
      if (tr && sh.n > 0 && base < 4) ++tr->steps[lane];
      const bool fail0 =
          sh.n > 0 && !(base < 4 && cur[0].ik[0][2] >= st.min_hits);
      int slot;
      if (emit_step(sh, i, fail0, mmem, slot))
        store_row(o, slot, first, i + 1, cur[0].end[0]);
      unsigned bits[kSlots];
      keep_bits_host(cur, survive, sh.n, bits);
      int n = 0;
      for (int t = 0; t < G; ++t) {
        int place[kSlots];
        keep_places<G>(bits, t, place, n);
        for (int s = 0; s < kSlots; ++s)
          if ((bits[s] >> t) & 1u) {
            for (int k = 0; k < 3; ++k) tile[place[s]][k] = cur[t].ik[s][k];
            tile_end[place[s]] = cur[t].end[s];
          }
      }
      for (int t = 0; t < G; ++t)
        for (int s = 0; s < kSlots; ++s) {
          const int j = slot_of<G>(t, s);
          if (j < n) {
            for (int k = 0; k < 3; ++k) cur[t].ik[s][k] = tile[j][k];
            cur[t].end[s] = tile_end[j];
          }
        }
      sh.n = n;
      sh.done = n == 0;
    }
    const int n_mems = st.bad_start ? 0 : fast ? 1 : sh.n_mems;
    finish_row(o, mmem, n_mems, n_mems, st.ret, st.ovf || sh.ovf, 0, 1);
  });
}

// host_collect of the group `group` (8 or 32, the kernel's; else -1).
template <typename T>
int host_collect_group(int group, const uint32_t* rows, long long n_rows,
                       const void* L2, long long primary, int fill_oob,
                       const uint8_t* q, int L, const int32_t* pivot,
                       const void* min_hits, int hits64,
                       const uint8_t* active, int mlep, int mmem, void* out,
                       long long P, Trace* tr) {
  switch (group) {
    case 8:
      return host_collect<T, 8>(rows, n_rows, L2, primary, fill_oob, q, L,
                                pivot, min_hits, hits64, active, mlep, mmem,
                                out, P, tr);
    case 32:
      return host_collect<T, 32>(rows, n_rows, L2, primary, fill_oob, q, L,
                                 pivot, min_hits, hits64, active, mlep, mmem,
                                 out, P, tr);
    default:
      return -1;
  }
}

// Round 3 lane after lane, ranking by R (ThreadRanks or ThreadRowRanks).
template <typename T, template <typename> class R>
int host_strategy(const uint32_t* rows, long long n_rows, const void* L2,
                  long long primary, int fill_oob, const uint8_t* q, int L,
                  int min_len, long long max_intv, const uint8_t* active,
                  int mmem3, void* out, long long P, Trace* tr) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const HostRanks<T, R<T>> ranks{R<T>{fm}, tr};
  return host_lanes(P, [&](long long lane) {
    const long long n0 = tr ? tr->n : 0;
    T* o = (T*)out + lane * (long long)(mmem3 * 5 + 2);
    int n = 0;
    bool ovf = false;
    if (active[lane])
      strategy_lane(fm, q + lane * (long long)L, L, min_len, max_intv,
                    mmem3, ranks,
                    [&](int slot, const T r[5]) {
                      for (int k = 0; k < 5; ++k) o[5 * slot + k] = r[k];
                    },
                    n, ovf);
    for (int s = n; s < mmem3; ++s)
      for (int k = 0; k < 5; ++k) o[5 * s + k] = (T)0;
    o[mmem3 * 5] = (T)n;
    o[mmem3 * 5 + 1] = (T)(ovf ? 1 : 0);
    if (tr) tr->steps[lane] = (int)((tr->n - n0) / 2);
  });
}
#endif

}  // namespace

// Every entry takes the index as fm_walk.cu's do (the (n_rows, 16) packed
// rows, row count, L2 pointer in the index type, primary, fill_oob) and
// idx64 = 1 for an int64_t index type, 0 for int32_t.  Lane arrays are
// contiguous: q (P, L) base codes (uint8), pivot (P,) int32, min_hits (P,)
// int32 or (hits64 = 1) int64, active one byte a lane; out (P, mmem * 5
// + 3) for a collect, (P, mmem3 * 5 + 2) for round 3, in the index type.
// The caps are 1 to 32; L at least 1.  smem_collect_occupancy gives
// collect_occupancy's six numbers for the index type and the group a call
// of P lanes takes (on the current device) and returns the CUDA error
// code.
#ifdef __CUDACC__
extern "C" int smem_collect_launch(const uint32_t* rows, long long n_rows,
                                   const void* L2, long long primary,
                                   int fill_oob, const uint8_t* q, int L,
                                   const int32_t* pivot,
                                   const void* min_hits, int hits64,
                                   const uint8_t* active, int mlep, int mmem,
                                   void* out, long long P, int idx64,
                                   void* stream) {
  if (!caps_ok(mlep, mmem) || L < 1) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  return idx64 ? launch_collect<int64_t>(rows, n_rows, L2, primary, fill_oob,
                                         q, L, pivot, min_hits, hits64,
                                         active, mlep, mmem, out, P, stream)
               : launch_collect<int32_t>(rows, n_rows, L2, primary, fill_oob,
                                         q, L, pivot, min_hits, hits64,
                                         active, mlep, mmem, out, P, stream);
}

extern "C" int smem_strategy_launch(const uint32_t* rows, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const uint8_t* q, int L,
                                    int min_len, long long max_intv,
                                    const uint8_t* active, int mmem3,
                                    void* out, long long P, int idx64,
                                    void* stream) {
  if (!caps_ok(mmem3, mmem3) || L < 1) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  return idx64 ? launch_strategy<int64_t>(rows, n_rows, L2, primary,
                                          fill_oob, q, L, min_len, max_intv,
                                          active, mmem3, out, P, stream)
               : launch_strategy<int32_t>(rows, n_rows, L2, primary,
                                          fill_oob, q, L, min_len, max_intv,
                                          active, mmem3, out, P, stream);
}

extern "C" int smem_collect_occupancy(int idx64, long long P, int* out) {
  return idx64 ? collect_call_occupancy<int64_t>(P, out)
               : collect_call_occupancy<int32_t>(P, out);
}

extern "C" int smem_strategy_occupancy(int idx64, long long P, int* out) {
  return idx64 ? strategy_occupancy<int64_t>(out)
               : strategy_occupancy<int32_t>(out);
}

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* smem_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same lanes on the host; each returns 0, or -1 for caps or an L the
// launcher refuses, a collect group other than 8 or 32 (the kernel's slot
// maps the loops run), and where a lane would trap on the card.  With steps
// not null they record the call (Trace): the first cap positions ranked
// into pos, their count into *n_pos, each lane's steps into steps (P,).
extern "C" int smem_collect_host(const uint32_t* rows, long long n_rows,
                                 const void* L2, long long primary,
                                 int fill_oob, const uint8_t* q, int L,
                                 const int32_t* pivot, const void* min_hits,
                                 int hits64, const uint8_t* active, int mlep,
                                 int mmem, void* out, long long P, int idx64,
                                 int group, long long* pos, long long cap,
                                 long long* n_pos, int* steps) {
  if (!caps_ok(mlep, mmem) || L < 1) return -1;
  Trace t{pos, cap, 0, steps};
  Trace* tr = steps ? &t : nullptr;
  const int e =
      idx64 ? host_collect_group<int64_t>(group, rows, n_rows, L2, primary,
                                          fill_oob, q, L, pivot, min_hits,
                                          hits64, active, mlep, mmem, out, P,
                                          tr)
            : host_collect_group<int32_t>(group, rows, n_rows, L2, primary,
                                          fill_oob, q, L, pivot, min_hits,
                                          hits64, active, mlep, mmem, out, P,
                                          tr);
  if (tr) *n_pos = t.n;
  return e;
}

static int strategy_host_any(const uint32_t* rows, long long n_rows,
                             const void* L2, long long primary, int fill_oob,
                             const uint8_t* q, int L, int min_len,
                             long long max_intv, const uint8_t* active,
                             int mmem3, void* out, long long P, int idx64,
                             long long* pos, long long cap, long long* n_pos,
                             int* steps, bool row_reads) {
  if (!caps_ok(mmem3, mmem3) || L < 1) return -1;
  Trace t{pos, cap, 0, steps};
  Trace* tr = steps ? &t : nullptr;
  const auto run = [&](auto strategy) {
    return strategy(rows, n_rows, L2, primary, fill_oob, q, L, min_len,
                    max_intv, active, mmem3, out, P, tr);
  };
  const int e =
      idx64 ? (row_reads ? run(host_strategy<int64_t, ThreadRowRanks>)
                         : run(host_strategy<int64_t, ThreadRanks>))
            : (row_reads ? run(host_strategy<int32_t, ThreadRowRanks>)
                         : run(host_strategy<int32_t, ThreadRanks>));
  if (tr) *n_pos = t.n;
  return e;
}

extern "C" int smem_strategy_host(const uint32_t* rows, long long n_rows,
                                  const void* L2, long long primary,
                                  int fill_oob, const uint8_t* q, int L,
                                  int min_len, long long max_intv,
                                  const uint8_t* active, int mmem3, void* out,
                                  long long P, int idx64, long long* pos,
                                  long long cap, long long* n_pos,
                                  int* steps) {
  return strategy_host_any(rows, n_rows, L2, primary, fill_oob, q, L,
                           min_len, max_intv, active, mmem3, out, P, idx64,
                           pos, cap, n_pos, steps, false);
}

// smem_strategy_host ranking each row as the kernel's pair does, by
// row_read and row_pc (ThreadRowRanks).
extern "C" int smem_strategy_rows_host(
    const uint32_t* rows, long long n_rows, const void* L2, long long primary,
    int fill_oob, const uint8_t* q, int L, int min_len, long long max_intv,
    const uint8_t* active, int mmem3, void* out, long long P, int idx64,
    long long* pos, long long cap, long long* n_pos, int* steps) {
  return strategy_host_any(rows, n_rows, L2, primary, fill_oob, q, L,
                           min_len, max_intv, active, mmem3, out, P, idx64,
                           pos, cap, n_pos, steps, true);
}

// occ4 at each of the n positions k (in the index type) two ways: by
// row_pc(row_read(k)) into cnt_rr (n, 4) and pc_rr (n,), by occ_row into
// cnt_occ and pc_occ; -1 where a read would trap on the card.
template <typename T>
int host_row_reads(const FmPacked<T>& fm, const long long* k, long long n,
                   uint32_t* cnt_rr, uint32_t* pc_rr, uint32_t* cnt_occ,
                   uint32_t* pc_occ) {
  return host_lanes(n, [&](long long i) {
    pc_rr[i] = row_pc(row_read(fm, (T)k[i]), cnt_rr + 4 * i);
    occ_row(fm, (T)k[i], cnt_occ + 4 * i, pc_occ[i]);
  });
}

extern "C" int fm_row_read_host(const uint32_t* rows, long long n_rows,
                                const void* L2, long long primary,
                                int fill_oob, int idx64, const long long* k,
                                long long n, uint32_t* cnt_rr,
                                uint32_t* pc_rr, uint32_t* cnt_occ,
                                uint32_t* pc_occ) {
  if (idx64)
    return host_row_reads(make_fm(rows, n_rows, (const int64_t*)L2, primary,
                                  fill_oob),
                          k, n, cnt_rr, pc_rr, cnt_occ, pc_occ);
  return host_row_reads(make_fm(rows, n_rows, (const int32_t*)L2, primary,
                                fill_oob),
                        k, n, cnt_rr, pc_rr, cnt_occ, pc_occ);
}
#endif
