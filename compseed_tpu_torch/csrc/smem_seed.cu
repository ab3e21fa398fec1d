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
//   compseed_tpu_torch/ops/smem.py::_collect_plain.  A warp a lane: the
//   frontier holds at most MLEP <= 32 slots, so thread j holds slot j.
//     - The forward sweep is sequential: threads 0 and 1 rank the two
//       occ positions of each extension and the warp reads both (the
//       child is then computed alike by every thread, so the state stays
//       uniform in the warp).  A LEP push lands in the registers of the
//       thread of its slot.
//     - The list reversal is one shuffle.
//     - In the backward shrink each thread extends its own slot, ranking
//       both rows itself (ThreadRanks); slots at or past the frontier's
//       size n never reach an output and are not extended.  fail0 is slot
//       0's size, broadcast; the running max of the dedup is a warp
//       max-scan, keep a ballot and a slot's new place the popcount of
//       the ballot below it; the compaction goes through the warp's tile
//       of shared memory.
//     - An emission lands in the registers of the thread of its mems row
//       (JAX writes the row at min(n_mems, MMEM - 1), so on overflow the
//       last row is overwritten, and so here).  At the end thread j < MMEM
//       writes row j and thread 0 the three words after the rows: every
//       word of the lane's output row is written.
// smem_strategy_kernel<T>
//   Replaces compseed_tpu/ops/smem.py:222-271 _seed_strategy_one (a
//   lax.fori_loop over the read's L columns, :268) for one lane.  Plain
//   version: ops/smem.py::_seed_strategy_plain.  A pair of threads a lane
//   (fm_rank.cuh's PairRanks, as the extension kernel of fm_walk.cu): the
//   L columns in a loop, each hit's mems row stored as it is found (at
//   min(n, MMEM3 - 1)), the rows after the last hit zeroed at the end.
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
// (smem_collect_host, smem_strategy_host), the warp written as a loop
// over its slots, for the CPU tests.

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kMaxCap = 32;        // MLEP, MMEM, MMEM3: a slot a thread

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
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCollectWarps = 4;           // lanes (warps) a block
constexpr int kStrategyBlock = 64;         // threads a block, 2 a lane

// ranks(a, b, tk, tl) of the forward sweep by the lane's warp: threads 0
// and 1 rank at a and at b, every thread reads both.
template <typename T>
struct WarpRanks {
  const FmPacked<T>& fm;
  int j;
  __device__ void operator()(T a, T b, T tk[4], T tl[4]) const {
    uint32_t cnt[4] = {0, 0, 0, 0}, pc = 0;
    if (j < 2) occ_row(fm, j ? b : a, cnt, pc);
    const uint32_t pa = __shfl_sync(kFull, pc, 0);
    const uint32_t pb = __shfl_sync(kFull, pc, 1);
    for (int k = 0; k < 4; ++k) {
      tk[k] = rank_of<T>(__shfl_sync(kFull, cnt[k], 0), pa, k);
      tl[k] = rank_of<T>(__shfl_sync(kFull, cnt[k], 1), pb, k);
    }
  }
};

template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  return a > b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kCollectWarps * 32) smem_collect_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const uint8_t* __restrict__ q, int L, const int32_t* __restrict__ pivot,
    const void* __restrict__ min_hits, int hits64,
    const uint8_t* __restrict__ active, int mlep, int mmem,
    T* __restrict__ out, long long P) {
  __shared__ T tile[kCollectWarps][kMaxCap][3];
  __shared__ int32_t tile_end[kCollectWarps][kMaxCap];
  const int j = (int)(threadIdx.x & 31), w = (int)(threadIdx.x >> 5);
  const long long lane = (long long)blockIdx.x * kCollectWarps + w;
  if (lane >= P) return;                // a whole warp
  const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
  const uint8_t* ql = q + lane * (long long)L;
  Collect<T> st = collect_start(fm, ql, L, pivot[lane],
                                hits_at<T>(min_hits, hits64, lane),
                                active[lane] != 0);
  // the forward sweep; slot j of the LEP list in thread j
  T cur[3] = {0, 0, 0};
  int cur_end = 0;
  forward_sweep(fm, ql, L, mlep, st, WarpRanks<T>{fm, j},
                [&](int slot, const T ik[3], int end) {
                  if (j == slot) {
                    for (int k = 0; k < 3; ++k) cur[k] = ik[k];
                    cur_end = end;
                  }
                });
  // reversed: ascending interval sizes at slots 0..cnt-1
  {
    int src = st.cnt - 1 - j;
    src = src < 0 ? 0 : src > mlep - 1 ? mlep - 1 : src;
    for (int k = 0; k < 3; ++k) cur[k] = __shfl_sync(kFull, cur[k], src);
    cur_end = __shfl_sync(kFull, cur_end, src);
  }
  T mrow[5] = {0, 0, 0, 0, 0};         // mems row j
  const bool fast = st.pivot == 0 && !st.bad_start;
  if (fast && j == 0) {                 // only the longest match
    for (int k = 0; k < 3; ++k) mrow[k] = cur[k];
    mrow[4] = (T)cur_end;
  }
  Shrink sh{st.cnt, 0, L + 2, false, st.bad_start || fast};
  for (int u = 0; !sh.done && u <= st.pivot; ++u) {
    const int i = st.pivot - 1 - u;
    const int base = back_base(ql, i, L);
    const bool cvalid = base < 4;
    T okc[3] = {0, 0, 0};
    bool survive = false;
    if (j < sh.n && cvalid) {
      extend_sel(fm, cur, base, true, okc, ThreadRanks<T>{fm});
      survive = okc[2] >= st.min_hits;
    }
    const T s0 = __shfl_sync(kFull, okc[2], 0);
    const bool fail0 = sh.n > 0 && !(cvalid && s0 >= st.min_hits);
    int slot;
    if (emit_step(sh, i, fail0, mmem, slot)) {   // uniform in the warp
      T r[3];
      for (int k = 0; k < 3; ++k) r[k] = __shfl_sync(kFull, cur[k], 0);
      const int e0 = __shfl_sync(kFull, cur_end, 0);
      if (j == slot) {
        for (int k = 0; k < 3; ++k) mrow[k] = r[k];
        mrow[3] = (T)(i + 1);
        mrow[4] = (T)e0;
      }
    }
    // equal sizes deduplicated (the first kept): a slot survives past the
    // running max of the sizes before it
    const T masked = survive ? okc[2] : (T)-1;
    T run = masked;
    for (int d = 1; d < 32; d <<= 1) {
      const T v = __shfl_up_sync(kFull, run, d);
      if (j >= d) run = max_of(run, v);
    }
    T excl = __shfl_up_sync(kFull, run, 1);
    if (j == 0) excl = (T)-1;
    const bool keep = survive && masked > excl;
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = __popc(kept & ((1u << j) - 1u));
      for (int k = 0; k < 3; ++k) tile[w][pos][k] = okc[k];
      tile_end[w][pos] = cur_end;
    }
    __syncwarp();
    sh.n = __popc(kept);
    if (j < sh.n) {
      for (int k = 0; k < 3; ++k) cur[k] = tile[w][j][k];
      cur_end = tile_end[w][j];
    }
    __syncwarp();
    sh.done = sh.n == 0;
  }
  T* o = out + lane * (long long)(mmem * 5 + 3);
  if (j < mmem)
    for (int k = 0; k < 5; ++k) o[5 * j + k] = mrow[k];
  if (j == 0) {
    o[mmem * 5] = (T)(st.bad_start ? 0 : fast ? 1 : sh.n_mems);
    o[mmem * 5 + 1] = (T)st.ret;
    o[mmem * 5 + 2] = (T)((st.ovf || sh.ovf) ? 1 : 0);
  }
}

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
  const PairRanks<T> ranks{fm, Pair()};
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

template <typename T>
int launch_collect(const uint32_t* rows, long long n_rows, const void* L2,
                   long long primary, int fill_oob, const uint8_t* q, int L,
                   const int32_t* pivot, const void* min_hits, int hits64,
                   const uint8_t* active, int mlep, int mmem, void* out,
                   long long P, void* stream) {
  smem_collect_kernel<T>
      <<<(unsigned)((P + kCollectWarps - 1) / kCollectWarps),
         kCollectWarps * 32, 0, (cudaStream_t)stream>>>(
          rows, n_rows, (const T*)L2, primary, fill_oob, q, L, pivot,
          min_hits, hits64, active, mlep, mmem, (T*)out, P);
  return (int)cudaGetLastError();
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

// ThreadRanks that records both positions when a trace is given.
template <typename T>
struct HostRanks {
  ThreadRanks<T> rank;
  Trace* tr;
  void operator()(T a, T b, T tk[4], T tl[4]) const {
    if (tr) {
      tr->add((long long)a);
      tr->add((long long)b);
    }
    rank(a, b, tk, tl);
  }
};

// The host loops run a lane after another, the warp's slots as a loop; a
// lane that would trap on the card makes the call return -1.
template <typename F>
int host_lanes(long long n, F lane) {
  try {
    for (long long i = 0; i < n; ++i) lane(i);
  } catch (const Fault&) {
    return -1;
  }
  return 0;
}

template <typename T>
int host_collect(const uint32_t* rows, long long n_rows, const void* L2,
                 long long primary, int fill_oob, const uint8_t* q, int L,
                 const int32_t* pivot, const void* min_hits, int hits64,
                 const uint8_t* active, int mlep, int mmem, void* out,
                 long long P, Trace* tr) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
  return host_lanes(P, [&](long long lane) {
    const long long n0 = tr ? tr->n : 0;
    const uint8_t* ql = q + lane * (long long)L;
    Collect<T> st = collect_start(fm, ql, L, pivot[lane],
                                  hits_at<T>(min_hits, hits64, lane),
                                  active[lane] != 0);
    T lep[kMaxCap][3] = {}, mems[kMaxCap][5] = {};
    int lep_end[kMaxCap] = {};
    forward_sweep(fm, ql, L, mlep, st, ranks,
                  [&](int slot, const T ik[3], int end) {
                    for (int k = 0; k < 3; ++k) lep[slot][k] = ik[k];
                    lep_end[slot] = end;
                  });
    if (tr) tr->steps[lane] = (int)((tr->n - n0) / 2);
    T cur[kMaxCap][3];
    int cur_end[kMaxCap];
    for (int j = 0; j < kMaxCap; ++j) {
      int src = st.cnt - 1 - j;
      src = src < 0 ? 0 : src > mlep - 1 ? mlep - 1 : src;
      for (int k = 0; k < 3; ++k) cur[j][k] = lep[src][k];
      cur_end[j] = lep_end[src];
    }
    const bool fast = st.pivot == 0 && !st.bad_start;
    if (fast) {
      for (int k = 0; k < 3; ++k) mems[0][k] = cur[0][k];
      mems[0][4] = (T)cur_end[0];
    }
    Shrink sh{st.cnt, 0, L + 2, false, st.bad_start || fast};
    for (int u = 0; !sh.done && u <= st.pivot; ++u) {
      const int i = st.pivot - 1 - u;
      const int base = back_base(ql, i, L);
      const bool cvalid = base < 4;
      T okc[kMaxCap][3] = {};
      bool survive[kMaxCap] = {};
      for (int j = 0; j < sh.n && cvalid; ++j) {
        extend_sel(fm, cur[j], base, true, okc[j], ranks);
        survive[j] = okc[j][2] >= st.min_hits;
      }
      if (tr && sh.n > 0 && cvalid) ++tr->steps[lane];
      const bool fail0 = sh.n > 0 && !(cvalid && okc[0][2] >= st.min_hits);
      int slot;
      if (emit_step(sh, i, fail0, mmem, slot)) {
        for (int k = 0; k < 3; ++k) mems[slot][k] = cur[0][k];
        mems[slot][3] = (T)(i + 1);
        mems[slot][4] = (T)cur_end[0];
      }
      // the warp's max-scan, ballot and compaction as one pass: slot j's
      // new place is the count kept before it (at most j, so in place)
      T run = (T)-1;
      int kept = 0;
      for (int j = 0; j < sh.n; ++j) {
        const T masked = survive[j] ? okc[j][2] : (T)-1;
        if (survive[j] && masked > run) {
          for (int k = 0; k < 3; ++k) cur[kept][k] = okc[j][k];
          cur_end[kept] = cur_end[j];
          ++kept;
        }
        if (masked > run) run = masked;
      }
      sh.n = kept;
      sh.done = kept == 0;
    }
    T* o = (T*)out + lane * (long long)(mmem * 5 + 3);
    for (int j = 0; j < mmem; ++j)
      for (int k = 0; k < 5; ++k) o[5 * j + k] = mems[j][k];
    o[mmem * 5] = (T)(st.bad_start ? 0 : fast ? 1 : sh.n_mems);
    o[mmem * 5 + 1] = (T)st.ret;
    o[mmem * 5 + 2] = (T)((st.ovf || sh.ovf) ? 1 : 0);
  });
}

template <typename T>
int host_strategy(const uint32_t* rows, long long n_rows, const void* L2,
                  long long primary, int fill_oob, const uint8_t* q, int L,
                  int min_len, long long max_intv, const uint8_t* active,
                  int mmem3, void* out, long long P, Trace* tr) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
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
// The caps are 1 to 32; L at least 1.
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

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* smem_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same lanes on the host; each returns 0, or -1 for caps or an L the
// launcher refuses and where a lane would trap on the card.  With steps
// not null they record the call (Trace): the first cap positions ranked
// into pos, their count into *n_pos, each lane's steps into steps (P,).
extern "C" int smem_collect_host(const uint32_t* rows, long long n_rows,
                                 const void* L2, long long primary,
                                 int fill_oob, const uint8_t* q, int L,
                                 const int32_t* pivot, const void* min_hits,
                                 int hits64, const uint8_t* active, int mlep,
                                 int mmem, void* out, long long P, int idx64,
                                 long long* pos, long long cap,
                                 long long* n_pos, int* steps) {
  if (!caps_ok(mlep, mmem) || L < 1) return -1;
  Trace t{pos, cap, 0, steps};
  Trace* tr = steps ? &t : nullptr;
  const int e =
      idx64 ? host_collect<int64_t>(rows, n_rows, L2, primary, fill_oob, q,
                                    L, pivot, min_hits, hits64, active, mlep,
                                    mmem, out, P, tr)
            : host_collect<int32_t>(rows, n_rows, L2, primary, fill_oob, q,
                                    L, pivot, min_hits, hits64, active, mlep,
                                    mmem, out, P, tr);
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
  if (!caps_ok(mmem3, mmem3) || L < 1) return -1;
  Trace t{pos, cap, 0, steps};
  Trace* tr = steps ? &t : nullptr;
  const int e =
      idx64 ? host_strategy<int64_t>(rows, n_rows, L2, primary, fill_oob, q,
                                     L, min_len, max_intv, active, mmem3,
                                     out, P, tr)
            : host_strategy<int32_t>(rows, n_rows, L2, primary, fill_oob, q,
                                     L, min_len, max_intv, active, mmem3,
                                     out, P, tr);
  if (tr) *n_pos = t.n;
  return e;
}
#endif
