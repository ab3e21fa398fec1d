// The round body of the backward chained walker (ops/seedscan.py::
// walk_pool_chain), the default seeding engine's backward walk.
//
// In the JAX package the round is make_body (compseed_tpu/ops/seedscan.py
// :628-721), run inside jax.lax.while_loop: XLA compiles it into a few
// fusions around one sort.  The port rendered it as some 220 PyTorch
// operations a round (the uint32 mix emulated in int64, every scatter a
// copy of its destination, four of them pool-long).  These kernels are the
// port's counterpart of XLA's fusions; the sort is CUB's radix sort over
// 31 bits (key_sort.cuh; XLA's sort in the JAX package), the
// representatives' walk fm_chain_walk_kernel (csrc/fm_walk.cu), the
// compaction between widths and the while_loop's cond before a width's
// first round walk_segment_entry_kernel (compact.cuh), and the cond after
// each round the apply kernel's last block to retire
// (loop_graph.cuh::loop_retire): a width's rounds run as one CUDA graph
// (loop_graph.cuh).  One round:
//
// walk_key_kernel<T>         one thread a lane (and a representative)
//   Replaces JAX seedscan.py:633-645 (port seedscan.py _walk_key_plain).
//   The lane's window word (the W chars below its position, packed 3
//   bits each; all 4s before the read), the 32-bit mix of (window, k, s)
//   in native uint32 arithmetic and the sort key: mix >> 1 for a live
//   lane, INT32_MAX else.  It also counts the round (the group scan's
//   epoch), zeroes the live count, sets the group minima to T's max and
//   writes every representative j < Uw as the plain step leaves a pad
//   (lane 0's window, k, l and s, not valid: the zero-filled rep_take),
//   lane 0's words read beside the lane's own; the group kernel then
//   overwrites only the heads j < n_w.
// (the sort of the keys, stable: the lanes in key order; key_sort.cuh)
// walk_group_kernel<T>       one thread a sorted position
//   Replaces JAX :646-670 (_walk_group_plain).  Group heads over the
//   sorted lanes (a live lane whose (window, k, s) differs from its sorted
//   predecessor's, live or not), their exclusive scan in sorted order
//   (lookback.cuh::scan_blocks: a block scan, then a warp-wide look-back
//   across blocks), each lane's group index, and the first Uw heads'
//   representatives (window, k, l, s, valid) written by the head's own
//   thread: a snapshot, since the apply kernel rewrites the lanes in
//   place.  The group minimum of min_hits (the plain step's segment min
//   over the clamped group index of mh for a live lane below Uw,
//   INT32_MAX for any other) by a segmented min over each warp's run of
//   equal groups, then one atomicMin a run: a group is a contiguous run in
//   sorted order and an integer min does not depend on order, so it is
//   exact.  The last block writes n_u and n_w = min(n_u, Uw) and adds n_w
//   to ngrp.
// (fm_chain_walk_kernel on the representatives, stopping at each group's
// minimum)
// walk_apply_kernel<T, W>    one thread a lane (and a representative)
//   Replaces JAX :682-720 (_walk_apply_plain).  A live lane whose group is
//   walked reads the group's W chain states, re-bases l by its offset from
//   the representative's l (the snapshot), finds the first step that kills
//   it (an ambiguous char, or an interval below its min_hits) and writes
//   the state before that step and its death position to its pool row;
//   a survivor takes the chain's last state and moves W chars down.  A
//   lane of another group waits a round unchanged.  Representative j adds
//   its walk's length to calls when valid; the live count after the round
//   is what the loop tests: in a loop (the loop word set) the last block
//   to retire counts the round and tests the next.
//
// T is the index type, int32_t or int64_t (fm.dtype): intervals and the
// pool's fk, fl, fs are T, and interval arithmetic wraps in T as the
// plain version's tensors do.  Window words hold 3 W <= 30 bits; the mix
// reads their low 32 bits, as the JAX package's uint32 words are.
//
// What bounds them on Hopper.  A round moves little: per lane its state
// (a few words), its window word and its key, per walked lane its group's
// chain (3 W words, L2-resident: a group's members read the same row),
// per death four words of its pool row; a few MB at most, about a
// microsecond at 3.35 TB/s.  What decides is, in a narrow round, latency:
// a launch, the dependent round trips to memory of a thread, the scan
// across blocks, any work that one block does alone; in a wide one, the
// L2 sectors of the gathers: the group reads its lanes in key order and
// the apply its groups' rows in lane order, so each word read is a
// 32-byte sector of its own (a 393,216-lane round: ~4 TB/s of them, five
// times the bytes' bound).  The design cuts each:
//   - the group: a block takes its sorted positions from its block index
//     and issues their order entries (p and p - 1) beside its ticket's
//     atomic, loading them again only when the ticket differs; then every
//     word of its head test at once (alive, window, k, s of the lane; its
//     predecessor's window, k and s, shuffled from the thread before),
//     none behind a test; then the scan (scan_blocks: 32 status words a
//     step, where a one-thread look-back walked one a round trip, over the
//     1,536 blocks of a 393,216-lane round); then l and mh only where a
//     representative or a group minimum takes them.
//   - no one-block tail: the pads past n_w, which the last group block
//     wrote alone (up to Uw - n_w of 196,608 in a width's later rounds),
//     are written by the key kernel, a thread each.
//   - the apply: W is a template parameter (launch_apply picks it), so the
//     column loops have fixed trip counts and the s row stays in
//     registers; a lane reads its alive and group index, then its state and
//     its death test's inputs (length, rep l and the cs row as 16-byte loads
//     where a row allows) in one level, then the k and l words of the
//     column it keeps, if any (reading the ck and cl rows beside the cs row
//     paid two sectors for every lane that dies at its first step, most of
//     the deaths, and was slower at every width but one block); calls and
//     the live count are summed over the block, one atomic each a block of
//     256 (blocks of 64 and 128 were slower in a chunk).
// A round is four launches of its own (the walk's included), one pass over
// the lanes each on every SM, and writes the pool rows in place (the plain
// round copies the four pool-long columns at every scatter); the loop's
// test needs no launch of its own (the first design ended every round
// with a one-thread cond kernel), and a width starts with one launch,
// walk_segment_entry_kernel (compact.cuh), which compacts the previous
// width's lanes and tests the first round (the first design: some 21
// PyTorch operations, then a one-thread entry kernel).
//
// The launchers take the arguments as one array of 64-bit words, the
// struct Args below (ops/walk_cuda.py::ARGS names them in order); they
// allocate nothing, launch on the caller's stream of the calling thread's
// current device and return the CUDA error code.  Built with nvcc for
// sm_90a into a shared library with a plain C interface.  Compiled as C++
// without nvcc, the same lane routines run in host loops (walk_*_host),
// so that the CPU tests hold their arithmetic to the plain version.

#include <cstddef>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "lookback.cuh"
#define WC_HD __host__ __device__ __forceinline__
#define WC_UNROLL _Pragma("unroll")
#else
#define WC_HD inline
#define WC_UNROLL
#endif

#include "compact.cuh"
#include "key_sort.cuh"
#include "loop_graph.cuh"

namespace {

constexpr int kMaxW = 10;                  // a window packs into 30 bits
constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr uint32_t kMixK = 0x9E3779B9u, kMixS = 0x85EBCA6Bu,
                   kMixF = 0xC2B2AE35u;
// the words of sc (the apply's retire count: loop_graph.cuh::loop_retire;
// the epoch and the ticket counter serve the segment entry too:
// compact.cuh)
constexpr int kScNw = 0, kScNu = 1, kScLive = 2, kScEpoch = 3,
              kScTicket = 4, kScRetire = 6;   // 6-7: one 64-bit word

// The launch arguments, one 64-bit word each (pointers as addresses).
struct Args {
  // lane state (w lanes): k, l, s, mh in T; rid, i, slot int32; alive
  // bool; the apply kernel updates k, l, s, i and alive in place
  long long k, l, s, rid, i, mh, slot, alive;
  // per call: the reversed windows (n_rw int64 words); the results by
  // pool row (GP), death int32 and fk, fl, fs in T, written in place;
  // the counters [calls, ngrp] (int32)
  long long rwflat, death, fk, fl, fs, ctr;
  // key outputs (w): window word (int64), sort key (int32); the sorted
  // order (w, int64)
  long long rw, key, order;
  // group outputs: group index by lane (w, int32); representatives (Uw):
  // window (int64), k, l, s (T), valid (bool), the group's smallest
  // min_hits (T)
  long long gidx, rep_rw, rep_k, rep_l, rep_s, rep_valid, gmin;
  // the representatives' walk (Uw x W in T, Uw int32)
  long long ck, cl, cs, ln;
  // look-back status words of the group kernel (a word a block); [n_w,
  // n_u, live, epoch, group ticket, -, the apply's retire count (64 bits,
  // words 6-7)]
  long long lb_group, sc;
  // sizes
  long long w, Uw, W, L, n_rw, GP, idx64;
  // the window word of a lane before the read (every char 4: the plain
  // version's _ALL4)
  long long all4;
  // the sort (key_sort.cuh): sorted keys (w), the lane indices 0..w-1
  // (int64), its temporary storage and size in bytes, the key's bits
  long long sorted_key, iota, sort_tmp, sort_bytes, key_bits;
  // the segment's loop (loop_graph.cuh): the call's round counter (one
  // int32), the live count the previous width left (one int32, read by
  // the entry's pads; 0 before a call's first width), the next segment's
  // width, RCAP, a live-lane histogram (walk_pool_chain keeps none: 0),
  // the WHILE node's condition handle (0 outside a graph) and the
  // condition's last value (one int32)
  long long rnd, live_in, nxtw, rcap, hist, cond, go;
  // 1: the apply kernel ends a loop's body and runs the loop's test after
  // the round (loop_retire); 0 (a launch of its own): it touches no loop
  // word.  After the words above, so that an earlier build reads a prefix
  long long loop;
  // the width's entry (compact.cuh): the previous width's lanes (src_w
  // of each, in the order of the lane words above: k, l, s, rid, i, mh,
  // slot, alive) and its width, 0 before a call's first width; the
  // entry's look-back words (a word a block: the group's, lb_group, where
  // they are enough)
  long long src_k, src_l, src_s, src_rid, src_i, src_mh, src_slot,
      src_alive, src_w, lb_entry;
};

// walk_pool_chain's lane arrays as the segment entry moves them
// (compact.cuh): rid, i, slot and k, l, s, mh; the pads all 0.
template <typename T>
WC_HD LaneSet<T, 3, 4> walk_lanes(const Args& a) {
  LaneSet<T, 3, 4> s;
  const long long src32[3] = {a.src_rid, a.src_i, a.src_slot};
  const long long dst32[3] = {a.rid, a.i, a.slot};
  const long long srcT[4] = {a.src_k, a.src_l, a.src_s, a.src_mh};
  const long long dstT[4] = {a.k, a.l, a.s, a.mh};
  for (int j = 0; j < 3; ++j) {
    s.src32[j] = (const int32_t*)src32[j];
    s.dst32[j] = (int32_t*)dst32[j];
    s.pad32[j] = 0;
  }
  for (int j = 0; j < 4; ++j) {
    s.srcT[j] = (const T*)srcT[j];
    s.dstT[j] = (T*)dstT[j];
  }
  s.src_alive = (const bool*)a.src_alive;
  s.dst_alive = (bool*)a.alive;
  return s;
}

template <typename T>
struct Unsigned;
template <>
struct Unsigned<int32_t> {
  using type = uint32_t;
};
template <>
struct Unsigned<int64_t> {
  using type = uint64_t;
};

template <typename T>
WC_HD T wadd(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a + (U)b);
}

template <typename T>
WC_HD T wsub(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a - (U)b);
}

template <typename T>
WC_HD T max_of();
template <>
WC_HD int32_t max_of<int32_t>() {
  return INT32_MAX;
}
template <>
WC_HD int64_t max_of<int64_t>() {
  return INT64_MAX;
}

// The index of the lowest set bit of x != 0.
WC_HD int low_bit(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

WC_HD long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The sort key's mix of a window word and an interval's k and s: the JAX
// package's uint32 arithmetic (k >> 31 shifts the sign-extended value
// arithmetically, then both are cut to their low 32 bits).
WC_HD uint32_t walk_mix(long long rw, int64_t k, int64_t s) {
  const uint32_t ku = (uint32_t)k ^ (uint32_t)(k >> 31);
  const uint32_t su = (uint32_t)s ^ (uint32_t)(s >> 31);
  const uint32_t m = (uint32_t)rw ^ (ku * kMixK) ^ (su * kMixS);
  return (m ^ (m >> 15)) * kMixF;
}

// The vector a row load moves at once: kBytes (16, 8 or 4).
template <int kBytes>
struct Vec;
#ifdef __CUDACC__
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<4> {
  using type = unsigned;
};
#endif

// A chain row of kW words of T (row kW * sizeof(T) bytes into an array
// aligned to 16 bytes): on the card as the widest vectors the row's size
// allows, 16 bytes where it is a multiple of 16.
template <typename T, int kW>
WC_HD void load_row(const T* row, T (&out)[kW]) {
#ifdef __CUDA_ARCH__
  constexpr int kBytes = kW * (int)sizeof(T);
  constexpr int kVec = kBytes % 16 == 0 ? 16 : (kBytes % 8 == 0 ? 8 : 4);
  using V = typename Vec<kVec>::type;
  V x[kBytes / kVec];
  const V* p = reinterpret_cast<const V*>(row);
  WC_UNROLL
  for (int q = 0; q < kBytes / kVec; ++q) x[q] = p[q];
  const T* t = reinterpret_cast<const T*>(x);
  WC_UNROLL
  for (int c = 0; c < kW; ++c) out[c] = t[c];
#else
  for (int c = 0; c < kW; ++c) out[c] = row[c];
#endif
}

// Typed views of the arguments.  Within a launch no two of them share
// memory (__restrict__); an array a kernel writes is written at indices
// that no other thread of that kernel reads.
template <typename T>
struct View {
  T *__restrict__ k, *__restrict__ l, *__restrict__ s;
  int32_t *__restrict__ rid, *__restrict__ i, *__restrict__ slot;
  const T* __restrict__ mh;
  uint8_t* __restrict__ alive;
  const long long* __restrict__ rwflat;
  int32_t* __restrict__ death;
  T *__restrict__ fk, *__restrict__ fl, *__restrict__ fs;
  int32_t* __restrict__ ctr;
  long long* __restrict__ rw;
  int32_t* __restrict__ key;
  const long long* __restrict__ order;
  int32_t* __restrict__ gidx;
  long long* __restrict__ rep_rw;
  T *__restrict__ rep_k, *__restrict__ rep_l, *__restrict__ rep_s;
  uint8_t* __restrict__ rep_valid;
  T* __restrict__ gmin;
  const T *__restrict__ ck, *__restrict__ cl, *__restrict__ cs;
  const int32_t* __restrict__ ln;
  unsigned long long* __restrict__ lb_group;
  int32_t* __restrict__ sc;

  WC_HD explicit View(const Args& a)
      : k((T*)a.k),
        l((T*)a.l),
        s((T*)a.s),
        rid((int32_t*)a.rid),
        i((int32_t*)a.i),
        slot((int32_t*)a.slot),
        mh((const T*)a.mh),
        alive((uint8_t*)a.alive),
        rwflat((const long long*)a.rwflat),
        death((int32_t*)a.death),
        fk((T*)a.fk),
        fl((T*)a.fl),
        fs((T*)a.fs),
        ctr((int32_t*)a.ctr),
        rw((long long*)a.rw),
        key((int32_t*)a.key),
        order((const long long*)a.order),
        gidx((int32_t*)a.gidx),
        rep_rw((long long*)a.rep_rw),
        rep_k((T*)a.rep_k),
        rep_l((T*)a.rep_l),
        rep_s((T*)a.rep_s),
        rep_valid((uint8_t*)a.rep_valid),
        gmin((T*)a.gmin),
        ck((const T*)a.ck),
        cl((const T*)a.cl),
        cs((const T*)a.cs),
        ln((const int32_t*)a.ln),
        lb_group((unsigned long long*)a.lb_group),
        sc((int32_t*)a.sc) {}
};

// ---------------------------------------------------------------------------
// The lane routines, shared by the kernels and the host loops.

// The window word of a lane of read rid at position i: the W chars below
// it, all4 before the read.
template <typename T>
WC_HD long long window_of(const View<T>& v, const Args& a, int rid, int i) {
  if (i < 0) return a.all4;
  return v.rwflat[clampll((long long)rid * a.L + clampll(i, 0, a.L - 1), 0,
                          a.n_rw - 1)];
}

// Representative j's inputs (valid: it walks).
template <typename T>
WC_HD void rep_write(const View<T>& v, long long j, long long rw, T k, T l,
                     T s, bool valid) {
  v.rep_rw[j] = rw;
  v.rep_k[j] = k;
  v.rep_l[j] = l;
  v.rep_s[j] = s;
  v.rep_valid[j] = valid ? 1 : 0;
}

// Key: lane j's window word and sort key (j < w); for j < Uw also its
// group minimum reset and representative j as the plain step leaves a pad
// past n_w: lane 0's window, k, l and s, not valid (the group kernel
// overwrites the heads j < n_w).  Lane 0's words are read beside lane
// j's, a level at a time.
template <typename T>
WC_HD void key_lane(const View<T>& v, const Args& a, long long j) {
  const bool lane = j < a.w, pad = j < a.Uw;
  int rid = 0, i = -1, rid_z = 0, i_z = -1;
  bool alive = false;
  T k = 0, s = 0, k_z = 0, l_z = 0, s_z = 0;
  if (lane) {
    rid = v.rid[j];
    i = v.i[j];
    alive = v.alive[j] != 0;
    k = v.k[j];
    s = v.s[j];
  }
  if (pad) {
    rid_z = v.rid[0];
    i_z = v.i[0];
    k_z = v.k[0];
    l_z = v.l[0];
    s_z = v.s[0];
  }
  const long long rw = window_of(v, a, rid, i);
  const long long rw_z = window_of(v, a, rid_z, i_z);
  if (lane) {
    v.rw[j] = rw;
    v.key[j] = alive ? (int32_t)(walk_mix(rw, (int64_t)k, (int64_t)s) >> 1)
                     : kI32Max;
  }
  if (pad) {
    v.gmin[j] = max_of<T>();
    rep_write(v, j, rw_z, k_z, l_z, s_z, false);
  }
}

// What the group reads of sorted position p: lane o there and lane q at
// p - 1 (first level), then o's alive, window, k and s and q's window, k
// and s (second level); whether p heads a group (a live lane whose
// (window, k, s) differs from its sorted predecessor's, whether or not
// that one lives; position 0 always does).  Both lanes are read whatever
// o's alive says, so that no load waits on a test.  The lanes lie in key
// order, so each word a thread reads is an L2 sector of its own, and the
// sectors, not the words or the levels, are what a wide round pays for:
// on the card q's words are the words the thread before read for its own
// lane, passed on by a shuffle (only a warp's first thread reads them),
// and o's l and mh are read at the emission, only where they are needed.
template <typename T>
struct GroupIn {
  long long o, q, rw;
  T k, s;
  bool alive, head;
};

template <typename T>
WC_HD void group_order(const View<T>& v, const Args& a, long long p,
                       GroupIn<T>& g) {
  g.o = g.q = 0;
  if (p < a.w) {
    g.o = v.order[p];
    g.q = v.order[p > 0 ? p - 1 : 0];
  }
}

// (every thread of a warp must call it on the card)
template <typename T>
WC_HD void group_read(const View<T>& v, const Args& a, long long p,
                      GroupIn<T>& g) {
  const bool in = p < a.w;
  const long long o = g.o, q = g.q;
#ifdef __CUDA_ARCH__
  const bool first = (threadIdx.x & 31) == 0;
#else
  const bool first = true;
#endif
  long long qrw = 0;
  T qk = 0, qs = 0;
  if (in && first) {
    qrw = v.rw[q];
    qk = v.k[q];
    qs = v.s[q];
  }
  g.alive = false;
  g.rw = 0;
  g.k = g.s = 0;
  if (in) {
    g.alive = v.alive[o] != 0;
    g.rw = v.rw[o];
    g.k = v.k[o];
    g.s = v.s[o];
  }
#ifdef __CUDA_ARCH__
  const long long urw = __shfl_up_sync(0xFFFFFFFFu, g.rw, 1);
  const T uk = __shfl_up_sync(0xFFFFFFFFu, g.k, 1);
  const T us = __shfl_up_sync(0xFFFFFFFFu, g.s, 1);
  if (!first) {
    qrw = urw;
    qk = uk;
    qs = us;
  }
#endif
  g.head = in && g.alive &&
           (p == 0 || g.rw != qrw || g.k != qk || g.s != qs);
}

// Sorted position p (lane o) has group index gi (the inclusive count of
// heads up to p, minus 1); a head below Uw is representative gi (o's l
// read here).  Returns its term of its group slot's minimum: mh for a
// live lane below Uw (read here), INT32_MAX for any other.
template <typename T>
WC_HD T group_emit(const View<T>& v, const Args& a, const GroupIn<T>& g,
                   int gi) {
  const bool member = g.alive && gi < a.Uw;
  T l = 0, mh = (T)kI32Max;
  if (g.head && gi < a.Uw) l = v.l[g.o];
  if (member) mh = v.mh[g.o];
  v.gidx[g.o] = gi;
  if (g.head && gi < a.Uw) rep_write(v, gi, g.rw, g.k, l, g.s, true);
  return mh;
}

// After the scan: n_u heads, n_w = min(n_u, Uw) representatives, ngrp
// moved on (the pads past n_w are the key kernel's).
template <typename T>
WC_HD void group_close(const View<T>& v, const Args& a, int n_u) {
  const int n_w = n_u < a.Uw ? n_u : (int)a.Uw;
  v.sc[kScNw] = n_w;
  v.sc[kScNu] = n_u;
  v.ctr[1] += n_w;
}

// Apply lane j (and representative j): returns whether the lane lives
// after the round; *calls gets representative j's extensions (its walk's
// length when valid).  First level: representative j's length and
// validity, the lane's alive and group index.  A live lane of a walked
// group then reads its state and what its death test needs of its
// group's chain at once (second level: the walk's length, the
// representative's l, the cs row), and only a lane that keeps a chain
// column (one that dies after its first step, or goes through) reads
// that column's k and l words (third level): most deaths come at the
// first step and keep the lane's own state, so their ck and cl sectors
// are never fetched.  It dies (its pool row written) or goes kW chars
// on.
template <typename T, int kW>
WC_HD int apply_lane(const View<T>& v, const Args& a, long long j, int n_w,
                     int* calls) {
  *calls = 0;
  if (j < a.Uw) {
    const int ln = v.ln[j];
    if (v.rep_valid[j]) *calls = ln;
  }
  if (j >= a.w) return 0;
  const bool alive = v.alive[j] != 0;
  const int g = v.gidx[j];
  if (!alive) return 0;
  if (g >= n_w) return 1;                 // not walked: waits a round
  const long long grp = clampll(g, 0, a.Uw - 1);
  const T k = v.k[j], l = v.l[j], s = v.s[j], mh = v.mh[j];
  const int i = v.i[j];
  const long long slot = v.slot[j];
  const int lng = v.ln[grp];
  const T rl = v.rep_l[grp];
  T CS[kW];
  load_row<T, kW>(v.cs + grp * kW, CS);
  uint32_t die = 0;
  WC_UNROLL
  for (int c = 0; c < kW; ++c) {
    const bool real = c < lng;
    const bool amb = c == lng && lng < kW;
    die |= (uint32_t)(amb || (real && CS[c] < mh)) << c;
  }
  // l re-bases by the lane's offset from the representative's l
  const T dl = wsub(l, rl);
  // the chain column the lane keeps: the one before its death (none when
  // it dies at its first step), or the last; its k and l read only then
  const int dj = die ? low_bit(die) : kW;
  const int col = dj - 1;
  T nK = k, nL = l, nS = s;
  if (col >= 0) {
    nK = v.ck[grp * kW + col];
    nL = wadd(v.cl[grp * kW + col], dl);
    WC_UNROLL
    for (int c = 0; c < kW; ++c)
      if (c == col) nS = CS[c];
  }
  if (die) {
    if (slot >= 0 && slot < a.GP) {
      v.death[slot] = i - dj;
      v.fk[slot] = nK;
      v.fl[slot] = nL;
      v.fs[slot] = nS;
    }
    v.alive[j] = 0;
    return 0;
  }
  v.k[j] = nK;
  v.l[j] = nL;
  v.s[j] = nS;
  v.i[j] = i - kW;
  return 1;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// The kernels: a lane (a sorted position) a thread, blocks of
// (ops/walk_cuda.py: KEY_BLOCK, GROUP_BLOCK, APPLY_BLOCK)
constexpr int kKeyBlock = 256;         // the key
constexpr int kGroupBlock = 256;       // the group
constexpr int kApplyBlock = 256;       // the apply
using lookback::scan_blocks;
using lookback::take_ticket;

__device__ __forceinline__ void atomic_min(int32_t* p, int32_t x) {
  atomicMin(p, x);
}

__device__ __forceinline__ void atomic_min(int64_t* p, int64_t x) {
  atomicMin(reinterpret_cast<long long*>(p), (long long)x);
}

// The minimum of x over each run of equal `slot` in the warp (the slots
// do not decrease from lane to lane), one atomicMin a run into
// dst[slot] for slot < n (every lane must call).
template <typename T>
__device__ __forceinline__ void warp_run_min(T* dst, long long slot, T x,
                                             long long n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_down_sync(0xFFFFFFFFu, x, d);
    const long long sy = __shfl_down_sync(0xFFFFFFFFu, slot, d);
    if (lane + d < 32 && sy == slot && y < x) x = y;
  }
  const long long prev = __shfl_up_sync(0xFFFFFFFFu, slot, 1);
  if ((lane == 0 || prev != slot) && slot < n && x < max_of<T>())
    atomic_min(dst + slot, x);
}

// One atomic add each a block of the block's sums of x0 into *d0 and of
// x1 into *d1, skipped when a sum is 0 (sh: 2 x kWarps ints of shared
// memory; every thread must call).
template <int kWarps>
__device__ __forceinline__ void block_add2(int32_t* d0, int x0, int32_t* d1,
                                           int x1, int (*sh)[kWarps]) {
  const int s0 = __reduce_add_sync(0xFFFFFFFFu, x0);
  const int s1 = __reduce_add_sync(0xFFFFFFFFu, x1);
  if ((threadIdx.x & 31) == 0) {
    sh[0][threadIdx.x >> 5] = s0;
    sh[1][threadIdx.x >> 5] = s1;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sh[threadIdx.x][w];
    if (t) atomicAdd(threadIdx.x ? d1 : d0, t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kKeyBlock) walk_key_kernel(const Args a) {
  const View<T> v(a);
  const long long j = (long long)blockIdx.x * kKeyBlock + threadIdx.x;
  if (j == 0) {
    v.sc[kScEpoch] += 1;                        // a new round: its epoch
    v.sc[kScLive] = 0;
  }
  if (j < a.w || j < a.Uw) key_lane(v, a, j);
}

template <typename T>
__global__ void __launch_bounds__(kGroupBlock) walk_group_kernel(
    const Args a) {
  __shared__ int ticket_s, scan_s[34];
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kGroupBlock - 1) / kGroupBlock);
  const unsigned epoch = (unsigned)v.sc[kScEpoch];
  // the first level at the block index, beside the ticket's atomic
  long long p = (long long)blockIdx.x * kGroupBlock + threadIdx.x;
  GroupIn<T> g;
  group_order(v, a, p, g);
  const int t = take_ticket(v.sc + kScTicket, n_blocks, &ticket_s);
  if (t != (int)blockIdx.x) {
    p = (long long)t * kGroupBlock + threadIdx.x;
    group_order(v, a, p, g);
  }
  group_read(v, a, p, g);
  int first, upto;
  const int ex = scan_blocks<kGroupBlock / 32>(g.head, v.lb_group, t, epoch,
                                               scan_s, &first, &upto);
  T term = max_of<T>();
  long long slot = a.Uw;                        // no slot
  if (p < a.w) {
    const int gi = ex + g.head - 1;
    term = group_emit(v, a, g, gi);
    slot = clampll(gi, 0, a.Uw - 1);
  }
  warp_run_min(v.gmin, slot, term, a.Uw);
  if (t == n_blocks - 1 && threadIdx.x == 0) group_close(v, a, upto);
}

// kW: the window width W.
template <typename T, int kW>
__global__ void __launch_bounds__(kApplyBlock) walk_apply_kernel(
    const Args a) {
  __shared__ int sums[2][kApplyBlock / 32];
  const View<T> v(a);
  const long long j = (long long)blockIdx.x * kApplyBlock + threadIdx.x;
  const int n_w = v.sc[kScNw];
  const LoopPre pre = loop_pre<kScLive>(a);
  int calls;
  const int live = apply_lane<T, kW>(v, a, j, n_w, &calls);
  // in a loop the live lanes go to the last block to retire instead
  block_add2<kApplyBlock / 32>(v.ctr + 0, calls, v.sc + kScLive,
                               a.loop ? 0 : live, sums);
  const long long wide = a.w > a.Uw ? a.w : a.Uw;
  loop_retire<kScLive, kScRetire, kApplyBlock / 32>(
      a, live, (int)((wide + kApplyBlock - 1) / kApplyBlock), pre);
}

// The width's entry (compact.cuh): the previous width's lanes compacted
// into this one's (or, before a call's first width, its live lanes
// counted), the live count and the width's first test, the WHILE node's
// condition set from it inside a graph.
template <typename T>
__global__ void __launch_bounds__(kEntryBlock) walk_segment_entry_kernel(
    const Args a) {
  segment_entry<kScLive, kScTicket, kScEpoch>(a, walk_lanes<T>(a));
}

long long blocks_for(long long n, int block) {
  return (n + block - 1) / block;
}

// The apply kernel for the window width a.W (kW and up).
template <typename T, int kW = 1>
void launch_apply(const Args& a, cudaStream_t st) {
  if constexpr (kW < kMaxW) {
    if (a.W != kW) return launch_apply<T, kW + 1>(a, st);
  }
  const long long wide = a.w > a.Uw ? a.w : a.Uw;
  walk_apply_kernel<T, kW>
      <<<blocks_for(wide, kApplyBlock), kApplyBlock, 0, st>>>(a);
}

// The entry: a block a tile of the source's lanes (or, with none, of the
// width's).
template <typename T>
void launch_entry(const Args& a, cudaStream_t st) {
  const long long n = a.src_w > 0 ? a.src_w : a.w;
  walk_segment_entry_kernel<T>
      <<<blocks_for(n, kEntryBlock * kEntryItems), kEntryBlock, 0, st>>>(a);
}

template <typename T>
int launch(int which, const Args& a, cudaStream_t st) {
  const long long wide = a.w > a.Uw ? a.w : a.Uw;
  switch (which) {
    case 0:
      walk_key_kernel<T>
          <<<blocks_for(wide, kKeyBlock), kKeyBlock, 0, st>>>(a);
      break;
    case 1:
      walk_group_kernel<T>
          <<<blocks_for(a.w, kGroupBlock), kGroupBlock, 0, st>>>(a);
      break;
    case 2:
      launch_apply<T>(a, st);
      break;
    case 3: {
      const int e = key_sort((const int32_t*)a.key, (int32_t*)a.sorted_key,
                             (const int64_t*)a.iota, (int64_t*)a.order, a.w,
                             (int)a.key_bits, (void*)a.sort_tmp,
                             a.sort_bytes, st);
      if (e) return e;
      break;
    }
    default:
      launch_entry<T>(a, st);
  }
  return (int)cudaGetLastError();
}

int launch_any(int which, const long long* words, void* stream) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.w >= INT32_MAX ||
      a.Uw >= INT32_MAX || a.n_rw < 1)
    return (int)cudaErrorInvalidValue;
  // the apply reads the chain's s rows as vectors of up to 16 bytes
  if (which == 2 && (a.cs & 15)) return (int)cudaErrorMisalignedAddress;
  if (which == 3 && (a.key_bits < 1 || a.key_bits > 32 || !a.sort_tmp))
    return (int)cudaErrorInvalidValue;
  // the entry covers the source's lanes, the new width's among them
  if (which == 4 && (a.src_w < 0 || a.src_w >= INT32_MAX ||
                     (a.src_w > 0 && a.src_w < a.w) || !a.lb_entry))
    return (int)cudaErrorInvalidValue;
  return a.idx64 ? launch<int64_t>(which, a, (cudaStream_t)stream)
                 : launch<int32_t>(which, a, (cudaStream_t)stream);
}
#else
// ---------------------------------------------------------------------------
// The host loops: the same lane routines, lane after lane, the scan as a
// running sum and the group minima as a running min.
template <typename T>
void host_key(const Args& a) {
  const View<T> v(a);
  v.sc[kScEpoch] += 1;
  v.sc[kScLive] = 0;
  const long long wide = a.w > a.Uw ? a.w : a.Uw;
  for (long long j = 0; j < wide; ++j) key_lane(v, a, j);
}

template <typename T>
void host_group(const Args& a) {
  const View<T> v(a);
  int n = 0;
  for (long long p = 0; p < a.w; ++p) {
    GroupIn<T> g;
    group_order(v, a, p, g);
    group_read(v, a, p, g);
    n += g.head;
    const T term = group_emit(v, a, g, n - 1);
    T* m = v.gmin + clampll(n - 1, 0, a.Uw - 1);
    if (term < *m) *m = term;
  }
  group_close(v, a, n);
}

// The apply for the window width a.W (kW and up).
template <typename T, int kW = 1>
void host_apply(const Args& a) {
  if constexpr (kW < kMaxW) {
    if (a.W != kW) return host_apply<T, kW + 1>(a);
  }
  const View<T> v(a);
  const int n_w = v.sc[kScNw];
  const long long wide = a.w > a.Uw ? a.w : a.Uw;
  int calls = 0, live = 0;
  for (long long j = 0; j < wide; ++j) {
    int c;
    live += apply_lane<T, kW>(v, a, j, n_w, &c);
    calls += c;
  }
  v.ctr[0] += calls;
  v.sc[kScLive] += live;
  if (a.loop) loop_step<kScLive>(a);             // the folded loop test
}

int host_any(int which, const long long* words) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.w >= INT32_MAX ||
      a.Uw >= INT32_MAX || a.n_rw < 1)
    return -1;
  if (which == 3 && (a.key_bits < 1 || a.key_bits > 32)) return -1;
  if (which == 4 && (a.src_w < 0 || (a.src_w > 0 && a.src_w < a.w)))
    return -1;
  const bool i64 = a.idx64 != 0;
  switch (which) {
    case 0:
      i64 ? host_key<int64_t>(a) : host_key<int32_t>(a);
      break;
    case 1:
      i64 ? host_group<int64_t>(a) : host_group<int32_t>(a);
      break;
    case 2:
      i64 ? host_apply<int64_t>(a) : host_apply<int32_t>(a);
      break;
    case 3:
      key_sort_host((const int32_t*)a.key, (int32_t*)a.sorted_key,
                    (int64_t*)a.order, a.w, (int)a.key_bits);
      break;
    default:
      if (i64)
        segment_entry_host<kScLive, kScEpoch>(a, walk_lanes<int64_t>(a));
      else
        segment_entry_host<kScLive, kScEpoch>(a, walk_lanes<int32_t>(a));
  }
  return 0;
}
#endif

}  // namespace

// Every entry takes the Args words (ops/walk_cuda.py::ARGS, in order).
#ifdef __CUDACC__
extern "C" int walk_key_launch(const long long* a, void* stream) {
  return launch_any(0, a, stream);
}
extern "C" int walk_group_launch(const long long* a, void* stream) {
  return launch_any(1, a, stream);
}
extern "C" int walk_apply_launch(const long long* a, void* stream) {
  return launch_any(2, a, stream);
}
extern "C" int walk_sort_launch(const long long* a, void* stream) {
  return launch_any(3, a, stream);
}
extern "C" int walk_segment_entry_launch(const long long* a,
                                         void* stream) {
  return launch_any(4, a, stream);
}

// The sort's temporary storage for n keys of `bits` bits.
extern "C" long long walk_sort_bytes(long long n, int bits) {
  return key_sort_bytes(n, bits);
}

LOOP_GRAPH_ENTRIES(walk)

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* walk_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same rounds on the host; each returns 0, or -1 for arguments the
// launchers refuse.
extern "C" int walk_key_host(const long long* a) { return host_any(0, a); }
extern "C" int walk_group_host(const long long* a) { return host_any(1, a); }
extern "C" int walk_apply_host(const long long* a) { return host_any(2, a); }
extern "C" int walk_sort_host(const long long* a) { return host_any(3, a); }
extern "C" int walk_segment_entry_host(const long long* a) {
  return host_any(4, a);
}

// walk_mix for n keys (window words, k and s sign-extended to int64).
extern "C" void walk_mix_host(const long long* rw, const long long* k,
                              const long long* s, long long n,
                              long long* out) {
  for (long long j = 0; j < n; ++j) out[j] = walk_mix(rw[j], k[j], s[j]);
}
#endif

// The size of Args in words, to check the Python layout against.
extern "C" int walk_args_words() { return (int)(sizeof(Args) / 8); }
