// The entry of a round loop's segment, shared by chain_scan.cu
// (chain_scan) and walk_chain.cu (walk_pool_chain): one kernel that
// starts every segment's graph (loop_graph.cuh).  Its pass over the
// lanes (rank_tile, store_ranked: the ranks by look-back, the live lanes
// to them) also serves fm_walk.cu's sa_stage_entry_kernel, the
// compaction between the stages of the suffix-array walk, and the whole
// entry lockstep.cu's walk_stage_entry_kernel, between the stages of the
// lockstep walk (walk_pool).
//
// In the JAX package the lanes go from one segment to the next, narrower
// one by a stable rank-scatter compaction (compseed_tpu/ops/seedscan.py
// :1727-1737, chain_scan; :739-748, walk_pool_chain: jnp.cumsum of alive,
// then .at[tgt].set(..., mode="drop") for each lane array), and the next
// while_loop tests its cond, rnd < RCAP && sum(alive) > nxtw, before its
// first round; XLA fuses the compaction into one program on the TPU.
// Here one launch does both, where the port first ran some 21 PyTorch
// operations (eight index_put_, seven zero_, a cumsum, ...) and a
// one-thread entry kernel at every boundary:
//
//   - it ranks the previous segment's lanes: each live lane's rank among
//     the live lanes, by a decoupled look-back scan across the blocks
//     (lookback.cuh::scan_blocks);
//   - it moves every live lane whose rank r is below the new width w to
//     lane r of the segment's own lane arrays, and drops the rest, as
//     mode="drop" does (the dump row of the plain version is never
//     written);
//   - it writes the pads: lanes [min(live, w), w) become lane 0 of the
//     call, dead (zeros; chain_scan's lane_rid the pad its source gives).
//     The previous segment leaves its live count in device memory
//     (live_in), so the pads are known before any rank is;
//   - the block with the last ticket, whose scan's inclusive total counts
//     every live lane of the source (the look-back waited on every other
//     block's published sum, so no count can still be on its way), sets
//     the segment's live word to the lanes kept, min(live, w) =
//     jnp.sum(alive) after the compaction, and runs the loop's test
//     (loop_go: the histogram word, go) and sets the WHILE node's
//     condition.
// Before a call's first segment no compaction comes: the same kernel
// with no source (src_w 0) counts the segment's own live lanes instead
// (the call's set-up no longer sums them) and runs the same test.
//
// What bounds it on Hopper.  The bytes are few: the source's alive bytes,
// the kept lanes' words (read once, written once) and the pads' words; at
// the widest boundary (walk_pool_chain's 393,216 lanes to 98,304) some
// 3-4 MB, about a microsecond at 3.35 TB/s.  What decides is the launch
// and one pass's dependent steps: the ticket, a lane's alive byte, its
// words, the scan across blocks, the stores.  So a block loads its lanes'
// alive bytes by its index beside its ticket's atomic (the ticket almost
// always equals the index; else they are loaded again), and then the words
// of its live lanes only; a thread takes kEntryItems consecutive lanes, a
// block of kEntryBlock threads 512, so that even the chain's 4,096-lane
// boundary spreads over 8 SMs (PERF.md, the segment entry rows: one block
// walking a narrow source's tiles with a running carry, and every word
// loaded at once beside the ticket, were slower).
//
// A count needs no order: count_entry, lockstep.cu's walk stage entry
// before a call's first stage, counts kCountItems lanes a thread (their
// alive bytes in one load) and adds each block's count in one atomic, no
// ticket and no look-back.
//
// The host loop (segment_entry_host) does the same lane after lane, for
// the CPU tests.

#pragma once

#include <cstdint>

#include "loop_graph.cuh"

#ifdef __CUDACC__
#include "lookback.cuh"
#define CP_UNROLL _Pragma("unroll")
#else
#define CP_UNROLL
#endif

constexpr int kEntryItems = 2;         // consecutive lanes a thread
constexpr int kEntryBlock = 256;       // threads a block
constexpr int kCountItems = 8;         // lanes a thread of count_entry

// A loop's lane arrays as the entry moves them: kI32 int32 arrays, kT
// arrays of the index type T and the alive bytes, of the previous
// segment (src) and of this one (dst); pad32: the value a pad lane takes
// in each int32 array (the T arrays' pads are 0).
template <typename T, int kI32, int kT>
struct LaneSet {
  const int32_t* src32[kI32];
  const T* srcT[kT];
  const bool* src_alive;
  int32_t* dst32[kI32];
  T* dstT[kT];
  bool* dst_alive;
  int32_t pad32[kI32];

  struct Lane {
    int32_t i32[kI32];
    T t[kT];
  };

  LG_HD void load(long long i, Lane& x) const {
    CP_UNROLL
    for (int k = 0; k < kI32; ++k) x.i32[k] = src32[k][i];
    CP_UNROLL
    for (int k = 0; k < kT; ++k) x.t[k] = srcT[k][i];
  }

  LG_HD void store(long long r, const Lane& x) const {
    CP_UNROLL
    for (int k = 0; k < kI32; ++k) dst32[k][r] = x.i32[k];
    CP_UNROLL
    for (int k = 0; k < kT; ++k) dstT[k][r] = x.t[k];
    dst_alive[r] = true;
  }

  LG_HD void pad(long long r) const {
    CP_UNROLL
    for (int k = 0; k < kI32; ++k) dst32[k][r] = pad32[k];
    CP_UNROLL
    for (int k = 0; k < kT; ++k) dstT[k][r] = T(0);
    dst_alive[r] = false;
  }
};

// The first pad lane: min(live_in, w), the lanes the compaction keeps
// by the count the previous segment left (`a.live_in`).
template <typename A>
LG_HD long long entry_pad0(const A& a) {
  const long long live = *(const int32_t*)a.live_in;
  return live < 0 ? 0 : (live < a.w ? live : a.w);
}

// The segment's lane count and test once the live lanes are counted
// (`count`: the source's with one, the segment's own without): the live
// word sc[kLive] = the lanes kept, then loop_go.  Returns go.
template <int kLive, typename A>
LG_HD bool entry_close(const A& a, long long count) {
  const int32_t kept = (int32_t)(count < a.w ? count : a.w);
  ((int32_t*)a.sc)[kLive] = kept;
  return loop_go(a, *(const int32_t*)a.rnd, kept);
}

// The host loop: the ranks as a running count, the pads, the test.
// (sc[kEpoch], the look-back's epoch, counted as the kernel counts it.)
template <int kLive, int kEpoch, typename A, typename L>
inline bool segment_entry_host(const A& a, const L& ln) {
  long long count = 0;
  if (a.src_w > 0) {
    for (long long i = 0; i < a.src_w; ++i) {
      if (!ln.src_alive[i]) continue;
      if (count < a.w) {
        typename L::Lane x;
        ln.load(i, x);
        ln.store(count, x);
      }
      ++count;
    }
    for (long long r = entry_pad0(a); r < a.w; ++r) ln.pad(r);
  } else {
    for (long long i = 0; i < a.w; ++i) count += ln.dst_alive[i];
  }
  ((int32_t*)a.sc)[kEpoch] += 1;
  return entry_close<kLive>(a, count);
}

#ifdef __CUDACC__

// The first of a thread's kEntryItems consecutive lanes in tile t.
__device__ __forceinline__ long long tile_lane0(int t) {
  return ((long long)t * kEntryBlock + threadIdx.x) * kEntryItems;
}

// The alive bytes of a thread's lanes in tile t of n lanes.
__device__ __forceinline__ void tile_alive(const bool* alive, long long n,
                                           int t, bool* live) {
  const long long i0 = tile_lane0(t);
  CP_UNROLL
  for (int j = 0; j < kEntryItems; ++j) {
    const long long i = i0 + j;
    live[j] = i < n && alive[i];
  }
}

// A block's part of a compaction: its ticket t, which names its tile of
// kEntryBlock * kEntryItems source lanes (this thread's from i0), the
// rank of the thread's first live lane among the source's live lanes,
// and the scan's totals before the tile (first) and up to its end (upto:
// in the block with the last ticket, every live lane of the source; the
// look-back waited on every other block's published sum, so no count can
// still be on its way).
struct TileRank {
  int t;
  long long i0;
  int rank, first, upto;
};

// The pass every compaction here makes over n source lanes: the tile's
// alive bytes (`live`), loaded by the block's index beside its ticket's
// atomic and again when the ticket differs from the index; then
// load(i0), the words of the lanes the caller moves, issued before the
// scan; then the scan of the live lanes across the blocks by look-back
// (lookback::scan_blocks).  `ticket`: the ticket counter (0 between
// launches); `lb`: the look-back's status words, tagged `epoch`.
// kAcquire: the look-back fences after its reads (lookback.cuh), for a
// caller whose stores after the scan must follow what blocks with earlier
// tickets wrote before they published their counts.  Every thread of
// every block must call.
template <bool kAcquire = false, typename Load>
__device__ __forceinline__ TileRank rank_tile(const bool* alive, long long n,
                                              int32_t* ticket,
                                              unsigned long long* lb,
                                              unsigned epoch, bool* live,
                                              Load load) {
  __shared__ int ticket_s;
  __shared__ int scan_s[34];
  TileRank r;
  tile_alive(alive, n, blockIdx.x, live);
  r.t = lookback::take_ticket(ticket, gridDim.x, &ticket_s);
  if (r.t != (int)blockIdx.x) tile_alive(alive, n, r.t, live);
  r.i0 = tile_lane0(r.t);
  load(r.i0);
  int cnt = 0;
  CP_UNROLL
  for (int j = 0; j < kEntryItems; ++j) cnt += live[j];
  r.rank = lookback::scan_blocks<kEntryBlock / 32, kAcquire>(
      cnt, lb, r.t, epoch, scan_s, &r.first, &r.upto);
  return r;
}

// A thread's live lanes (x, loaded) to their ranks from `rank` on; a
// rank of w or more is dropped, as mode="drop" drops it.
template <typename L>
__device__ __forceinline__ void store_ranked(const L& ln, long long rank,
                                             const bool* live,
                                             const typename L::Lane* x,
                                             long long w) {
  CP_UNROLL
  for (int j = 0; j < kEntryItems; ++j) {
    if (!live[j]) continue;
    if (rank < w) ln.store(rank, x[j]);
    ++rank;
  }
}

// The segment entry's body: blocks of kEntryBlock threads, a tile of
// kEntryBlock * kEntryItems lanes each (rank_tile).  sc[kTicket] is the
// ticket counter and sc[kEpoch] the look-back's epoch (lb_entry's words
// carry it), which the block with the last ticket counts; that block also
// closes the segment (entry_close, the WHILE node's condition).  The
// round's own words serve: its first kernel counts the same epoch on, so
// the status words of the round's scans may be lb_entry's too.  Every
// thread of every block must call.
template <int kLive, int kTicket, int kEpoch, typename A, typename L>
__device__ __forceinline__ void segment_entry(const A& a, const L& ln) {
  int32_t* sc = (int32_t*)a.sc;
  const bool move = a.src_w > 0;
  const unsigned epoch = (unsigned)sc[kEpoch] + 1u;
  const long long pad0 = move ? entry_pad0(a) : a.w;
  bool live[kEntryItems];
  typename L::Lane x[kEntryItems];
  const TileRank r = rank_tile(
      move ? ln.src_alive : ln.dst_alive, move ? a.src_w : a.w,
      sc + kTicket, (unsigned long long*)a.lb_entry, epoch, live,
      [&](long long i0) {
        CP_UNROLL
        for (int j = 0; j < kEntryItems; ++j)
          if (move && live[j]) ln.load(i0 + j, x[j]);
      });
  if (move) {
    store_ranked(ln, r.rank, live, x, a.w);
    CP_UNROLL
    for (int j = 0; j < kEntryItems; ++j) {
      const long long i = r.i0 + j;
      if (i >= pad0 && i < a.w) ln.pad(i);
    }
  }
  if (r.t == (int)gridDim.x - 1 && threadIdx.x == 0) {
    sc[kEpoch] = (int32_t)epoch;
    loop_cond(a, entry_close<kLive>(a, r.upto));
  }
}

// The count-only entry (no source, src_w 0: a call's first segment), which
// needs no order: each block counts the live lanes of its tile of
// kEntryBlock * kCountItems, a thread's alive bytes in one 8-byte load
// where they all lie below w and are aligned so, and adds them in
// retire_last's one atomic on the 64-bit word sc[kRetire] (0 between
// launches); the last block to retire counts the epoch as segment_entry's
// last ticket does (the next compacting entry tags its status words with
// the one after it) and closes the segment.  Every thread of every block
// must call.
template <int kLive, int kEpoch, int kRetire, typename A, typename L>
__device__ __forceinline__ void count_entry(const A& a, const L& ln) {
  int32_t* sc = (int32_t*)a.sc;
  const long long i0 =
      ((long long)blockIdx.x * kEntryBlock + threadIdx.x) * kCountItems;
  const bool* alive = ln.dst_alive + i0;
  int cnt = 0;
  if (i0 + kCountItems <= a.w && ((uintptr_t)alive & 7u) == 0) {
    const unsigned long long v =
        *reinterpret_cast<const unsigned long long*>(alive);
    CP_UNROLL
    for (int j = 0; j < kCountItems; ++j) cnt += ((v >> (8 * j)) & 0xFF) != 0;
  } else {
    CP_UNROLL
    for (int j = 0; j < kCountItems; ++j) cnt += i0 + j < a.w && alive[j];
  }
  int total;
  if (retire_last<kEntryBlock / 32>(
          (unsigned long long*)(sc + kRetire), cnt, gridDim.x, &total)) {
    sc[kEpoch] += 1;
    loop_cond(a, entry_close<kLive>(a, total));
  }
}

#endif  // __CUDACC__
