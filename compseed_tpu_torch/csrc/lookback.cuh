// Scans across the blocks of one launch, shared by the round kernels of
// chain_scan.cu (chain_scan) and walk_chain.cu (walk_pool_chain).
//
// A decoupled look-back (Merrill and Garland's single-pass scan): blocks
// take tickets in the order they start, so a block only ever waits on
// blocks that are already running; each publishes its sum, then adds the
// sums of the blocks before it until one that has published its
// inclusive prefix.  A status word holds the round's epoch (30 bits), a
// flag and the value, so an array of status words needs no reset between
// rounds: a word of an earlier round carries another epoch and reads as
// not yet published.  Each scan of a round has a status array of its
// own, and its epoch counts the rounds of that array's life, so an epoch
// never repeats within it (2^30 rounds).
//
// The look-back is warp-wide (look_back_warp, in the manner of CUB's
// decoupled look-back): 32 predecessors' words in one step, a ballot for
// the nearest inclusive prefix, a warp sum of the words after it, so a
// launch of 256 blocks waits at most 8 steps where a one-thread walk,
// one status word a round trip, may take 255.  scan_blocks scans the block
// and looks back with it.
//
// Device code only; the host loops of both sources scan with running sums.

#pragma once

#ifdef __CUDACC__
#include <cstdint>

namespace lookback {

constexpr unsigned long long kAggregate = 1, kInclusive = 2;

// The block's ticket: blocks number themselves in the order they start.
// The last one resets the counter for the next launch.
__device__ __forceinline__ int take_ticket(int32_t* counter, int n_blocks,
                                           int* shared) {
  if (threadIdx.x == 0) {
    *shared = atomicAdd(counter, 1);
    if (*shared == n_blocks - 1) *counter = 0;
  }
  __syncthreads();
  return *shared;
}

__device__ __forceinline__ unsigned long long lb_word(
    unsigned epoch, unsigned long long flag, int value) {
  return ((unsigned long long)(epoch & 0x3FFFFFFFu) << 34) | (flag << 32) |
         (unsigned)value;
}

// The warp-wide look-back (every lane of one warp calls it): publish this
// block's `value` in status[ticket], read the words of the 32 blocks
// before the window's end at once until every word up to the nearest
// inclusive prefix is published, add those, and move the window back by
// 32 while none is inclusive; then publish this block's inclusive prefix.
// Returns the sum of the values of the blocks with tickets before
// `ticket` (every lane gets it).  kAcquire: a fence after the reads,
// before the inclusive prefix is published, for a block whose stores
// after the scan must follow what the blocks before it wrote before
// theirs (an acquire of the words read, and a release, cumulative, of
// this block's prefix for the blocks after it); the barrier that ends
// scan_blocks then orders the whole block's stores after it.
template <bool kAcquire = false>
__device__ __forceinline__ int look_back_warp(unsigned long long* status,
                                              int ticket, int value,
                                              unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long tag = epoch & 0x3FFFFFFFu;
  int prefix = 0;
  if (ticket > 0) {
    if (lane == 0)
      atomicExch(status + ticket, lb_word(epoch, kAggregate, value));
    for (int end = ticket - 1;; end -= 32) {
      const int j = end - lane;                 // lane 0: the nearest block
      unsigned got, flag;
      unsigned need, incl;
      for (;;) {
        got = 0;
        flag = (unsigned)kInclusive;            // before block 0: nothing
        if (j >= 0) {
          const unsigned long long s =
              *reinterpret_cast<volatile unsigned long long*>(status + j);
          flag = (s >> 34) == tag ? (unsigned)(s >> 32) & 3u : 0u;
          got = (unsigned)s;
        }
        incl = __ballot_sync(0xFFFFFFFFu, flag == kInclusive);
        // the lanes up to the nearest inclusive prefix (all 32 if none)
        need = incl ? (2u << (__ffs(incl) - 1)) - 1u : 0xFFFFFFFFu;
        if (!(__ballot_sync(0xFFFFFFFFu, flag == 0) & need)) break;
      }
      prefix += __reduce_add_sync(0xFFFFFFFFu,
                                  (need >> lane) & 1u ? (int)got : 0);
      if (incl) break;
    }
  }
  if (kAcquire) __threadfence();
  if (lane == 0)
    atomicExch(status + ticket, lb_word(epoch, kInclusive, prefix + value));
  return prefix;
}

// Exclusive scan of x across the blocks of a launch in one pass, the
// lanes of the blocks with earlier tickets first: returns the sum of x
// over the lanes before this thread; *first gets the sum before this
// block, *upto the sum up to its end (the launch's total in the block
// with the last ticket).  (sh: 34 ints of shared memory; every thread
// must call; one call a launch.)  kAcquire: look_back_warp's.
template <int kWarps, bool kAcquire = false>
__device__ __forceinline__ int scan_blocks(int x, unsigned long long* status,
                                           int ticket, unsigned epoch,
                                           int* sh, int* first, int* upto) {
  static_assert(kWarps >= 1 && kWarps <= 32, "a block of 1 to 32 warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? sh[lane] : 0;
    int s = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, s, 31);
    const int prefix =
        look_back_warp<kAcquire>(status, ticket, total, epoch);
    if (lane < kWarps) sh[lane] = prefix + s - t;
    if (lane == 0) {
      sh[32] = prefix;
      sh[33] = prefix + total;
    }
  }
  __syncthreads();
  *first = sh[32];
  *upto = sh[33];
  return sh[warp] + inc - x;
}

// One atomic add a warp of the warp's sum of x (every lane must call).
__device__ __forceinline__ void warp_add(int32_t* dst, int x) {
  const int s = __reduce_add_sync(0xFFFFFFFFu, x);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(dst, s);
}

}  // namespace lookback

#endif  // __CUDACC__
