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
// Device code only; the host loops of both sources scan with running sums.

#pragma once

#ifdef __CUDACC__
#include <cstdint>

namespace lookback {

constexpr unsigned long long kAggregate = 1, kInclusive = 2;

// Exclusive scan of x over a block of kWarps warps; *total gets the
// block's sum.  (tot: kWarps + 1 ints of shared memory; every thread
// must call.)
template <int kWarps>
__device__ __forceinline__ int block_excl_scan(int x, int* tot, int* total) {
  static_assert(kWarps >= 1 && kWarps <= 32, "a block of 1 to 32 warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? tot[lane] : 0;
    int s = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) tot[lane] = s - t;
    if (lane == 31) tot[kWarps] = s;
  }
  __syncthreads();
  const int ex = tot[warp] + inc - x;
  *total = tot[kWarps];
  __syncthreads();
  return ex;
}

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

// The sum of the values of the blocks with tickets before `ticket` (every
// thread gets it), after publishing this block's `value` and then its
// inclusive prefix in status[ticket].
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         int ticket, int value,
                                         unsigned epoch, int* shared) {
  if (threadIdx.x == 0) {
    int prefix = 0;
    if (ticket > 0) {
      atomicExch(status + ticket, lb_word(epoch, kAggregate, value));
      for (int j = ticket - 1;;) {
        const unsigned long long s =
            *reinterpret_cast<volatile unsigned long long*>(status + j);
        const unsigned long long flag = (s >> 32) & 3u;
        if ((unsigned)(s >> 34) != (epoch & 0x3FFFFFFFu) || flag == 0)
          continue;                     // not published yet this round
        prefix += (int)(unsigned)s;
        if (flag == kInclusive) break;
        --j;
      }
    }
    atomicExch(status + ticket, lb_word(epoch, kInclusive, prefix + value));
    *shared = prefix;
  }
  __syncthreads();
  return *shared;
}

// One atomic add a warp of the warp's sum of x (every lane must call).
__device__ __forceinline__ void warp_add(int32_t* dst, int x) {
  const int s = __reduce_add_sync(0xFFFFFFFFu, x);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(dst, s);
}

}  // namespace lookback

#endif  // __CUDACC__
