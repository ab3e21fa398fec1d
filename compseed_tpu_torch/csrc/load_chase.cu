// The card's latency of one dependent 16-byte load, measured by
// chip_smoke.py (on no path of the port): the floor a chain of dependent
// occ-row reads, such as a round-3 lane's extensions (smem_seed.cu) or a
// walk's steps (lockstep.cu), cannot go below on this card.
//
// load_chase_kernel: one thread follows `steps` loads through a table of
// entries `stride16` 16-byte words apart, each load's first word the
// index of the next entry (the caller links the entries into one cycle in
// random order, so that no load's address is known before the one before
// it returns), from the entry *at on, and leaves the last index in *at:
// no load is dead, and the next launch goes on along the cycle (on a
// table larger than L2, to entries it has not read).
// The loads are __ldg's 16-byte reads, as fm_rank.cuh's load_quarter reads
// a row.  Its time over two step counts, less each other, over their
// difference is one load's latency from wherever the table lies: L2 for a
// table the size of cell A's occ table, device memory for one of a
// 2^30-base genome's.

#include <cstdint>

#include <cuda_runtime.h>

__global__ void load_chase_kernel(const uint4* __restrict__ table,
                                  int stride16, long long steps,
                                  unsigned* at) {
  unsigned i = *at;
  for (long long s = 0; s < steps; ++s)
    i = __ldg(table + (size_t)i * stride16).x;
  *at = i;
}

// Returns the CUDA error code of the launch (one block of one thread).
extern "C" int load_chase_launch(const void* table, int stride16,
                                 long long steps, void* at, void* stream) {
  load_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, stride16, steps, (unsigned*)at);
  return (int)cudaGetLastError();
}
