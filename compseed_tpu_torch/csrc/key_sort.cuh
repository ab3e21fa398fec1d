// A round's stable sort of its lanes by key, shared by the round sources
// chain_scan.cu and walk_chain.cu: the lanes' int32 keys (all >= 0) into
// sorted keys and the order (int64 lane indices), equal to
// torch.sort(key, stable=True), by the key's low `bits` bits only, the
// bits its keys can have (chain_scan: slot or H, bit_length(H); the walk:
// the mix shifted right by one or INT32_MAX, 31).
//
// On the card it is CUB's DeviceRadixSort::SortPairs (an LSD radix sort,
// stable) over those bits, with its temporary storage sized once by
// key_sort_bytes and held by the round: the sort allocates nothing, so a
// round's launches can be captured into a graph and replayed.  This
// replaces torch.sort (XLA's sort in the JAX package), a library call by a
// library call: no TPU kernel is ported here.  Compiled as C++ without
// nvcc, key_sort_host is std::stable_sort on the same low bits, so that
// the CPU tests see what a key past `bits` would do to the order.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cub/device/device_radix_sort.cuh>

// The temporary storage SortPairs needs for n keys of `bits` bits.
inline long long key_sort_bytes(long long n, int bits) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(
      nullptr, bytes, (const uint32_t*)nullptr, (uint32_t*)nullptr,
      (const int64_t*)nullptr, (int64_t*)nullptr, (int)n, 0, bits);
  return (long long)bytes;
}

// keys (n) with the lane indices iota (n, 0..n-1) into sorted keys and
// order; tmp holds `bytes` bytes of temporary storage.
inline int key_sort(const int32_t* keys, int32_t* sorted, const int64_t* iota,
                    int64_t* order, long long n, int bits, void* tmp,
                    long long bytes, cudaStream_t stream) {
  size_t have = (size_t)bytes;
  return (int)cub::DeviceRadixSort::SortPairs(
      tmp, have, (const uint32_t*)keys, (uint32_t*)sorted, iota, order,
      (int)n, 0, bits, stream);
}
#else
#include <algorithm>

inline void key_sort_host(const int32_t* keys, int32_t* sorted,
                          int64_t* order, long long n, int bits) {
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  for (long long i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order, order + n, [&](int64_t x, int64_t y) {
    return ((uint32_t)keys[x] & mask) < ((uint32_t)keys[y] & mask);
  });
  for (long long i = 0; i < n; ++i) sorted[i] = keys[order[i]];
}
#endif
