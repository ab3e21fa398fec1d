// Banded Smith-Waterman extension (ksw_extend2, bwalib/ksw.c:380-479) for
// a batch of query/target pairs, one thread per pair.
//
// bsw_extend_kernel<S, ROWS_SHARED>
//   Replaces the Pallas TPU kernel compseed_tpu/ops/bsw_pallas.py::_kernel
//   (launched by _call_kernel through bsw_extend_tiles / bsw_meta_tiles).
//   Same inputs, same (P, 8) int32 output: score, qle, tle, gtle, gscore,
//   max_off, 0, 0.  It computes exactly what the plain PyTorch version
//   compseed_tpu_torch/ops/bsw.py::_extend_core computes, corner cases
//   included (an emptied band breaks after the query-end update; gscore is
//   tested at end == qlen).  S is the STORAGE type of the H/E rows: with
//   int16_t it replaces the TPU kernel's state16 variant (rows widen to int
//   on load and narrow on store, every comparison, the band shrink too,
//   reads the widened value, all arithmetic stays 32-bit), so nothing
//   changes while every stored value fits 16 bits, which the runner's gate
//   (BswRunner._use16) proves per query-length class.
//
//   What bounds it on Hopper: the DP is a sequential row recurrence with
//   data-dependent exits (z-drop, band emptied, band shrink).  It moves few
//   bytes and does about 15 integer operations a band cell, but each cell
//   waits for the cell before it, so the time of a launch is the LATENCY of
//   one cell's loads and stores times the cells of the longest pairs, not
//   the card's arithmetic or memory rate.  The TPU kernel swept all Q
//   columns of an (LT, Q) lane tile on every row; here a thread walks only
//   its own band [beg, end) and stops at its own break.
//   What the design does about the latency: a pair's H and E rows (Q + 1
//   columns each; they persist over all target rows, because the band
//   shrink re-reads columns written many rows earlier) live in dynamic
//   SHARED memory, laid out [column][thread] at stride blockDim.x.  The
//   bank of a 4-byte word is then threadIdx.x % 32 whatever the column, so
//   a warp's accesses are conflict-free even when its threads' bands have
//   drifted apart (int16 rows: two lanes share a word, at most 2-way).  A
//   cell costs two shared-memory round trips instead of two trips to L2.
//   The query of a pair is staged once as 3-bit codes, eight to a word, in
//   the same [word][thread] layout, so a cell reads no byte from device
//   memory; the target code is read once a row.  Threads per block are a
//   function of (Q, S) alone (ops/bsw_cuda.py::block_threads): as many
//   pairs per SM as 227 KB hold.  Pairs are sorted by target length by the
//   runner, so the threads of a warp stop together.
//   ROWS_SHARED = false is the variant for query-length classes whose rows
//   do not fit even for 32 pairs (Q >= 1024 with int32 rows): the rows are
//   a device-memory scratch laid out [column][pair], and the query is read
//   from its tile.  The wrapper picks it by shape alone and counts it as
//   bsw_extend_kernel_gmem.
//
// bsw_meta_dual_kernel<S>
//   Replaces the whole device program compseed_tpu/ops/bsw.py::
//   _meta_dual_core: the tile decode of bsw_pallas.py::build_tiles, both
//   band rounds of _kernel and the retry acceptance between them.  One
//   thread per pair reads its 12-word meta row, stages its query codes from
//   the chunk's read matrix (forward or reversed) into shared memory,
//   decodes its target codes from the 2-bit packed reference as the rows go
//   (one 16-base word stays in a register; the fold at l_pac and the
//   complement are chosen per base), runs round 0 at band ws0, tests the
//   acceptance, and runs round 1 at band ws1 on freshly initialised rows
//   only if the pair was rejected.  What bounded the TPU program's
//   counterpart here was not the card: per call, PyTorch re-packed the
//   whole chunk's read matrix into window words, wrote (P, Q) and (P, T)
//   int8 tiles to device memory and launched the DP twice, some 10 ms of
//   host time around 1 ms of kernels.  This kernel moves P x 48 B of meta,
//   the read and reference words the pairs touch and P x 32 B of results,
//   in one launch; its time is the recurrence's latency, as above.
//
// probe_add_one_kernel
//   Replaces the TPU package's toolchain probe (compseed_tpu/ops/bsw.py,
//   the kernel `k` run by pallas_available): x + 1 on one (8, 128) int32
//   tile.  bsw_cuda.self_check launches it once per device of a DP engine
//   and stops the run unless every element is right.  It moves 8 KB, so it is bound by
//   the launch itself: one block, 16 bytes a thread.
//
// The launchers allocate nothing, launch on the caller's stream of the
// calling thread's current device (the wrapper makes the tensors' device
// current) and return the CUDA error code (0 on success): a refused launch
// (too much shared memory, too many threads) reaches the wrapper, which
// raises.  Built with
// nvcc for sm_90a into a shared library with a plain C interface
// (compseed_tpu_torch/ops/bsw_cuda.py).  Compiled as C++ without nvcc, the
// same per-pair routines are exposed through host loops so that their
// arithmetic, the decode and the acceptance can be checked on a CPU.

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>
#define BSW_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define BSW_HD inline
#endif

// Whether the device-memory-scratch variant reads a cell's inputs ahead of
// the previous cell's stores, as the shared-memory kernels do (extend_one's
// HOIST).  chip_smoke.py --scratch-variants builds the source both ways and
// times them in turns; the default is the one that was not slower.
#ifndef BSW_SCRATCH_HOIST
#define BSW_SCRATCH_HOIST 1
#endif

namespace {

constexpr bool kScratchHoist = BSW_SCRATCH_HOIST != 0;

struct Gap {
  int o_del, e_del, o_ins, e_ins, zdrop;
};

// Query codes of one pair, clamped to 0..4.
struct TileQuery {          // a row of the (P, Q) int8 tile
  const int8_t* q;
  BSW_HD int operator()(int j) const {
    const int c = q[j];
    return (c < 0 || c > 4) ? 4 : c;
  }
};

struct PackedQuery {        // 3-bit codes, eight to a word, words at `stride`
  const uint32_t* w;
  size_t stride;
  BSW_HD int operator()(int j) const {
    return (int)((w[(size_t)(j >> 3) * stride] >> (3 * (j & 7))) & 7u);
  }
};

// Query code j of a pair read from its row of the chunk's read matrix, as
// ops/bsw_cuda.py::build_tiles decodes it: forward lanes read 8-code windows
// at clamp(q0 + 8k, 0, L + 1) upward (4 from column L on), reverse lanes at
// clamp(q0 - 8k, 0, L - 1) downward (4 below column 0).  For a pair inside
// its read that is q[q0 + j] or q[q0 - j].
struct ReadQuery {
  const uint8_t* row;
  int q0, L;
  bool rev;
  BSW_HD int operator()(int j) const {
    const int k8 = j & ~7, m = j & 7;
    int pos;
    if (rev) {
      int wp = q0 - k8;
      wp = wp < 0 ? 0 : (wp > L - 1 ? L - 1 : wp);
      pos = wp - m;
    } else {
      int wp = q0 + k8;
      wp = wp < 0 ? 0 : (wp > L + 1 ? L + 1 : wp);
      pos = wp + m;
    }
    const int c = (pos >= 0 && pos < L) ? (row[pos] & 7) : 4;
    return c > 4 ? 4 : c;
  }
};

// Target codes of one pair, clamped to 0..4 (everything else scores as N).
struct TileTarget {         // a row of the (P, T) int8 tile
  const int8_t* t;
  BSW_HD int operator()(int i) const {
    const int c = t[i];
    return (c < 0 || c > 3) ? 4 : c;
  }
};

// Target base i of a pair that starts at r0 on the doubled (forward +
// reverse-complement) reference and moves by sign: gp = r0 + sign * i is
// folded at l_pac (pf = gp < l_pac ? gp : 2*l_pac-1-gp) and complemented on
// the mirrored branch, each base choosing its own branch.  pac holds one
// uint32 word of 16 bases per int64 element; base b of a word sits at bit
// 8*(b>>2) + 2*(3-(b&3)).  Word indices outside the array clip.  The last
// word read stays in a register.
struct PacTarget {
  const long long* pac;
  long long n_words, l_pac, r0;
  int sign;
  long long widx;
  uint32_t word;
  BSW_HD int operator()(int i) {
    const long long gp = r0 + (long long)sign * i;
    const bool fwd = gp < l_pac;
    const long long pf = fwd ? gp : 2 * l_pac - 1 - gp;
    long long wi = pf >> 4;
    wi = wi < 0 ? 0 : (wi >= n_words ? n_words - 1 : wi);
    if (wi != widx) {
      widx = wi;
      word = (uint32_t)pac[wi];
    }
    const int b = (int)(pf & 15);
    const int c = (int)((word >> (8 * (b >> 2) + 2 * (3 - (b & 3)))) & 3u);
    return fwd ? c : 3 - c;
  }
};

// One pair.  H/E hold columns 0..qlen of this pair at `stride`:
// H[j] = H(i-1, j-1) (the diagonal input of column j), E[j] = E(i, j).
// S is the storage type of both rows (int32_t or int16_t).  res gets
// score, qle, tle, gtle, gscore, max_off.  HOIST: read the next cell's
// inputs before this cell's stores (below).
template <bool HOIST, typename S, typename QF, typename TF>
BSW_HD void extend_one(const int* mat, QF& qcode, int qlen, TF& tcode,
                       int tlen, int h0, int w, const Gap g, S* H, S* E,
                       size_t stride, int* res) {
  const int oe_del = g.o_del + g.e_del;
  const int oe_ins = g.o_ins + g.e_ins;

  // first row (ksw.c:395-397): h[j] = max(h0 - oe_ins - (j-1)*e_ins, 0)
  H[0] = (S)h0;
  E[0] = 0;
  for (int j = 1; j <= qlen; ++j) {
    const int v = h0 - oe_ins - (j - 1) * g.e_ins;
    H[j * stride] = (S)(v > 0 ? v : 0);
    E[j * stride] = 0;
  }

  int beg = 0, end = qlen;
  int best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0;
  for (int i = 0; i < tlen; ++i) {
    const int beg_i = beg > i - w ? beg : i - w;
    int end_i = end < i + w + 1 ? end : i + w + 1;
    if (end_i > qlen) end_i = qlen;
    int h_first = 0;
    if (beg_i == 0) {
      h_first = h0 - (g.o_del + g.e_del * (i + 1));
      if (h_first < 0) h_first = 0;
    }
    const int* srow = mat + tcode(i) * 5;

    // With HOIST the next cell's inputs are read before this cell's
    // stores: they are other columns, so nothing changes, and a cell's
    // loads no longer wait behind the stores of the cell before it.  What
    // is left between two cells is the h -> f -> h chain in registers.
    int h1 = h_first, f = 0, m = 0, mj = -1;
    int Mn = 0, en = 0, sn = 0;
    if (HOIST && beg_i < end_i) {
      Mn = H[beg_i * stride];
      en = E[beg_i * stride];
      sn = srow[qcode(beg_i)];
    }
    for (int j = beg_i; j < end_i; ++j) {
      int M, e, sc;
      if (HOIST) {
        M = Mn;
        e = en;
        sc = sn;
        Mn = H[(j + 1) * stride];         // column j + 1 <= qlen exists
        en = E[(j + 1) * stride];
        if (j + 1 < end_i) sn = srow[qcode(j + 1)];
      } else {
        M = H[j * stride];
        e = E[j * stride];
        sc = srow[qcode(j)];
      }
      H[j * stride] = (S)h1;              // H(i, j-1) for the next row
      M = M ? M + sc : 0;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (h >= m) {                       // LAST column attaining the max
        m = h;
        mj = j;
      }
      int tt = M - oe_del;
      tt = tt > 0 ? tt : 0;
      e -= g.e_del;
      E[j * stride] = (S)(e > tt ? e : tt);  // E(i+1, j)
      tt = M - oe_ins;
      tt = tt > 0 ? tt : 0;
      f -= g.e_ins;
      f = f > tt ? f : tt;                // F(i, j+1)
    }
    const bool empty = end_i <= beg_i;
    if (!empty) {
      H[end_i * stride] = (S)h1;
      E[end_i * stride] = 0;
    }
    if (m == 0) mj = -1;

    // to-query-end score (ksw.c:450-453)
    if (end_i == qlen) {
      const int h1_last = empty ? h_first : h1;
      if (gscore <= h1_last) {
        max_ie = i;
        gscore = h1_last;
      }
    }
    // break / best / z-drop (ksw.c:454-463)
    if (m == 0) break;
    if (m > best) {
      best = m;
      max_i = i;
      max_j = mj;
      const int off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    } else if (g.zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      if (di > dj) {
        if (best - m - (di - dj) * g.e_del > g.zdrop) break;
      } else {
        if (best - m - (dj - di) * g.e_ins > g.zdrop) break;
      }
    }
    // shrink the band to the non-zero span (ksw.c:465-469)
    int j = beg_i;
    while (j < end_i && H[j * stride] == 0 && E[j * stride] == 0) ++j;
    beg = j;
    j = end_i;
    while (j >= beg && H[j * stride] == 0 && E[j * stride] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  res[0] = best;
  res[1] = max_j + 1;
  res[2] = max_i + 1;
  res[3] = max_ie + 1;
  res[4] = gscore;
  res[5] = max_off;
}

BSW_HD int clamp_len(int n, int width) {
  return n < 0 ? 0 : (n > width ? width : n);
}

BSW_HD void store_result(int* out, const int* res, int col6) {
  for (int c = 0; c < 6; ++c) out[c] = res[c];
  out[6] = col6;
  out[7] = 0;
}

// Eight query codes -> one word of 3-bit fields; qw gets ceil(qlen / 8)
// words at `stride`.  code(j) gives the code of column j < qlen.
template <typename CF>
BSW_HD void stage_query(uint32_t* qw, size_t stride, int qlen, CF code) {
  for (int k = 0; 8 * k < qlen; ++k) {
    uint32_t word = 0;
    for (int m = 0; m < 8; ++m) {
      const int j = 8 * k + m;
      const int c = j < qlen ? code(j) : 4;
      word |= (uint32_t)c << (3 * m);
    }
    qw[(size_t)k * stride] = word;
  }
}

// Pair p of the tile interface.  Query and target lengths beyond the tile
// widths are clamped so no thread reads or writes outside its rows (the
// runner never passes them).  qw == nullptr: read the query from its tile
// at every cell; else stage it into qw first.
template <typename S, bool HOIST>
BSW_HD void extend_pair(int p, int Q, int T, const int* mat,
                        const int8_t* queries, const int* qlens,
                        const int8_t* targets, const int* tlens,
                        const int* h0s, const int* ws, const Gap g,
                        int* out, S* H, S* E, uint32_t* qw, size_t stride) {
  const int qlen = clamp_len(qlens[p], Q);
  const int tlen = clamp_len(tlens[p], T);
  TileQuery tq{queries + (size_t)p * Q};
  TileTarget tt{targets + (size_t)p * T};
  int res[6];
  if (qw == nullptr) {
    extend_one<HOIST>(mat, tq, qlen, tt, tlen, h0s[p], ws[p], g, H, E, stride,
                      res);
  } else {
    stage_query(qw, stride, qlen, tq);
    PackedQuery pq{qw, stride};
    extend_one<HOIST>(mat, pq, qlen, tt, tlen, h0s[p], ws[p], g, H, E, stride,
                      res);
  }
  store_result(out + (size_t)p * 8, res, 0);
}

// Pair p of the metadata interface: decode, round 0, acceptance, round 1.
// meta columns: rid, q0, qlen, rev, r0_lo, r0_hi, rlen, h0, prev_score,
// ws0, ws1, pad.  rid must be a row of the read matrix (it is clipped).
template <typename S>
BSW_HD void meta_dual_pair(const int* mat, const uint8_t* qflat,
                           long long n_rows, const long long* pac,
                           long long n_words, const int* meta, int Q, int T,
                           int L, long long l_pac, const Gap g, int w0,
                           int wide_r0, int* out, S* H, S* E, uint32_t* qw,
                           size_t stride) {
  long long rid = meta[0];
  rid = rid < 0 ? 0 : (rid >= n_rows ? n_rows - 1 : rid);
  const int q0 = meta[1];
  const int qlen = clamp_len(meta[2], Q);
  const bool rev = meta[3] == 1;
  const long long r0 =
      wide_r0 ? (long long)(((unsigned long long)(uint32_t)meta[4]) |
                            ((unsigned long long)(uint32_t)meta[5] << 32))
              : (long long)meta[4];
  const int tlen = clamp_len(meta[6], T);
  const int h0 = meta[7], prev = meta[8], ws0 = meta[9], ws1 = meta[10];

  ReadQuery rq{qflat + rid * L, q0, L, rev};
  stage_query(qw, stride, qlen, rq);
  PackedQuery pq{qw, stride};
  PacTarget pt{pac, n_words, l_pac, r0, rev ? -1 : 1, -1, 0u};

  int res[6];
  extend_one<true>(mat, pq, qlen, pt, tlen, h0, ws0, g, H, E, stride, res);
  int rnd = 0;
  if (!(res[0] == prev || res[5] < (w0 >> 1) + (w0 >> 2))) {
    rnd = 1;
    extend_one<true>(mat, pq, qlen, pt, tlen, h0, ws1, g, H, E, stride, res);
  }
  store_result(out, res, rnd);
}

// Bytes of one pair's rows in shared memory: H and E of Q + 1 columns and
// ceil(Q / 8) words of query codes (ops/bsw_cuda.py::pair_bytes).
template <typename S>
BSW_HD size_t pair_bytes(int Q) {
  return (size_t)(Q + 1) * 2 * sizeof(S) + (size_t)((Q + 7) / 8) * 4;
}

#ifdef __CUDACC__
// A block's dynamic shared memory: query words, then H, then E, each
// [column][thread].
template <typename S>
struct BlockRows {
  uint32_t* qw;
  S* H;
  S* E;
  __device__ BlockRows(unsigned char* base, int Q) {
    const size_t nt = blockDim.x;
    qw = reinterpret_cast<uint32_t*>(base) + threadIdx.x;
    S* rows = reinterpret_cast<S*>(base + (size_t)((Q + 7) / 8) * 4 * nt);
    H = rows + threadIdx.x;
    E = rows + (size_t)(Q + 1) * nt + threadIdx.x;
  }
};

template <typename S, bool ROWS_SHARED>
__global__ void bsw_extend_kernel(const int* __restrict__ mat,
                                  const int8_t* __restrict__ queries,
                                  const int* __restrict__ qlens,
                                  const int8_t* __restrict__ targets,
                                  const int* __restrict__ tlens,
                                  const int* __restrict__ h0s,
                                  const int* __restrict__ ws,
                                  int* __restrict__ out,
                                  S* __restrict__ hbuf, S* __restrict__ ebuf,
                                  int P, int Q, int T, Gap g) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  if (ROWS_SHARED) {
    BlockRows<S> r(dyn_smem, Q);
    extend_pair<S, true>(p, Q, T, smat, queries, qlens, targets, tlens, h0s,
                         ws, g, out, r.H, r.E, r.qw, blockDim.x);
  } else {
    extend_pair<S, kScratchHoist>(p, Q, T, smat, queries, qlens, targets,
                                  tlens, h0s, ws, g, out, hbuf + p, ebuf + p,
                                  nullptr, (size_t)P);
  }
}

template <typename S>
__global__ void bsw_meta_dual_kernel(const int* __restrict__ mat,
                                     const uint8_t* __restrict__ qflat,
                                     long long n_rows,
                                     const long long* __restrict__ pac,
                                     long long n_words,
                                     const int* __restrict__ meta,
                                     int* __restrict__ out, int P, int Q,
                                     int T, int L, long long l_pac, Gap g,
                                     int w0, int wide_r0) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  BlockRows<S> r(dyn_smem, Q);
  meta_dual_pair<S>(smat, qflat, n_rows, pac, n_words, meta + (size_t)p * 12,
                    Q, T, L, l_pac, g, w0, wide_r0, out + (size_t)p * 8, r.H,
                    r.E, r.qw, blockDim.x);
}

// The largest dynamic shared memory already allowed for one kernel, per
// device: the attribute that allows more than 48 KB belongs to the device
// that was current when it was set, so each card is told once.  The mutex
// makes the test and the set one step when host threads launch at once;
// a grant only ever grows, so a launch never finds less than it tested.
constexpr int kMaxDevices = 64;
struct Grant {
  std::mutex mu;
  size_t bytes[kMaxDevices] = {};
};

// Allow `bytes` of dynamic shared memory for `kernel` on the current device.
template <typename K>
int grant_shared(K kernel, size_t bytes, Grant* grant) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(grant->mu);
  if (bytes <= grant->bytes[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // the error is returned, not left
    return (int)err;
  }
  grant->bytes[dev] = bytes;
  return 0;
}

// threads > 0: rows in shared memory, `threads` pairs a block; threads == 0:
// rows in the device-memory scratch hbuf/ebuf, (Q + 1) * P elements each.
template <typename S>
int launch_extend(const int* mat25, const int8_t* queries, const int* qlens,
                  const int8_t* targets, const int* tlens, const int* h0s,
                  const int* ws, int* out, S* hbuf, S* ebuf, int P, int Q,
                  int T, const Gap g, int threads, void* stream) {
  static Grant granted;
  if (P <= 0) return 0;
  if (threads < 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  if (threads == 0) {
    const int nt = 128;
    bsw_extend_kernel<S, false><<<(P + nt - 1) / nt, nt, 0,
                                  (cudaStream_t)stream>>>(
        mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf, ebuf, P,
        Q, T, g);
    return (int)cudaGetLastError();
  }
  const size_t bytes = pair_bytes<S>(Q) * threads;
  const int err = grant_shared(bsw_extend_kernel<S, true>, bytes, &granted);
  if (err) return err;
  bsw_extend_kernel<S, true><<<(P + threads - 1) / threads, threads, bytes,
                               (cudaStream_t)stream>>>(
      mat25, queries, qlens, targets, tlens, h0s, ws, out, nullptr, nullptr,
      P, Q, T, g);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_meta_dual(const int* mat25, const uint8_t* qflat, long long n_rows,
                     const long long* pac, long long n_words, const int* meta,
                     int* out, int P, int Q, int T, int L, long long l_pac,
                     const Gap g, int w0, int wide_r0, int threads,
                     void* stream) {
  static Grant granted;
  if (P <= 0) return 0;
  if (threads <= 0 || threads > 1024 || n_rows <= 0 || n_words <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = pair_bytes<S>(Q) * threads;
  const int err = grant_shared(bsw_meta_dual_kernel<S>, bytes, &granted);
  if (err) return err;
  bsw_meta_dual_kernel<S><<<(P + threads - 1) / threads, threads, bytes,
                            (cudaStream_t)stream>>>(
      mat25, qflat, n_rows, pac, n_words, meta, out, P, Q, T, L, l_pac, g, w0,
      wide_r0);
  return (int)cudaGetLastError();
}

// One block; each thread moves one int4 (16 bytes).
__global__ void probe_add_one_kernel(const int4* __restrict__ x,
                                     int4* __restrict__ y) {
  int4 v = x[threadIdx.x];
  v.x += 1;
  v.y += 1;
  v.z += 1;
  v.w += 1;
  y[threadIdx.x] = v;
}
#else
// Host loops over the same per-pair routines, one pair at a time on rows of
// stride 1.
template <typename S>
void host_extend(const int* mat25, const int8_t* queries, const int* qlens,
                 const int8_t* targets, const int* tlens, const int* h0s,
                 const int* ws, int* out, S* hbuf, S* ebuf, int P, int Q,
                 int T, const Gap g, int staged) {
  std::vector<uint32_t> qw((size_t)(Q + 7) / 8 + 1);
  for (int p = 0; p < P; ++p)
    if (staged)
      extend_pair<S, true>(p, Q, T, mat25, queries, qlens, targets, tlens,
                           h0s, ws, g, out, hbuf + p, ebuf + p, qw.data(), 1);
    else
      extend_pair<S, kScratchHoist>(p, Q, T, mat25, queries, qlens, targets,
                                    tlens, h0s, ws, g, out, hbuf + p,
                                    ebuf + p, nullptr, (size_t)P);
}

template <typename S>
void host_meta_dual(const int* mat25, const uint8_t* qflat, long long n_rows,
                    const long long* pac, long long n_words, const int* meta,
                    int* out, int P, int Q, int T, int L, long long l_pac,
                    const Gap g, int w0, int wide_r0) {
  std::vector<uint32_t> qw((size_t)(Q + 7) / 8 + 1);
  std::vector<S> H((size_t)Q + 1), E((size_t)Q + 1);
  for (int p = 0; p < P; ++p)
    meta_dual_pair<S>(mat25, qflat, n_rows, pac, n_words,
                      meta + (size_t)p * 12, Q, T, L, l_pac, g, w0, wide_r0,
                      out + (size_t)p * 8, H.data(), E.data(), qw.data(), 1);
}
#endif

}  // namespace

// What ops/bsw_cuda.py::pair_bytes must equal (both builds).
extern "C" long long bsw_pair_bytes(int Q, int state16) {
  return (long long)(state16 ? pair_bytes<int16_t>(Q)
                             : pair_bytes<int32_t>(Q));
}

#ifdef __CUDACC__
// threads > 0: shared-memory rows (hbuf/ebuf unused); threads == 0: hbuf/
// ebuf are (Q + 1) * P int32 scratch each.  Returns the CUDA error code.
extern "C" int bsw_extend_launch(const int* mat25, const int8_t* queries,
                                 const int* qlens, const int8_t* targets,
                                 const int* tlens, const int* h0s,
                                 const int* ws, int* out, int* hbuf,
                                 int* ebuf, int P, int Q, int T, int o_del,
                                 int e_del, int o_ins, int e_ins, int zdrop,
                                 int threads, void* stream) {
  return launch_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out,
                       hbuf, ebuf, P, Q, T,
                       Gap{o_del, e_del, o_ins, e_ins, zdrop}, threads,
                       stream);
}

// The same with int16 H/E rows (scratch: (Q + 1) * P int16 each).
extern "C" int bsw_extend_launch_i16(const int* mat25, const int8_t* queries,
                                     const int* qlens, const int8_t* targets,
                                     const int* tlens, const int* h0s,
                                     const int* ws, int* out, int16_t* hbuf,
                                     int16_t* ebuf, int P, int Q, int T,
                                     int o_del, int e_del, int o_ins,
                                     int e_ins, int zdrop, int threads,
                                     void* stream) {
  return launch_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out,
                       hbuf, ebuf, P, Q, T,
                       Gap{o_del, e_del, o_ins, e_ins, zdrop}, threads,
                       stream);
}

// qflat: (n_rows, L) uint8 read matrix; pac: n_words int64 elements holding
// uint32 words; meta: (P, 12) int32; out: (P, 8) int32.
extern "C" int bsw_meta_dual_launch(const int* mat25, const uint8_t* qflat,
                                    long long n_rows, const long long* pac,
                                    long long n_words, const int* meta,
                                    int* out, int P, int Q, int T, int L,
                                    long long l_pac, int o_del, int e_del,
                                    int o_ins, int e_ins, int zdrop, int w0,
                                    int wide_r0, int threads, void* stream) {
  return launch_meta_dual<int32_t>(
      mat25, qflat, n_rows, pac, n_words, meta, out, P, Q, T, L, l_pac,
      Gap{o_del, e_del, o_ins, e_ins, zdrop}, w0, wide_r0, threads, stream);
}

extern "C" int bsw_meta_dual_launch_i16(
    const int* mat25, const uint8_t* qflat, long long n_rows,
    const long long* pac, long long n_words, const int* meta, int* out, int P,
    int Q, int T, int L, long long l_pac, int o_del, int e_del, int o_ins,
    int e_ins, int zdrop, int w0, int wide_r0, int threads, void* stream) {
  return launch_meta_dual<int16_t>(
      mat25, qflat, n_rows, pac, n_words, meta, out, P, Q, T, L, l_pac,
      Gap{o_del, e_del, o_ins, e_ins, zdrop}, w0, wide_r0, threads, stream);
}

// y[i] = x[i] + 1 for i < n; x and y 16-byte aligned, n a multiple of 4 and
// at most 4096.  Returns the CUDA error code.
extern "C" int probe_add_one_launch(const int* x, int* y, int n,
                                    void* stream) {
  if (n <= 0 || n % 4 || n > 4096) return (int)cudaErrorInvalidValue;
  probe_add_one_kernel<<<1, n / 4, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(y));
  return (int)cudaGetLastError();
}

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* bsw_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The per-pair routines on the host, for checking them without a card.
// staged != 0 takes the packed-query route of the shared-memory kernel (the
// scratch then only needs Q + 1 elements per row); 0 the tile route of the
// device-memory-scratch kernel, rows laid out [column][pair].
extern "C" void bsw_extend_host(const int* mat25, const int8_t* queries,
                                const int* qlens, const int8_t* targets,
                                const int* tlens, const int* h0s,
                                const int* ws, int* out, int* hbuf,
                                int* ebuf, int P, int Q, int T, int o_del,
                                int e_del, int o_ins, int e_ins,
                                int zdrop) {
  host_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf,
              ebuf, P, Q, T, Gap{o_del, e_del, o_ins, e_ins, zdrop}, 0);
}

extern "C" void bsw_extend_host_i16(const int* mat25, const int8_t* queries,
                                    const int* qlens, const int8_t* targets,
                                    const int* tlens, const int* h0s,
                                    const int* ws, int* out, int16_t* hbuf,
                                    int16_t* ebuf, int P, int Q, int T,
                                    int o_del, int e_del, int o_ins,
                                    int e_ins, int zdrop) {
  host_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf,
              ebuf, P, Q, T, Gap{o_del, e_del, o_ins, e_ins, zdrop}, 0);
}

extern "C" void bsw_extend_host_staged(
    const int* mat25, const int8_t* queries, const int* qlens,
    const int8_t* targets, const int* tlens, const int* h0s, const int* ws,
    int* out, int* hbuf, int* ebuf, int P, int Q, int T, int o_del, int e_del,
    int o_ins, int e_ins, int zdrop) {
  host_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf,
              ebuf, P, Q, T, Gap{o_del, e_del, o_ins, e_ins, zdrop}, 1);
}

extern "C" void bsw_extend_host_staged_i16(
    const int* mat25, const int8_t* queries, const int* qlens,
    const int8_t* targets, const int* tlens, const int* h0s, const int* ws,
    int* out, int16_t* hbuf, int16_t* ebuf, int P, int Q, int T, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop) {
  host_extend(mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf,
              ebuf, P, Q, T, Gap{o_del, e_del, o_ins, e_ins, zdrop}, 1);
}

extern "C" void bsw_meta_dual_host(const int* mat25, const uint8_t* qflat,
                                   long long n_rows, const long long* pac,
                                   long long n_words, const int* meta,
                                   int* out, int P, int Q, int T, int L,
                                   long long l_pac, int o_del, int e_del,
                                   int o_ins, int e_ins, int zdrop, int w0,
                                   int wide_r0) {
  host_meta_dual<int32_t>(mat25, qflat, n_rows, pac, n_words, meta, out, P, Q,
                          T, L, l_pac, Gap{o_del, e_del, o_ins, e_ins, zdrop},
                          w0, wide_r0);
}

extern "C" void bsw_meta_dual_host_i16(const int* mat25, const uint8_t* qflat,
                                       long long n_rows, const long long* pac,
                                       long long n_words, const int* meta,
                                       int* out, int P, int Q, int T, int L,
                                       long long l_pac, int o_del, int e_del,
                                       int o_ins, int e_ins, int zdrop,
                                       int w0, int wide_r0) {
  host_meta_dual<int16_t>(mat25, qflat, n_rows, pac, n_words, meta, out, P, Q,
                          T, L, l_pac, Gap{o_del, e_del, o_ins, e_ins, zdrop},
                          w0, wide_r0);
}
#endif
