// Banded Smith-Waterman extension (ksw_extend2, bwalib/ksw.c:380-479) for
// a batch of query/target pairs, one thread per pair.
//
// Replaces the Pallas TPU kernel compseed_tpu/ops/bsw_pallas.py::_kernel
// (launched by _call_kernel through bsw_extend_tiles / bsw_meta_tiles /
// bsw.py::_meta_dual_core).  Same inputs, same (P, 8) int32 output:
// score, qle, tle, gtle, gscore, max_off, 0, 0.  It computes exactly what
// the plain PyTorch version compseed_tpu_torch/ops/bsw.py::_extend_core
// computes, including its corner cases (an emptied band breaks after the
// query-end update; gscore is tested at end == qlen).
//
// What bounds it on Hopper: the DP is a sequential row recurrence with
// data-dependent early exits (z-drop, band emptied, band shrink), so it is
// latency- and memory-bound, not arithmetic-bound: each band cell reads
// and writes one H and one E word.  The TPU kernel swept all Q columns of
// an (LT, Q) lane tile on every row; here a thread walks only its own band
// [beg, end), so work scales with the band, and pairs that break early
// stop paying at once.  The H/E rows live in a scratch buffer laid out
// [column][pair], so neighbouring threads touch neighbouring words when
// their bands line up; the runner sorts pairs by target length so the
// threads of a warp finish together.  Scores come from the full 5x5
// matrix as mat[tchar*5 + qchar], so any scoring matrix is served.
//
// The launcher allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().  Built with nvcc for sm_90a into a shared
// library with a plain C interface (compseed_tpu_torch/ops/bsw_cuda.py).
// Compiled as C++ without nvcc, the same per-pair routine is exposed
// through a host loop so its arithmetic can be checked on a CPU.

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BSW_HD __host__ __device__ __forceinline__
#else
#define BSW_HD inline
#endif

namespace {

struct Gap {
  int o_del, e_del, o_ins, e_ins, zdrop;
};

// One pair.  H/E hold columns 0..qlen of this pair at stride P:
// H[j] = H(i-1, j-1) (the diagonal input of column j), E[j] = E(i, j).
BSW_HD void extend_one(const int* mat, const int8_t* q, int qlen,
                       const int8_t* t, int tlen, int h0, int w,
                       const Gap g, int* H, int* E, size_t P, int* out) {
  const int oe_del = g.o_del + g.e_del;
  const int oe_ins = g.o_ins + g.e_ins;

  // first row (ksw.c:395-397): h[j] = max(h0 - oe_ins - (j-1)*e_ins, 0)
  H[0] = h0;
  E[0] = 0;
  for (int j = 1; j <= qlen; ++j) {
    const int v = h0 - oe_ins - (j - 1) * g.e_ins;
    H[j * P] = v > 0 ? v : 0;
    E[j * P] = 0;
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
    int tc = t[i];
    if (tc < 0 || tc > 3) tc = 4;
    const int* srow = mat + tc * 5;

    int h1 = h_first, f = 0, m = 0, mj = -1;
    for (int j = beg_i; j < end_i; ++j) {
      int M = H[j * P];
      int e = E[j * P];
      H[j * P] = h1;                      // H(i, j-1) for the next row
      int qc = q[j];
      if (qc < 0 || qc > 4) qc = 4;
      M = M ? M + srow[qc] : 0;
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
      E[j * P] = e > tt ? e : tt;         // E(i+1, j)
      tt = M - oe_ins;
      tt = tt > 0 ? tt : 0;
      f -= g.e_ins;
      f = f > tt ? f : tt;                // F(i, j+1)
    }
    const bool empty = end_i <= beg_i;
    if (!empty) {
      H[end_i * P] = h1;
      E[end_i * P] = 0;
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
    while (j < end_i && H[j * P] == 0 && E[j * P] == 0) ++j;
    beg = j;
    j = end_i;
    while (j >= beg && H[j * P] == 0 && E[j * P] == 0) --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  out[0] = best;
  out[1] = max_j + 1;
  out[2] = max_i + 1;
  out[3] = max_ie + 1;
  out[4] = gscore;
  out[5] = max_off;
  out[6] = 0;
  out[7] = 0;
}

// Query and target lengths beyond the tile widths are clamped so no
// thread reads or writes outside its row (the runner never passes them).
BSW_HD void extend_pair(int p, int P, int Q, int T, const int* mat,
                        const int8_t* queries, const int* qlens,
                        const int8_t* targets, const int* tlens,
                        const int* h0s, const int* ws, const Gap g,
                        int* out, int* hbuf, int* ebuf) {
  int qlen = qlens[p], tlen = tlens[p];
  qlen = qlen < 0 ? 0 : (qlen > Q ? Q : qlen);
  tlen = tlen < 0 ? 0 : (tlen > T ? T : tlen);
  extend_one(mat, queries + (size_t)p * Q, qlen, targets + (size_t)p * T,
             tlen, h0s[p], ws[p], g, hbuf + p, ebuf + p, (size_t)P,
             out + (size_t)p * 8);
}

#ifdef __CUDACC__
__global__ void bsw_extend_kernel(const int* __restrict__ mat,
                                  const int8_t* __restrict__ queries,
                                  const int* __restrict__ qlens,
                                  const int8_t* __restrict__ targets,
                                  const int* __restrict__ tlens,
                                  const int* __restrict__ h0s,
                                  const int* __restrict__ ws,
                                  int* __restrict__ out, int* hbuf,
                                  int* ebuf, int P, int Q, int T, Gap g) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  extend_pair(p, P, Q, T, smat, queries, qlens, targets, tlens, h0s, ws, g,
              out, hbuf, ebuf);
}
#endif

}  // namespace

#ifdef __CUDACC__
// hbuf/ebuf: (Q + 1) * P int32 scratch each.  Returns cudaGetLastError().
extern "C" int bsw_extend_launch(const int* mat25, const int8_t* queries,
                                 const int* qlens, const int8_t* targets,
                                 const int* tlens, const int* h0s,
                                 const int* ws, int* out, int* hbuf,
                                 int* ebuf, int P, int Q, int T, int o_del,
                                 int e_del, int o_ins, int e_ins, int zdrop,
                                 void* stream) {
  if (P > 0) {
    const int threads = 128;
    const int blocks = (P + threads - 1) / threads;
    bsw_extend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        mat25, queries, qlens, targets, tlens, h0s, ws, out, hbuf, ebuf, P,
        Q, T, Gap{o_del, e_del, o_ins, e_ins, zdrop});
  }
  return (int)cudaGetLastError();
}
#else
// The same per-pair routine on the host, for checking it without a card.
extern "C" void bsw_extend_host(const int* mat25, const int8_t* queries,
                                const int* qlens, const int8_t* targets,
                                const int* tlens, const int* h0s,
                                const int* ws, int* out, int* hbuf,
                                int* ebuf, int P, int Q, int T, int o_del,
                                int e_del, int o_ins, int e_ins,
                                int zdrop) {
  const Gap g{o_del, e_del, o_ins, e_ins, zdrop};
  for (int p = 0; p < P; ++p)
    extend_pair(p, P, Q, T, mat25, queries, qlens, targets, tlens, h0s, ws,
                g, out, hbuf, ebuf);
}
#endif
