// The FM-index primitives of the seeding walks and the suffix-array walk,
// one thread per lane, the lane's state in registers.
//
// In the JAX package these are no Pallas kernels: XLA fuses each of them
// into one row gather plus one elementwise fusion inside the seeding
// programs.  The port rendered the same arithmetic as separate PyTorch
// operations, about 100 launches for one extension of a batch of lanes;
// these kernels are the port's counterpart of XLA's fusion.
//
// fm_extend_sel_kernel<T>
//   Replaces compseed_tpu/ops/fm.py:128 extend_sel_batch (with _row_fetch
//   :28, _rank4 :42 and _occ4_pair :75): the one-child bidirectional
//   extension of a bi-interval (k, l, s) by base c.  Plain version:
//   compseed_tpu_torch/ops/fm.py::_extend_sel_plain.
// fm_chain_walk_kernel<T>
//   Replaces compseed_tpu/ops/seedscan.py:1341 _chain_walk: W <= 10 pure
//   extensions per representative over the 3-bit codes of its packed
//   window word, stopping at the first ambiguous base (and, with stop_s,
//   once the interval drops below the group's smallest min_hits).  Plain
//   version: compseed_tpu_torch/ops/seedscan.py::_chain_walk_plain.
// fm_inv_psi_walk_kernel<T>
//   Replaces compseed_tpu/ops/fm.py:166 inv_psi_batch stepped n times, as
//   the step loops of sa_batch (:200) and sa_batch_compact (run, :256) do:
//   per step kk = invPsi(kk) and steps += 1 on live lanes, then a lane dies
//   once kk is a sampled row.  Plain version: compseed_tpu_torch/ops/fm.py::
//   _walk_plain.
//
// T is the index type: int32_t, or int64_t for genomes of 2^31 positions
// or more (DeviceFMIndex.dtype).  Arithmetic on positions and counts wraps
// in T, as the plain version's int32 / int64 tensors do, so garbage lanes
// give the same bits too.  An occ row is read as the plain version's
// gather reads it: a block in [-n, n) (negative blocks wrap, as a tensor
// index does), else with fill_oob a row of all-ones words (jnp.take's fill
// rule), else the kernel traps, as the plain version's device-side index
// check does: it never reads past the table.  A lane that does not step
// reads nothing.
//
// What bounds them on Hopper: each extension reads two 96-byte occ rows (12
// words of 8 bytes, the layout of ops/device_index.py) at data-dependent
// rows, and an inverse-Psi step one; the rank is 16 popcounts and a few
// masks per row.  So the bound is the bytes of the rows over the memory
// rate; in practice it is the latency of a dependent chain of random
// reads, since step j + 1 of a lane needs step j's interval.  The design:
// one launch runs every step of a walk (the W-step chain, the n-step
// inverse-Psi segment), so the per-launch host cost that dominated the
// plain version is paid once per walk; a lane that stops leaves its loop.
// Coalescing the row reads, L2 residency of the table and a warp per lane
// are later work.
//
// The launchers allocate nothing, launch on the caller's stream of the
// calling thread's current device (the wrapper, ops/fm_cuda.py, makes the
// tensors' device current) and return the CUDA error code.  Built with
// nvcc for sm_90a into a shared library with a plain C interface.
// Compiled as C++ without nvcc, the same lane routines run in host loops
// (fm_*_host), so that their arithmetic is checked on a CPU.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FM_HD __host__ __device__ __forceinline__
#else
#define FM_HD inline
#endif

namespace {

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

// a + b and a - b modulo 2^bits(T), as tensor arithmetic in T wraps.
template <typename T>
FM_HD T wadd(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a + (U)b);
}

template <typename T>
FM_HD T wsub(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a - (U)b);
}

FM_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

struct Fault {};

// A read outside the table without fill_oob, or a child base outside
// [0, 3]: the plain version raises (an index check); the kernel traps.
FM_HD void fault() {
#if defined(__CUDA_ARCH__)
  __trap();
#elif defined(__CUDACC__)
  abort();                    // the host pass of the nvcc build: unused
#else
  throw Fault{};
#endif
}

// The index as a lane sees it.
template <typename T>
struct Fm {
  const long long* occ;       // (n_rows, 12): uint32 words held in int64
  long long n_rows;
  T L2[5];
  long long primary;
  bool fill_oob;
};

struct Row {
  uint32_t cnt[4], hi[4], lo[4];
};

// The fused row of the 128-base block holding (already $-adjusted) k.
template <typename T>
FM_HD void fetch_row(const Fm<T>& fm, long long k, Row& r) {
  const long long blk = k >> 7;
  const long long n = fm.n_rows;
  if (blk >= -n && blk < n) {
    const long long* p = fm.occ + (blk < 0 ? blk + n : blk) * 12;
    for (int i = 0; i < 4; ++i) {
      r.cnt[i] = (uint32_t)p[i];
      r.hi[i] = (uint32_t)p[4 + i];
      r.lo[i] = (uint32_t)p[8 + i];
    }
    return;
  }
  if (!fm.fill_oob) fault();
  for (int i = 0; i < 4; ++i) r.cnt[i] = r.hi[i] = r.lo[i] = 0xFFFFFFFFu;
}

// Counts of each base among block positions 0..off inclusive, plus the
// block's checkpoint counts (ops/fm.py::_rank4).
template <typename T>
FM_HD void rank4(const Row& r, int off, T out[4]) {
  uint32_t c[4] = {0, 0, 0, 0};
  for (int w = 0; w < 4; ++w) {
    const int nb = off - 32 * w + 1;
    if (nb <= 0) break;
    const uint32_t mask = nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u);
    const uint32_t hm = r.hi[w] & mask, lm = r.lo[w] & mask;
    const uint32_t nh = ~hm & mask, nl = ~lm & mask;
    c[3] += popc(hm & lm);
    c[2] += popc(hm & nl);
    c[1] += popc(nh & lm);
    c[0] += popc(nh & nl);
  }
  using U = typename Unsigned<T>::type;
  for (int b = 0; b < 4; ++b) out[b] = wadd((T)(U)r.cnt[b], (T)c[b]);
}

// occ4 at k (bwt_occ4): k == -1 counts zero (ops/fm.py::occ4_batch).
template <typename T>
FM_HD void occ4(const Fm<T>& fm, T k, T out[4]) {
  if (k == (T)-1) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  const T kk = (long long)k >= fm.primary ? wsub(k, (T)1) : k;
  Row r;
  fetch_row(fm, (long long)kk, r);
  rank4(r, (int)((long long)kk & 127), out);
}

// The child c of bi-interval ik = (k, l, s): columns [fwd] the searched
// coordinate, [bwd] the other one, [2] the size (ops/fm.py::
// _extend_sel_plain).
template <typename T>
FM_HD void extend_sel(const Fm<T>& fm, const T ik[3], int c, bool is_back,
                      T out[3]) {
  if (c < 0 || c > 3) {
    fault();
    return;
  }
  const int fwd = is_back ? 0 : 1, bwd = 1 - fwd;
  const T x = ik[fwd], s = ik[2];
  const T xm1 = wsub(x, (T)1);
  T tk[4], tl[4];
  occ4(fm, xm1, tk);
  occ4(fm, wadd(xm1, s), tl);
  T sizes[4];
  for (int b = 0; b < 4; ++b) sizes[b] = wsub(tl[b], tk[b]);
  const bool has_primary = (long long)x <= fm.primary &&
                           (long long)wsub(wadd(x, s), (T)1) >= fm.primary;
  T above = 0;
  for (int b = c + 1; b < 4; ++b) above = wadd(above, sizes[b]);
  out[fwd] = wadd(wadd(fm.L2[c], (T)1), tk[c]);
  out[bwd] = wadd(wadd(ik[bwd], (T)(has_primary ? 1 : 0)), above);
  out[2] = sizes[c];
}

// W extensions of one lane over the 3-bit codes of window word wv; the
// state after column j goes to column j of ck / cl / cs.  Returns the
// number of steps taken (ln).
template <typename T>
FM_HD int chain_walk(const Fm<T>& fm, long long wv, int W, T k, T l, T s,
                     bool alive, bool is_back, const T* stop_s, T* ck, T* cl,
                     T* cs) {
  int ln = 0;
  for (int j = 0; j < W; ++j) {
    const int base = (int)((wv >> (3 * j)) & 7);
    const bool step = alive && base <= 3;
    if (step) {
      const T ik[3] = {k, l, s};
      T o[3];
      extend_sel(fm, ik, is_back ? base : 3 - base, is_back, o);
      k = o[0];
      l = o[1];
      s = o[2];
      ++ln;
    }
    ck[j] = k;
    cl[j] = l;
    cs[j] = s;
    alive = step && (stop_s == nullptr || s >= *stop_s);
  }
  return ln;
}

// One LF step (bwt_invPsi; ops/fm.py::inv_psi_batch): the row at
// x = k - (k > primary) serves both the base and its rank.
template <typename T>
FM_HD T inv_psi(const Fm<T>& fm, T k) {
  const T x = (long long)k > fm.primary ? wsub(k, (T)1) : k;
  Row r;
  fetch_row(fm, (long long)x, r);
  const int off = (int)((long long)x & 127);
  const int w = off >> 5, b = off & 31;
  const int c = (int)((((r.hi[w] >> b) & 1u) << 1) | ((r.lo[w] >> b) & 1u));
  T occ[4];
  rank4(r, off, occ);
  return (long long)k == fm.primary ? (T)0 : wadd(fm.L2[c], occ[c]);
}

// Up to n masked steps of one lane (ops/fm.py::_walk_plain).
template <typename T>
FM_HD void inv_psi_walk(const Fm<T>& fm, T& kk, T& steps, bool& alive,
                        int n_steps, long long mask) {
  for (int i = 0; i < n_steps && alive; ++i) {
    kk = inv_psi(fm, kk);
    steps = wadd(steps, (T)1);
    alive = ((long long)kk & mask) != 0;
  }
}

template <typename T>
FM_HD Fm<T> make_fm(const long long* occ, long long n_rows, const T* L2,
                    long long primary, int fill_oob) {
  Fm<T> fm;
  fm.occ = occ;
  fm.n_rows = n_rows;
  for (int i = 0; i < 5; ++i) fm.L2[i] = L2[i];
  fm.primary = primary;
  fm.fill_oob = fill_oob != 0;
  return fm;
}

#ifdef __CUDACC__
constexpr int kThreads = 256;

template <typename T>
__global__ void fm_extend_sel_kernel(const long long* __restrict__ occ,
                                     long long n_rows,
                                     const T* __restrict__ L2,
                                     long long primary, int fill_oob,
                                     const T* __restrict__ ik,
                                     const int* __restrict__ c, int is_back,
                                     T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fm<T> fm = make_fm(occ, n_rows, L2, primary, fill_oob);
  const T in[3] = {ik[3 * i], ik[3 * i + 1], ik[3 * i + 2]};
  T o[3];
  extend_sel(fm, in, c[i], is_back != 0, o);
  out[3 * i] = o[0];
  out[3 * i + 1] = o[1];
  out[3 * i + 2] = o[2];
}

template <typename T>
__global__ void fm_chain_walk_kernel(
    const long long* __restrict__ occ, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const long long* __restrict__ wv, const T* __restrict__ k,
    const T* __restrict__ l, const T* __restrict__ s,
    const uint8_t* __restrict__ valid, const T* __restrict__ stop_s,
    int is_back, int W, T* __restrict__ ck, T* __restrict__ cl,
    T* __restrict__ cs, int* __restrict__ ln, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fm<T> fm = make_fm(occ, n_rows, L2, primary, fill_oob);
  const size_t o = (size_t)i * W;
  ln[i] = chain_walk(fm, wv[i], W, k[i], l[i], s[i], valid[i] != 0,
                     is_back != 0, stop_s ? stop_s + i : nullptr, ck + o,
                     cl + o, cs + o);
}

template <typename T>
__global__ void fm_inv_psi_walk_kernel(
    const long long* __restrict__ occ, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const T* __restrict__ kk, const T* __restrict__ steps,
    const uint8_t* __restrict__ alive, int n_steps, long long mask,
    T* __restrict__ kk_out, T* __restrict__ steps_out,
    uint8_t* __restrict__ alive_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fm<T> fm = make_fm(occ, n_rows, L2, primary, fill_oob);
  T k = kk[i], st = steps[i];
  bool a = alive[i] != 0;
  inv_psi_walk(fm, k, st, a, n_steps, mask);
  kk_out[i] = k;
  steps_out[i] = st;
  alive_out[i] = a ? 1 : 0;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_extend_sel(const long long* occ, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const void* ik,
                      const int* c, int is_back, void* out, long long n,
                      void* stream) {
  fm_extend_sel_kernel<T><<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      occ, n_rows, (const T*)L2, primary, fill_oob, (const T*)ik, c, is_back,
      (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain_walk(const long long* occ, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const long long* wv,
                      const void* k, const void* l, const void* s,
                      const uint8_t* valid, const void* stop_s, int is_back,
                      int W, void* ck, void* cl, void* cs, int* ln,
                      long long n, void* stream) {
  fm_chain_walk_kernel<T><<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      occ, n_rows, (const T*)L2, primary, fill_oob, wv, (const T*)k,
      (const T*)l, (const T*)s, valid, (const T*)stop_s, is_back, W, (T*)ck,
      (T*)cl, (T*)cs, ln, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv_psi_walk(const long long* occ, long long n_rows, const void* L2,
                        long long primary, int fill_oob, const void* kk,
                        const void* steps, const uint8_t* alive, int n_steps,
                        long long mask, void* kk_out, void* steps_out,
                        uint8_t* alive_out, long long n, void* stream) {
  fm_inv_psi_walk_kernel<T><<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
      occ, n_rows, (const T*)L2, primary, fill_oob, (const T*)kk,
      (const T*)steps, alive, n_steps, mask, (T*)kk_out, (T*)steps_out,
      alive_out, n);
  return (int)cudaGetLastError();
}
#else
// The host loops run the lane routines lane by lane; a lane that would
// trap on the card makes the call return -1.
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
int host_extend_sel(const long long* occ, long long n_rows, const void* L2,
                    long long primary, int fill_oob, const void* ik,
                    const int* c, int is_back, void* out, long long n) {
  const Fm<T> fm = make_fm(occ, n_rows, (const T*)L2, primary, fill_oob);
  const T* in = (const T*)ik;
  T* o = (T*)out;
  return host_lanes(n, [&](long long i) {
    extend_sel(fm, in + 3 * i, c[i], is_back != 0, o + 3 * i);
  });
}

template <typename T>
int host_chain_walk(const long long* occ, long long n_rows, const void* L2,
                    long long primary, int fill_oob, const long long* wv,
                    const void* k, const void* l, const void* s,
                    const uint8_t* valid, const void* stop_s, int is_back,
                    int W, void* ck, void* cl, void* cs, int* ln,
                    long long n) {
  const Fm<T> fm = make_fm(occ, n_rows, (const T*)L2, primary, fill_oob);
  const T* stop = (const T*)stop_s;
  return host_lanes(n, [&](long long i) {
    const size_t o = (size_t)i * W;
    ln[i] = chain_walk(fm, wv[i], W, ((const T*)k)[i], ((const T*)l)[i],
                       ((const T*)s)[i], valid[i] != 0, is_back != 0,
                       stop ? stop + i : nullptr, (T*)ck + o, (T*)cl + o,
                       (T*)cs + o);
  });
}

template <typename T>
int host_inv_psi_walk(const long long* occ, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const void* kk,
                      const void* steps, const uint8_t* alive, int n_steps,
                      long long mask, void* kk_out, void* steps_out,
                      uint8_t* alive_out, long long n) {
  const Fm<T> fm = make_fm(occ, n_rows, (const T*)L2, primary, fill_oob);
  return host_lanes(n, [&](long long i) {
    T k = ((const T*)kk)[i], st = ((const T*)steps)[i];
    bool a = alive[i] != 0;
    inv_psi_walk(fm, k, st, a, n_steps, mask);
    ((T*)kk_out)[i] = k;
    ((T*)steps_out)[i] = st;
    alive_out[i] = a ? 1 : 0;
  });
}
#endif

}  // namespace

// Every entry takes the index as (occ rows, row count, L2 pointer in the
// index type, primary, fill_oob) and idx64 = 1 for an int64_t index type,
// 0 for int32_t.  Lane arrays are contiguous: ik / out (n, 3), c (n,)
// int32, wv (n,) int64 window words, valid / alive one byte a lane, ck /
// cl / cs (n, W), stop_s null or (n,).
#ifdef __CUDACC__
extern "C" int fm_extend_sel_launch(const long long* occ, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const void* ik,
                                    const int* c, int is_back, void* out,
                                    long long n, int idx64, void* stream) {
  if (n <= 0) return 0;
  return idx64 ? launch_extend_sel<int64_t>(occ, n_rows, L2, primary,
                                            fill_oob, ik, c, is_back, out, n,
                                            stream)
               : launch_extend_sel<int32_t>(occ, n_rows, L2, primary,
                                            fill_oob, ik, c, is_back, out, n,
                                            stream);
}

extern "C" int fm_chain_walk_launch(const long long* occ, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const long long* wv,
                                    const void* k, const void* l,
                                    const void* s, const uint8_t* valid,
                                    const void* stop_s, int is_back, int W,
                                    void* ck, void* cl, void* cs, int* ln,
                                    long long n, int idx64, void* stream) {
  if (n <= 0) return 0;
  if (W < 1 || W > 10) return (int)cudaErrorInvalidValue;
  return idx64 ? launch_chain_walk<int64_t>(occ, n_rows, L2, primary,
                                            fill_oob, wv, k, l, s, valid,
                                            stop_s, is_back, W, ck, cl, cs,
                                            ln, n, stream)
               : launch_chain_walk<int32_t>(occ, n_rows, L2, primary,
                                            fill_oob, wv, k, l, s, valid,
                                            stop_s, is_back, W, ck, cl, cs,
                                            ln, n, stream);
}

extern "C" int fm_inv_psi_walk_launch(const long long* occ, long long n_rows,
                                      const void* L2, long long primary,
                                      int fill_oob, const void* kk,
                                      const void* steps, const uint8_t* alive,
                                      int n_steps, long long mask,
                                      void* kk_out, void* steps_out,
                                      uint8_t* alive_out, long long n,
                                      int idx64, void* stream) {
  if (n <= 0) return 0;
  return idx64 ? launch_inv_psi_walk<int64_t>(occ, n_rows, L2, primary,
                                              fill_oob, kk, steps, alive,
                                              n_steps, mask, kk_out,
                                              steps_out, alive_out, n, stream)
               : launch_inv_psi_walk<int32_t>(occ, n_rows, L2, primary,
                                              fill_oob, kk, steps, alive,
                                              n_steps, mask, kk_out,
                                              steps_out, alive_out, n, stream);
}

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* fm_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same lanes on the host; each returns 0, or -1 where a lane would
// trap on the card.
extern "C" int fm_extend_sel_host(const long long* occ, long long n_rows,
                                  const void* L2, long long primary,
                                  int fill_oob, const void* ik, const int* c,
                                  int is_back, void* out, long long n,
                                  int idx64) {
  return idx64 ? host_extend_sel<int64_t>(occ, n_rows, L2, primary, fill_oob,
                                          ik, c, is_back, out, n)
               : host_extend_sel<int32_t>(occ, n_rows, L2, primary, fill_oob,
                                          ik, c, is_back, out, n);
}

extern "C" int fm_chain_walk_host(const long long* occ, long long n_rows,
                                  const void* L2, long long primary,
                                  int fill_oob, const long long* wv,
                                  const void* k, const void* l, const void* s,
                                  const uint8_t* valid, const void* stop_s,
                                  int is_back, int W, void* ck, void* cl,
                                  void* cs, int* ln, long long n, int idx64) {
  if (W < 1 || W > 10) return -1;
  return idx64 ? host_chain_walk<int64_t>(occ, n_rows, L2, primary, fill_oob,
                                          wv, k, l, s, valid, stop_s, is_back,
                                          W, ck, cl, cs, ln, n)
               : host_chain_walk<int32_t>(occ, n_rows, L2, primary, fill_oob,
                                          wv, k, l, s, valid, stop_s, is_back,
                                          W, ck, cl, cs, ln, n);
}

extern "C" int fm_inv_psi_walk_host(const long long* occ, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const void* kk,
                                    const void* steps, const uint8_t* alive,
                                    int n_steps, long long mask, void* kk_out,
                                    void* steps_out, uint8_t* alive_out,
                                    long long n, int idx64) {
  return idx64 ? host_inv_psi_walk<int64_t>(occ, n_rows, L2, primary,
                                            fill_oob, kk, steps, alive,
                                            n_steps, mask, kk_out, steps_out,
                                            alive_out, n)
               : host_inv_psi_walk<int32_t>(occ, n_rows, L2, primary,
                                            fill_oob, kk, steps, alive,
                                            n_steps, mask, kk_out, steps_out,
                                            alive_out, n);
}
#endif
