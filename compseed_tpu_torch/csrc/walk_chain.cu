// The round body of the backward chained walker (ops/seedscan.py::
// walk_pool_chain), the default seeding engine's backward walk.
//
// In the JAX package the round is make_body (compseed_tpu/ops/seedscan.py
// :628-721), run inside jax.lax.while_loop: XLA compiles it into a few
// fusions around one sort.  The port rendered it as some 220 PyTorch
// operations a round (the uint32 mix emulated in int64, every scatter a
// copy of its destination, four of them pool-long).  These kernels are the
// port's counterpart of XLA's fusions; the sort stays torch.sort (XLA's
// sort in the JAX package), the representatives' walk stays
// fm_chain_walk_kernel (csrc/fm_walk.cu).  One round:
//
// walk_key_kernel<T>         one thread a lane
//   Replaces JAX seedscan.py:633-645 (port seedscan.py _walk_key_plain).
//   The lane's window word (the W chars below its position, packed 3
//   bits each; all 4s before the read), the 32-bit mix of (window, k, s)
//   in native uint32 arithmetic and the sort key: mix >> 1 for a live
//   lane, INT32_MAX else.  It also counts the round (the group scan's
//   epoch), zeroes the live count and sets the group minima to T's max.
// (torch.sort of the keys, stable: the lanes in key order)
// walk_group_kernel<T>       one thread a sorted position
//   Replaces JAX :646-670 (_walk_group_plain).  Group heads over the
//   sorted lanes (a live lane whose (window, k, s) differs from its sorted
//   predecessor's, live or not), their exclusive scan in sorted order (a
//   block scan, then a decoupled look-back across blocks), each lane's
//   group index, and the first Uw heads' representatives (window, k, l, s,
//   valid) written by the head's own thread: a snapshot, since the
//   apply kernel rewrites the lanes in place.  The group minimum of
//   min_hits (the plain step's segment min over the clamped group index
//   of mh for a live lane below Uw, INT32_MAX for any other) by a
//   segmented min over each warp's run of equal groups, then one
//   atomicMin a run: a group is a contiguous run in sorted order and an
//   integer min does not depend on order, so it is exact.  The last block
//   writes n_u and n_w = min(n_u, Uw), adds n_w to ngrp, and fills the
//   representatives past n_w with lane 0 (not valid), as the plain step's
//   zero-filled rep_take leaves them.
// (fm_chain_walk_kernel on the representatives, stopping at each group's
// minimum)
// walk_apply_kernel<T>       one thread a lane (and a representative)
//   Replaces JAX :682-720 (_walk_apply_plain).  A live lane whose group is
//   walked reads the group's W chain states, re-bases l by its offset from
//   the representative's l (the snapshot), finds the first step that kills
//   it (an ambiguous char, or an interval below its min_hits) and writes
//   the state before that step and its death position to its pool row;
//   a survivor takes the chain's last state and moves W chars down.  A
//   lane of another group waits a round unchanged.  Representative j adds
//   its walk's length to calls when valid; the live count after the round
//   (warp sums, one atomic a warp) is what the host reads for liveness.
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
// microsecond at 3.35 TB/s.  What decides is latency: every lane's work
// starts with a dependent gather (rid and i, then the window; sorted
// position, then the lane).  The design keeps a round to four launches of
// its own (the walk's included), one pass over the lanes each on every SM,
// and writes the pool rows in place (the plain round copies the four
// pool-long columns at every scatter).
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
#else
#define WC_HD inline
#endif

namespace {

constexpr int kMaxW = 10;                  // a window packs into 30 bits
constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr uint32_t kMixK = 0x9E3779B9u, kMixS = 0x85EBCA6Bu,
                   kMixF = 0xC2B2AE35u;
// the words of sc
constexpr int kScNw = 0, kScNu = 1, kScLive = 2, kScEpoch = 3,
              kScTicket = 4;

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
  // n_u, live, epoch, group ticket]
  long long lb_group, sc;
  // sizes
  long long w, Uw, W, L, n_rw, GP, idx64;
  // the window word of a lane before the read (every char 4: the plain
  // version's _ALL4)
  long long all4;
};

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

// Typed views of the arguments.
template <typename T>
struct View {
  T *k, *l, *s;
  int32_t *rid, *i, *slot;
  const T* mh;
  uint8_t* alive;
  const long long* rwflat;
  int32_t* death;
  T *fk, *fl, *fs;
  int32_t* ctr;
  long long* rw;
  int32_t* key;
  const long long* order;
  int32_t* gidx;
  long long* rep_rw;
  T *rep_k, *rep_l, *rep_s;
  uint8_t* rep_valid;
  T* gmin;
  const T *ck, *cl, *cs;
  const int32_t* ln;
  unsigned long long* lb_group;
  int32_t* sc;

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

// Key: lane j's window word and sort key.
template <typename T>
WC_HD void key_lane(const View<T>& v, const Args& a, long long j) {
  const int i = v.i[j];
  long long rw = a.all4;
  if (i >= 0)
    rw = v.rwflat[clampll((long long)v.rid[j] * a.L + clampll(i, 0, a.L - 1),
                          0, a.n_rw - 1)];
  v.rw[j] = rw;
  v.key[j] = v.alive[j]
                 ? (int32_t)(walk_mix(rw, (int64_t)v.k[j], (int64_t)v.s[j]) >>
                             1)
                 : kI32Max;
}

// Whether sorted position p (lane o) heads a group: a live lane whose
// (window, k, s) differs from its sorted predecessor's, whether or not
// that one lives (position 0 always does).
template <typename T>
WC_HD bool group_head(const View<T>& v, long long p, long long o) {
  if (!v.alive[o]) return false;
  if (p == 0) return true;
  const long long q = v.order[p - 1];
  return v.rw[o] != v.rw[q] || v.k[o] != v.k[q] || v.s[o] != v.s[q];
}

// Representative j's snapshot of lane o (valid: it walks).
template <typename T>
WC_HD void rep_write(const View<T>& v, long long j, long long o,
                     bool valid) {
  v.rep_rw[j] = v.rw[o];
  v.rep_k[j] = v.k[o];
  v.rep_l[j] = v.l[o];
  v.rep_s[j] = v.s[o];
  v.rep_valid[j] = valid ? 1 : 0;
}

// Sorted position p (lane o) has group index g (the inclusive count of
// heads up to p, minus 1); a head below Uw is representative g.  Returns
// its term of its group slot's minimum: mh for a live lane below Uw,
// INT32_MAX for any other.
template <typename T>
WC_HD T group_emit(const View<T>& v, const Args& a, long long o, int g,
                   bool head) {
  v.gidx[o] = g;
  if (head && g < a.Uw) rep_write(v, g, o, true);
  return v.alive[o] && g < a.Uw ? v.mh[o] : (T)kI32Max;
}

// After the scan: n_u heads, n_w = min(n_u, Uw) representatives, ngrp
// moved on; representatives n_w.. read lane 0 and do not walk.  Thread
// `first` of `step` threads fills the pads.
template <typename T>
WC_HD void group_close(const View<T>& v, const Args& a, int n_u, int first,
                       int step) {
  const int n_w = n_u < a.Uw ? n_u : (int)a.Uw;
  if (first == 0) {
    v.sc[kScNw] = n_w;
    v.sc[kScNu] = n_u;
    v.ctr[1] += n_w;
  }
  for (long long j = n_w + first; j < a.Uw; j += step)
    rep_write(v, j, 0, false);
}

// Apply lane j: a live lane of a walked group consumes the group's chain
// and dies (its pool row written) or goes W chars on.  Returns whether
// it lives after the round.  The death test reads the chain's s column;
// the state it keeps is one column of the chain (L2-resident: the
// group's members read the same row), read once it is known.
template <typename T>
WC_HD int apply_lane(const View<T>& v, const Args& a, long long j, int n_w) {
  if (!v.alive[j]) return 0;
  const int g = v.gidx[j];
  if (g >= n_w) return 1;                 // not walked: waits a round
  const int W = (int)a.W;
  const long long grp = clampll(g, 0, a.Uw - 1);
  const T* ck = v.ck + grp * W;
  const T* cl = v.cl + grp * W;
  const T* cs = v.cs + grp * W;
  const T mh = v.mh[j];
  const int lng = v.ln[grp];
  uint32_t die = 0;
  for (int c = 0; c < W; ++c) {
    const bool real = c < lng;
    const bool amb = c == lng && lng < W;
    die |= (uint32_t)(amb || (real && cs[c] < mh)) << c;
  }
  // l re-bases by the lane's offset from the representative's l
  const T dl = wsub(v.l[j], v.rep_l[grp]);
  if (die) {
    // the state at the death is the state before the killing step
    const int dj = low_bit(die);
    T dK = v.k[j], dL = v.l[j], dS = v.s[j];
    if (dj > 0) {
      dK = ck[dj - 1];
      dL = wadd(cl[dj - 1], dl);
      dS = cs[dj - 1];
    }
    const long long slot = v.slot[j];
    if (slot >= 0 && slot < a.GP) {
      v.death[slot] = v.i[j] - dj;
      v.fk[slot] = dK;
      v.fl[slot] = dL;
      v.fs[slot] = dS;
    }
    v.alive[j] = 0;
    return 0;
  }
  v.k[j] = ck[W - 1];
  v.l[j] = wadd(cl[W - 1], dl);
  v.s[j] = cs[W - 1];
  v.i[j] -= W;
  return 1;
}

// Representative j's extensions for calls (its walk's length when valid).
template <typename T>
WC_HD int rep_calls(const View<T>& v, long long j) {
  return v.rep_valid[j] ? v.ln[j] : 0;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// The kernels.
constexpr int kBlock = 256;            // every kernel: a lane a thread
constexpr int kWarps = kBlock / 32;
using lookback::block_excl_scan;
using lookback::look_back;
using lookback::take_ticket;
using lookback::warp_add;

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

template <typename T>
__global__ void __launch_bounds__(kBlock) walk_key_kernel(const Args a) {
  const View<T> v(a);
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j == 0) {
    v.sc[kScEpoch] += 1;                        // a new round: its epoch
    v.sc[kScLive] = 0;
  }
  if (j < a.Uw) v.gmin[j] = max_of<T>();
  if (j < a.w) key_lane(v, a, j);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) walk_group_kernel(const Args a) {
  __shared__ int tot[kWarps + 1];
  __shared__ int ticket_s, prefix_s;
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kBlock - 1) / kBlock);
  const unsigned epoch = (unsigned)v.sc[kScEpoch];
  const int t = take_ticket(v.sc + kScTicket, n_blocks, &ticket_s);
  const long long p = (long long)t * kBlock + threadIdx.x;
  long long o = 0;
  bool h = false;
  if (p < a.w) {
    o = v.order[p];
    h = group_head(v, p, o);
  }
  int total;
  const int ex = block_excl_scan<kWarps>(h, tot, &total);
  const int prefix = look_back(v.lb_group, t, total, epoch, &prefix_s);
  T term = max_of<T>();
  long long slot = a.Uw;                        // no slot
  if (p < a.w) {
    const int g = prefix + ex + h - 1;
    term = group_emit(v, a, o, g, h);
    slot = clampll(g, 0, a.Uw - 1);
  }
  warp_run_min(v.gmin, slot, term, a.Uw);
  if (t == n_blocks - 1) group_close(v, a, prefix + total, threadIdx.x,
                                     kBlock);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) walk_apply_kernel(const Args a) {
  const View<T> v(a);
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int n_w = v.sc[kScNw];
  const int calls = j < a.Uw ? rep_calls(v, j) : 0;
  const int live = j < a.w ? apply_lane(v, a, j, n_w) : 0;
  warp_add(v.ctr + 0, calls);
  warp_add(v.sc + kScLive, live);
}

long long blocks_for(long long n) { return (n + kBlock - 1) / kBlock; }

template <typename T>
int launch(int which, const Args& a, cudaStream_t st) {
  const long long wide = blocks_for(a.w > a.Uw ? a.w : a.Uw);
  switch (which) {
    case 0:
      walk_key_kernel<T><<<wide, kBlock, 0, st>>>(a);
      break;
    case 1:
      walk_group_kernel<T><<<blocks_for(a.w), kBlock, 0, st>>>(a);
      break;
    default:
      walk_apply_kernel<T><<<wide, kBlock, 0, st>>>(a);
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
  for (long long j = 0; j < a.Uw; ++j) v.gmin[j] = max_of<T>();
  for (long long j = 0; j < a.w; ++j) key_lane(v, a, j);
}

template <typename T>
void host_group(const Args& a) {
  const View<T> v(a);
  int g = -1;
  for (long long p = 0; p < a.w; ++p) {
    const long long o = v.order[p];
    const bool h = group_head(v, p, o);
    g += h;
    const T term = group_emit(v, a, o, g, h);
    T* m = v.gmin + clampll(g, 0, a.Uw - 1);
    if (term < *m) *m = term;
  }
  group_close(v, a, g + 1, 0, 1);
}

template <typename T>
void host_apply(const Args& a) {
  const View<T> v(a);
  const int n_w = v.sc[kScNw];
  int calls = 0, live = 0;
  for (long long j = 0; j < a.Uw; ++j) calls += rep_calls(v, j);
  for (long long j = 0; j < a.w; ++j) live += apply_lane(v, a, j, n_w);
  v.ctr[0] += calls;
  v.sc[kScLive] += live;
}

int host_any(int which, const long long* words) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.w >= INT32_MAX ||
      a.Uw >= INT32_MAX || a.n_rw < 1)
    return -1;
  const bool i64 = a.idx64 != 0;
  switch (which) {
    case 0:
      i64 ? host_key<int64_t>(a) : host_key<int32_t>(a);
      break;
    case 1:
      i64 ? host_group<int64_t>(a) : host_group<int32_t>(a);
      break;
    default:
      i64 ? host_apply<int64_t>(a) : host_apply<int32_t>(a);
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

// walk_mix for n keys (window words, k and s sign-extended to int64).
extern "C" void walk_mix_host(const long long* rw, const long long* k,
                              const long long* s, long long n,
                              long long* out) {
  for (long long j = 0; j < n; ++j) out[j] = walk_mix(rw[j], k[j], s[j]);
}
#endif

// The size of Args in words, to check the Python layout against.
extern "C" int walk_args_words() { return (int)(sizeof(Args) / 8); }
