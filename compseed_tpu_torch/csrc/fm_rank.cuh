// The FM-index lane routines that the port's kernel sources share:
// fm_walk.cu (the extension, the chain walk, the inverse-Psi walk),
// smem_seed.cu (the exact rerun's collect and round-3 programs) and
// lockstep.cu (the lockstep engines' loops).  The
// index as a lane sees it (FmPacked, the packed 64-byte occ rows), the
// wrapping arithmetic of the index type T, a rank in a row (in one piece
// or two), occ4 at a position, the child of a bi-interval and the
// one-child extension; the ranks of an extension by a pair of threads
// (PairRanks, on the card) or by one, its two rows one after the other
// (ThreadRanks) or both rows' reads issued before either is ranked
// (ThreadRowRanks over row_read / row_pc: lockstep.cu's walk segment and
// smem_seed.cu's round-3 scan).  fm_walk.cu's header comment says how
// they read the table and why.
//
// Compiled by nvcc, the routines are __host__ __device__; compiled as C++
// without nvcc (the host twins of the CPU tests), plain inline functions.

#pragma once

#include <cstdint>
#include <cstdlib>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FM_HD __host__ __device__ __forceinline__
#define FM_UNROLL _Pragma("unroll")
#define FM_FUNCTOR_CALLER _Pragma("nv_exec_check_disable")
#else
#define FM_HD inline
#define FM_UNROLL
#define FM_FUNCTOR_CALLER
#endif

namespace {

constexpr int kPackedWords = 16;

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

// a[c] for c in [0, 3] by selects, so that a stays in registers.
template <typename T>
FM_HD T sel4(const T a[4], int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
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

// The index as a lane sees it: the (n_rows, 16) packed rows.
template <typename T>
struct FmPacked {
  const uint32_t* rows;
  long long n_rows;
  T L2[5];
  long long primary;
  bool fill_oob;
};

template <typename T>
FM_HD FmPacked<T> make_fm(const uint32_t* rows, long long n_rows, const T* L2,
                          long long primary, int fill_oob) {
  FmPacked<T> fm;
  fm.rows = rows;
  fm.n_rows = n_rows;
  for (int i = 0; i < 5; ++i) fm.L2[i] = L2[i];
  fm.primary = primary;
  fm.fill_oob = fill_oob != 0;
  return fm;
}

// The table row of the 128-base block holding (already $-adjusted) k:
// its index in [0, n), or -1 for fill_oob's all-ones row.
FM_HD long long row_of(long long n, bool fill_oob, long long k) {
  const long long blk = k >> 7;
  if (blk >= -n && blk < n) return blk < 0 ? blk + n : blk;
  if (!fill_oob) fault();
  return -1;
}

// The child c of bi-interval ik = (k, l, s) from occ4 at x - 1 (tk) and
// x - 1 + s (tl), x = ik[fwd]: columns [fwd] the searched coordinate,
// [bwd] the other one, [2] the size (ops/fm.py::_extend_sel_plain).
// (The columns are chosen by selects, not by index, so that they stay
// in registers.)
template <typename T>
FM_HD void child_of(const FmPacked<T>& fm, const T ik[3], int c,
                    bool is_back, const T tk[4], const T tl[4], T out[3]) {
  const T x = is_back ? ik[0] : ik[1], y = is_back ? ik[1] : ik[0];
  const T s = ik[2];
  T sizes[4];
  for (int b = 0; b < 4; ++b) sizes[b] = wsub(tl[b], tk[b]);
  const bool has_primary = (long long)x <= fm.primary &&
                           (long long)wsub(wadd(x, s), (T)1) >= fm.primary;
  T above = 0;
  for (int b = 1; b < 4; ++b)
    if (b > c) above = wadd(above, sizes[b]);
  const T f = wadd(wadd(sel4(fm.L2, c), (T)1), sel4(tk, c));
  const T g = wadd(wadd(y, (T)(has_primary ? 1 : 0)), above);
  out[0] = is_back ? f : g;
  out[1] = is_back ? g : f;
  out[2] = sel4(sizes, c);
}

// ---------------------------------------------------------------------------
// Ranks in the packed rows.  A rank in a row is one piece, which holds
// both plane quarters (1 and 2), or two, piece p holding quarter 1 + p;
// quarter 0, the checkpoint counts, is read beside them.

struct Quarter {
  uint32_t w[4];
};

// Quarter q of packed row i (-1: fill_oob's all-ones row).
FM_HD Quarter load_quarter(const uint32_t* rows, long long i, int q) {
  Quarter v;
  if (i < 0) {
    v.w[0] = v.w[1] = v.w[2] = v.w[3] = 0xFFFFFFFFu;
    return v;
  }
  const uint32_t* p = rows + i * kPackedWords + 4 * q;
#ifdef __CUDA_ARCH__
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  v.w[0] = x.x;
  v.w[1] = x.y;
  v.w[2] = x.z;
  v.w[3] = x.w;
#else
  for (int j = 0; j < 4; ++j) v.w[j] = p[j];
#endif
  return v;
}

// Popcounts by base of plane word w's positions 0..off of the block,
// added to pc (base b in bits 8b..8b+7; a rank counts at most 128).
FM_HD void plane_popc(uint32_t hi, uint32_t lo, int w, int off,
                      uint32_t& pc) {
  const int nb = off - 32 * w + 1;
  if (nb <= 0) return;
  const uint32_t mask = nb >= 32 ? 0xFFFFFFFFu : ((1u << nb) - 1u);
  const uint32_t hm = hi & mask, lm = lo & mask;
  const uint32_t nh = ~hm & mask, nl = ~lm & mask;
  pc += (uint32_t)popc(nh & nl) | ((uint32_t)popc(nh & lm) << 8) |
        ((uint32_t)popc(hm & nl) << 16) | ((uint32_t)popc(hm & lm) << 24);
}

// Piece `piece` of `pieces` (1 or 2) of the rank at block offset `off` in
// packed row i: the popcounts by base of the plane words it holds (packed
// as plane_popc packs them), and in *code the 2-bit BWT code at off where
// the piece holds that word, else 0.  The pieces of a row add up to the
// rank and the code.  Quarter 2 is read only for offsets 64-127.  (The
// bounds are written as quarters [4p / pieces, 4(p + 1) / pieces) clipped
// to the planes: other forms of the same bounds made nvcc give the chain
// walk more registers and cost it 15-30 % on the H100, PERF.md.)
FM_HD uint32_t rank_piece(const uint32_t* rows, long long i, int piece,
                          int pieces, int off, int* code) {
  uint32_t pc = 0;
  *code = 0;
  const int q0 = 4 * piece / pieces, q1 = 4 * (piece + 1) / pieces;
  const int wc = off >> 5, bc = off & 31;
  for (int q = q0 < 1 ? 1 : q0; q < (q1 > 3 ? 3 : q1); ++q) {
    if (off < 64 * (q - 1)) break;
    const Quarter v = load_quarter(rows, i, q);
    for (int h = 0; h < 2; ++h) {
      const int w = 2 * (q - 1) + h;
      plane_popc(v.w[2 * h], v.w[2 * h + 1], w, off, pc);
      if (w == wc)
        *code = (int)((((v.w[2 * h] >> bc) & 1u) << 1) |
                      ((v.w[2 * h + 1] >> bc) & 1u));
    }
  }
  return pc;
}

// The rank of base b from the row's count and the pieces' summed
// popcounts, in T (as ops/fm.py::_rank4 adds them).
template <typename T>
FM_HD T rank_of(uint32_t cnt, uint32_t pc, int b) {
  using U = typename Unsigned<T>::type;
  return wadd((T)(U)cnt, (T)((pc >> (8 * b)) & 0xFFu));
}

// Where occ4 at k ranks (bwt_occ4): false for k == -1, which counts zero;
// else the row (row_of) and the block offset of k - (k >= primary).
template <typename T>
FM_HD bool occ_at(const FmPacked<T>& fm, T k, long long& row, int& off) {
  if (k == (T)-1) return false;
  const T kk = (long long)k >= fm.primary ? wsub(k, (T)1) : k;
  row = row_of(fm.n_rows, fm.fill_oob, (long long)kk);
  off = (int)((long long)kk & 127);
  return true;
}

// occ4 at k by one thread: the row's counts (quarter 0) and its
// popcounts, the rank in one piece; zero for k == -1.
template <typename T>
FM_HD void occ_row(const FmPacked<T>& fm, T k, uint32_t cnt[4],
                   uint32_t& pc) {
  long long row;
  int off, code;
  cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
  pc = 0;
  if (!occ_at(fm, k, row, off)) return;
  const Quarter c = load_quarter(fm.rows, row, 0);
  for (int j = 0; j < 4; ++j) cnt[j] = c.w[j];
  pc = rank_piece(fm.rows, row, 0, 1, off, &code);
}

// The one-child extension of ik = (k, l, s) by base c (ops/fm.py::
// extend_sel_batch): occ4 at x - 1 and x - 1 + s, x = ik[is_back ? 0 : 1],
// by ranks(a, b, tk, tl), then child_of.  A child outside [0, 3] faults
// before anything is read.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks>
FM_HD void extend_sel(const FmPacked<T>& fm, const T ik[3], int c,
                      bool is_back, T out[3], const Ranks& ranks) {
  if (c < 0 || c > 3) {
    fault();
    return;
  }
  const T xm1 = wsub(is_back ? ik[0] : ik[1], (T)1);
  T tk[4], tl[4];
  ranks(xm1, wadd(xm1, ik[2]), tk, tl);
  child_of(fm, ik, c, is_back, tk, tl, out);
}

#ifdef __CUDACC__
// The pair of threads of this thread's lane (every kernel): its index t in
// the pair, the pair's mask within the warp, and the other thread's v.
struct Pair {
  int t;
  unsigned mask;
  __device__ Pair()
      : t((int)(threadIdx.x & 1)), mask(3u << (threadIdx.x & 30)) {}
  __device__ uint32_t other(uint32_t v) const {
    return __shfl_xor_sync(mask, v, 1);
  }
};

// ranks(a, b, tk, tl) of an extension or a chain-walk lane: thread 0 of
// the pair ranks at a, thread 1 at b, and the two swap their counts and
// popcounts.
template <typename T>
struct PairRanks {
  const FmPacked<T>& fm;
  Pair p;
  __device__ void operator()(T a, T b, T tk[4], T tl[4]) const {
    const bool second = p.t == 1;
    uint32_t cnt[4], pc, other[4];
    occ_row(fm, second ? b : a, cnt, pc);
    const uint32_t pco = p.other(pc);
    for (int j = 0; j < 4; ++j) other[j] = p.other(cnt[j]);
    for (int j = 0; j < 4; ++j) {
      const T mine = rank_of<T>(cnt[j], pc, j);
      const T theirs = rank_of<T>(other[j], pco, j);
      tk[j] = second ? theirs : mine;
      tl[j] = second ? mine : theirs;
    }
  }
};
#endif

// ranks(a, b, tk, tl) by one thread: both rows one after the other (the
// host loops' ranks, and a card thread that extends a lane of its own).
template <typename T>
struct ThreadRanks {
  const FmPacked<T>& fm;
  FM_HD void operator()(T a, T b, T tk[4], T tl[4]) const {
    uint32_t cnt[4], pc;
    occ_row(fm, a, cnt, pc);
    for (int j = 0; j < 4; ++j) tk[j] = rank_of<T>(cnt[j], pc, j);
    occ_row(fm, b, cnt, pc);
    for (int j = 0; j < 4; ++j) tl[j] = rank_of<T>(cnt[j], pc, j);
  }
};

// occ4 at k by one thread as its reads and its ranks apart (occ_row's
// result, ThreadRanks' row): row_read issues the reads of the row's counts
// and of the plane quarters the rank needs (the second only for block
// offsets 64-127), row_pc adds the popcounts up once they are in, so that
// a thread can have the reads of several rows in flight.
struct RowRead {
  Quarter c, v1, v2;
  int off;
  bool zero;  // k == -1: occ4 counts zero
};

template <typename T>
FM_HD RowRead row_read(const FmPacked<T>& fm, T k) {
  RowRead r;
  long long row;
  r.zero = !occ_at(fm, k, row, r.off);
  if (r.zero) return r;
  r.c = load_quarter(fm.rows, row, 0);
  r.v1 = load_quarter(fm.rows, row, 1);
  if (r.off >= 64) r.v2 = load_quarter(fm.rows, row, 2);
  return r;
}

// The row's counts (cnt) and popcounts by base (rank_piece's packing) of
// a row_read.
FM_HD uint32_t row_pc(const RowRead& r, uint32_t cnt[4]) {
  uint32_t pc = 0;
  for (int j = 0; j < 4; ++j) cnt[j] = r.zero ? 0u : r.c.w[j];
  if (r.zero) return 0;
  plane_popc(r.v1.w[0], r.v1.w[1], 0, r.off, pc);
  plane_popc(r.v1.w[2], r.v1.w[3], 1, r.off, pc);
  if (r.off >= 64) {
    plane_popc(r.v2.w[0], r.v2.w[1], 2, r.off, pc);
    plane_popc(r.v2.w[2], r.v2.w[3], 3, r.off, pc);
  }
  return pc;
}

// The ranks of extend_sel by one thread a lane: both rows' reads issued
// before either is ranked, so that a step's two random reads are in
// flight together.
template <typename T>
struct ThreadRowRanks {
  const FmPacked<T>& fm;
  FM_HD void operator()(T a, T b, T tk[4], T tl[4]) const {
    const RowRead ra = row_read(fm, a), rb = row_read(fm, b);
    uint32_t c[4];
    uint32_t pc = row_pc(ra, c);
    for (int j = 0; j < 4; ++j) tk[j] = rank_of<T>(c[j], pc, j);
    pc = row_pc(rb, c);
    for (int j = 0; j < 4; ++j) tl[j] = rank_of<T>(c[j], pc, j);
  }
};

}  // namespace
