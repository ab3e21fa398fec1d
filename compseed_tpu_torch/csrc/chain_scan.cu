// The round body of the forward chain-memo scan (ops/seedscan.py::
// chain_scan), the default seeding engine's forward loop.
//
// In the JAX package the round is make_body (compseed_tpu/ops/seedscan.py
// :1494-1690), run inside jax.lax.while_loop: XLA compiles it into a few
// fusions around one sort and three scans, and carries the memo in place.
// The port rendered it as some 390 PyTorch operations a round (the uint64
// slot hash emulated in int64, every scatter a copy of its destination).
// These kernels are the port's counterpart of XLA's fusions; the sort stays
// torch.sort (XLA's sort in the JAX package), the representatives' walk
// stays fm_chain_walk_kernel (csrc/fm_walk.cu).  One round:
//
// chain_probe_kernel<T>      one thread a lane
//   Replaces JAX seedscan.py:1495-1520 (port seedscan.py
//   _chain_probe_plain).  The lane's W-char window from winflat, the
//   slot hash in native uint64 arithmetic, one table row [window, l0,
//   s0, k0, len, ptr, valid, pad] (make_chain_memo) read as 16-byte
//   loads; writes hit, ptr (clamped to [0, M - 1]), k0, len, the window
//   and slot, and the sort key: the slot for a live miss, H else.
// (torch.sort of the keys, stable: the lanes in slot order)
// chain_group_kernel<T>      one thread a sorted position
//   Replaces JAX :1521-1563 (_chain_group_plain).  Group heads over the
//   sorted lanes (a live miss whose (window, l, s) differs from its
//   sorted predecessor's), their exclusive scan in sorted order (a
//   block scan, then a decoupled look-back across blocks), each lane's
//   group index, and the first Uw heads' representatives (window, k,
//   l, s, valid, slot) written by the head's own thread; the last block
//   writes n_u, n_w = min(n_u, Uw), the store cursor's old value and its
//   advance, and fills the representatives past n_w with lane 0, as the
//   plain version's zero-filled rep_take leaves them (not valid).
//   Launched once per round, it also counts the round (the epoch).
// (fm_chain_walk_kernel on the representatives)
// chain_apply_kernel<T>      one thread a lane (and a representative)
//   Replaces JAX :1564-1688 (_chain_apply_plain).
//   Insert: representative j < n_w appends its chain at row cur0 + j
//   while that is < M, and writes the table slot when it is the first
//   representative of its slot (the representatives arrive in slot
//   order).  Apply: a lane's chain comes from its store row (a hit) or
//   its group's walk, k re-based by k - k0 in T; then the LEP or round-3
//   push / stop rule, the fq and fc sums and the live count (warp sums,
//   one atomic a warp), and the advance or respawn.  Flush: the lanes'
//   push counts are scanned in lane order (a block scan and the same
//   look-back), and each lane writes its pushes to the six pool columns
//   at cursor + rank (rows past GP dropped): the plain version's (lane,
//   j) row-major order exactly; the last block moves cursor and povf.
//   A hit reads a store row written in an earlier round (rows below
//   cur0) while this round's inserts write rows from cur0 on, so the two
//   never meet.
//
// The look-back (Merrill and Garland's single-pass scan, lookback.cuh):
// blocks take tickets in the order they start, publish their sum, then
// add the sums of the blocks before them until one that has published
// its inclusive prefix; a status word holds the round's epoch (the probe
// kernel counts rounds), a flag and the value, so the words need no
// reset between rounds.
//
// T is the index type, int32_t or int64_t (fm.dtype): the table, the
// store, the pool and the lane intervals are T, and interval arithmetic
// wraps in T as the plain version's tensors do.
//
// What bounds them on Hopper.  A round moves little: per live lane one
// table row (32 B int32, 64 B int64), its window word and its state, per
// hit one store row (3W words), per push six pool words; a few hundred
// kB to a few MB, well under a microsecond at 3.35 TB/s.  What decides is
// latency: every lane's work starts with a dependent gather (window, then
// table row; sorted position, then the lane's key).  The design keeps a
// round to four launches of its own (the walk's included), one pass over
// the lanes each on every SM, with no copy of the memo or the pool.  (The
// first form, whose grouping and flush ran their scans in one block of
// 1,024 threads, spent 0.08 and 0.18 ms a full-width round in those two
// on the H100: PERF.md.)
//
// The launchers take the arguments as one array of 64-bit words, the
// struct Args below (ops/chain_cuda.py::ARGS names them in order); they
// allocate nothing, launch on the caller's stream of the calling thread's
// current device and return the CUDA error code.  Built with nvcc for
// sm_90a into a shared library with a plain C interface.  Compiled as C++
// without nvcc, the same lane routines run in host loops (chain_*_host),
// so that the CPU tests hold their arithmetic to the plain version.

#include <cstddef>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "lookback.cuh"
#define CS_HD __host__ __device__ __forceinline__
#define CS_UNROLL _Pragma("unroll")
#else
#define CS_HD inline
#define CS_UNROLL
#endif

namespace {

constexpr int kMaxW = 10;                  // a window packs into 30 bits
constexpr int kPoolCols = 6;               // k, l, s, end, pivot, row
constexpr uint64_t kMx1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMx2 = 0x94D049BB133111EBull;

// The launch arguments, one 64-bit word each (pointers as addresses).
struct Args {
  // lane state (w lanes), updated in place by the apply kernel
  long long lane0, pivot, pos, alive, k, l, s;
  // per-call constants: by original lane, by read, the index's L2
  long long lane_rid0, lane_rlen0, mh0, row_id0, winflat, nxt, qflat, L2;
  // the memo (table, store, store cursor), the pool (6 x GP) and the
  // counters [fq, fc, cursor, povf]
  long long tbl, cst, cur, pool, ctr;
  // probe outputs (w), sort keys and order (w)
  long long p_wv, p_slot, p_hit, p_ptr, p_hk0, p_hln, key, order;
  // group outputs: group index by lane (w), representatives (Uw)
  long long gidx, rep_wv, rep_k, rep_l, rep_s, rep_valid, rep_slot;
  // the representatives' walk (Uw x W, Uw)
  long long ck, cl, cs, ln;
  // look-back status words of the group and apply kernels (a word a
  // block); [n_w, cur0, live, n_u, epoch, group ticket, apply ticket,
  // pool cursor at the round's start]
  long long lb_group, lb_apply, sc;
  // sizes and modes
  long long w, Uw, W, L, H, M, GP, nq, r3, advance, min_len, max_intv,
      idx64;
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
CS_HD T wadd(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a + (U)b);
}

template <typename T>
CS_HD T wsub(T a, T b) {
  using U = typename Unsigned<T>::type;
  return (T)((U)a - (U)b);
}

CS_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The index of the lowest set bit of x != 0.
CS_HD int low_bit(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

CS_HD long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The chain key's slot in [0, H): the JAX package's uint64 avalanche of
// the window word and the sign-extended l and s.
CS_HD uint64_t slot_hash(uint64_t wv, int64_t l, int64_t s, uint64_t H) {
  uint64_t z = wv ^ ((uint64_t)l * kMx1) ^ ((uint64_t)s * kMx2);
  z = (z ^ (z >> 33)) * kMx1;
  z = z ^ (z >> 29);
  return z & (H - 1);
}

// The window word as the table stores it: its low 32 bits as a signed
// int32 in an int32 table, the word itself in an int64 one.
template <typename T>
CS_HD T w_store(long long wv) {
  return sizeof(T) == 4 ? (T)(int32_t)(uint32_t)wv : (T)wv;
}

// Typed views of the arguments.
template <typename T>
struct View {
  int32_t *lane0, *pivot, *pos;
  uint8_t* alive;
  T *k, *l, *s;
  const int32_t *lane_rid0, *lane_rlen0, *row_id0, *nxt;
  const T* mh0;
  const long long* winflat;
  const uint8_t* qflat;
  const T* L2;
  T *tbl, *cst, *pool;
  int32_t *cur, *ctr;
  long long* p_wv;
  int32_t *p_slot, *p_ptr, *p_hln, *key;
  uint8_t* p_hit;
  T* p_hk0;
  const long long* order;
  int32_t *gidx, *rep_slot;
  long long* rep_wv;
  T *rep_k, *rep_l, *rep_s;
  uint8_t* rep_valid;
  const T *ck, *cl, *cs;
  const int32_t* ln;
  unsigned long long *lb_group, *lb_apply;
  int32_t* sc;

  CS_HD explicit View(const Args& a)
      : lane0((int32_t*)a.lane0),
        pivot((int32_t*)a.pivot),
        pos((int32_t*)a.pos),
        alive((uint8_t*)a.alive),
        k((T*)a.k),
        l((T*)a.l),
        s((T*)a.s),
        lane_rid0((const int32_t*)a.lane_rid0),
        lane_rlen0((const int32_t*)a.lane_rlen0),
        row_id0((const int32_t*)a.row_id0),
        nxt((const int32_t*)a.nxt),
        mh0((const T*)a.mh0),
        winflat((const long long*)a.winflat),
        qflat((const uint8_t*)a.qflat),
        L2((const T*)a.L2),
        tbl((T*)a.tbl),
        cst((T*)a.cst),
        pool((T*)a.pool),
        cur((int32_t*)a.cur),
        ctr((int32_t*)a.ctr),
        p_wv((long long*)a.p_wv),
        p_slot((int32_t*)a.p_slot),
        p_ptr((int32_t*)a.p_ptr),
        p_hln((int32_t*)a.p_hln),
        key((int32_t*)a.key),
        p_hit((uint8_t*)a.p_hit),
        p_hk0((T*)a.p_hk0),
        order((const long long*)a.order),
        gidx((int32_t*)a.gidx),
        rep_slot((int32_t*)a.rep_slot),
        rep_wv((long long*)a.rep_wv),
        rep_k((T*)a.rep_k),
        rep_l((T*)a.rep_l),
        rep_s((T*)a.rep_s),
        rep_valid((uint8_t*)a.rep_valid),
        ck((const T*)a.ck),
        cl((const T*)a.cl),
        cs((const T*)a.cs),
        ln((const int32_t*)a.ln),
        lb_group((unsigned long long*)a.lb_group),
        lb_apply((unsigned long long*)a.lb_apply),
        sc((int32_t*)a.sc) {}
};

// One table row, eight words of T (32 or 64 bytes, aligned to its size).
template <typename T>
CS_HD void load_row8(const T* row, T out[8]) {
#ifdef __CUDA_ARCH__
  const uint4* p = reinterpret_cast<const uint4*>(row);
  constexpr int kVec = 8 * sizeof(T) / 16;
  uint4 v[kVec];
  for (int q = 0; q < kVec; ++q) v[q] = p[q];
  const T* t = reinterpret_cast<const T*>(v);
  for (int j = 0; j < 8; ++j) out[j] = t[j];
#else
  for (int j = 0; j < 8; ++j) out[j] = row[j];
#endif
}

// ---------------------------------------------------------------------------
// The lane routines, shared by the kernels and the host loops.

// Probe: lane i's window, slot, table row, hit and sort key.
template <typename T>
CS_HD void probe_lane(const View<T>& v, const Args& a, long long i) {
  const long long rid = v.lane_rid0[v.lane0[i]];
  const long long pc = clampll(v.pos[i], 0, a.L + 1);
  const long long wv = v.winflat[rid * (a.L + 2) + pc];
  const T l = v.l[i], s = v.s[i];
  const long long slot =
      (long long)slot_hash((uint64_t)wv, (int64_t)l, (int64_t)s,
                           (uint64_t)a.H);
  bool hit = false;
  int ptr = 0, hln = 0;
  T hk0 = 0;
  if (v.alive[i]) {
    T row[8];
    load_row8(v.tbl + slot * 8, row);
    hit = row[6] != 0 && row[0] == w_store<T>(wv) && row[1] == l &&
          row[2] == s;
    ptr = (int)clampll((long long)row[5], 0, a.M - 1);
    hk0 = row[3];
    hln = (int)row[4];
  }
  v.p_wv[i] = wv;
  v.p_slot[i] = (int32_t)slot;
  v.p_hit[i] = hit ? 1 : 0;
  v.p_ptr[i] = ptr;
  v.p_hk0[i] = hk0;
  v.p_hln[i] = hln;
  v.key[i] = (int32_t)(v.alive[i] && !hit ? slot : a.H);
}

// Whether sorted position p (lane o) heads a group: a live miss whose
// key differs from its sorted predecessor's (position 0 always does).
template <typename T>
CS_HD bool group_head(const View<T>& v, const Args& a, long long p,
                      long long o) {
  if (v.key[o] >= a.H) return false;
  if (p == 0) return true;
  const long long q = v.order[p - 1];
  return v.p_wv[o] != v.p_wv[q] || v.l[o] != v.l[q] || v.s[o] != v.s[q];
}

// Representative j's inputs from lane o (valid: it walks).
template <typename T>
CS_HD void rep_write(const View<T>& v, long long j, long long o,
                     bool valid) {
  v.rep_wv[j] = v.p_wv[o];
  v.rep_k[j] = v.k[o];
  v.rep_l[j] = v.l[o];
  v.rep_s[j] = v.s[o];
  v.rep_valid[j] = valid ? 1 : 0;
  v.rep_slot[j] = v.p_slot[o];
}

// Sorted position p (lane o) has group index g (the inclusive count of
// heads up to p, minus 1); a head below Uw is representative g.
template <typename T>
CS_HD void group_emit(const View<T>& v, const Args& a, long long o, int g,
                      bool head) {
  v.gidx[o] = g;
  if (head && g < a.Uw) rep_write(v, g, o, true);
}

// After the scan: n_u heads, n_w = min(n_u, Uw) representatives; the
// store cursor's old value and its advance (the representatives j < n_w
// whose row cur0 + j is below M); the pool cursor as the round found it;
// representatives n_w.. read lane 0 and do not walk.  Thread `first` of
// `step` threads fills the pads.
template <typename T>
CS_HD void group_close(const View<T>& v, const Args& a, int n_u, int first,
                       int step) {
  const int n_w = n_u < a.Uw ? n_u : (int)a.Uw;
  if (first == 0) {
    const int cur0 = *v.cur;
    const long long room = a.M - cur0;
    v.sc[0] = n_w;
    v.sc[1] = cur0;
    v.sc[2] = 0;                      // the apply kernel's live count
    v.sc[3] = n_u;
    v.sc[7] = v.ctr[2];               // the pool cursor the apply starts at
    *v.cur = cur0 + (int)(room < 0 ? 0 : (room < n_w ? room : n_w));
  }
  for (long long j = n_w + first; j < a.Uw; j += step)
    rep_write(v, j, 0, false);
}

// Insert representative j: its chain to store row cur0 + j while that
// is below M (the valid representatives are the prefix j < n_w, so j is
// its rank), and its table row when it is the first of its slot.
// Returns its contribution to fc (the extensions it walked).
template <typename T>
CS_HD int insert_rep(const View<T>& v, const Args& a, long long j,
                     int cur0) {
  if (!v.rep_valid[j]) return 0;
  const int W = (int)a.W;
  const int ln = v.ln[j];
  const long long cptr = (long long)cur0 + j;
  if (cptr < a.M) {
    T* row = v.cst + cptr * 3 * W;
    for (int c = 0; c < W; ++c) {
      row[c] = v.ck[j * W + c];
      row[W + c] = v.cl[j * W + c];
      row[2 * W + c] = v.cs[j * W + c];
    }
    if (j == 0 || v.rep_slot[j] != v.rep_slot[j - 1]) {
      T* t = v.tbl + (long long)v.rep_slot[j] * 8;
      t[0] = w_store<T>(v.rep_wv[j]);
      t[1] = v.rep_l[j];
      t[2] = v.rep_s[j];
      t[3] = v.rep_k[j];
      t[4] = (T)ln;
      t[5] = (T)cptr;
      t[6] = 1;
      t[7] = 0;
    }
  }
  return ln;
}

// A lane's round: what it consumed, whether it lives on, and its pushes
// (the chain's columns and the state before the round, kept until the
// lane knows its rows in the pool).
template <typename T>
struct LaneOut {
  int fq;              // columns consumed (applied lanes)
  int alive;           // alive after the round
  uint32_t push;       // columns pushed
  T k, l, s;           // the state before the round
  int pos, pivot, row_id;
  T CK[kMaxW], CL[kMaxW], CS[kMaxW];
};

// Apply lane i: consume its chain (a store row or its group's walk),
// decide its pushes, advance or respawn.  A lane that is neither a hit
// nor walked this round keeps its state and pushes nothing.
template <typename T>
CS_HD void apply_lane(const View<T>& v, const Args& a, long long i, int n_w,
                      LaneOut<T>& out) {
  const bool lalive = v.alive[i] != 0;
  const bool hit = v.p_hit[i] != 0;
  const int g = v.gidx[i];
  const bool walked = lalive && !hit && g < n_w;
  out.fq = 0;
  out.alive = lalive ? 1 : 0;
  out.push = 0;
  if (!(hit || walked)) return;
  const int W = (int)a.W;
  const long long L = a.L;
  const long long grp = clampll(g, 0, a.Uw - 1);
  const T k = v.k[i], l = v.l[i], s = v.s[i];
  const int pos = v.pos[i], pivot = v.pivot[i];
  const long long lane0 = v.lane0[i];
  const long long rid = v.lane_rid0[lane0];
  const int rlen = v.lane_rlen0[lane0];
  const T mh = v.mh0[lane0];
  out.k = k;
  out.l = l;
  out.s = s;
  out.pos = pos;
  out.pivot = pivot;
  out.row_id = v.row_id0[lane0];

  T* CK = out.CK;
  T* CL = out.CL;
  T* CS = out.CS;
  T src_k0;
  int src_ln;
  // (the column loops run to kMaxW with a test of W, so that they unroll
  // and the columns stay in registers)
  const T* ck = v.ck + grp * W;
  const T* cl = v.cl + grp * W;
  const T* cs = v.cs + grp * W;
  if (hit) {
    ck = v.cst + (long long)v.p_ptr[i] * 3 * W;
    cl = ck + W;
    cs = ck + 2 * W;
    src_k0 = v.p_hk0[i];
    src_ln = v.p_hln[i];
  } else {
    src_k0 = v.rep_k[grp];
    src_ln = v.ln[grp];
  }
  const T dk = wsub(k, src_k0);
  CS_UNROLL
  for (int j = 0; j < kMaxW; ++j) {
    if (j < W) {
      CK[j] = wadd(ck[j], dk);
      CL[j] = cl[j];
      CS[j] = cs[j];
    }
  }

  uint32_t push = 0, stop = 0;
  CS_UNROLL
  for (int j = 0; j < kMaxW; ++j) {
    if (j >= W) break;
    const bool real = j < src_ln;
    const bool amb = j == src_ln && src_ln < W;
    bool pj, sj;
    if (a.r3) {
      const bool hj = real && (long long)CS[j] < a.max_intv &&
                      (pos + j - pivot) >= (int)a.min_len;
      pj = hj;
      sj = hj || amb;
    } else {
      const T prevs = j == 0 ? s : CS[j - 1];
      const bool changed = CS[j] != prevs;
      pj = (real && changed) || amb;
      sj = (real && changed && CS[j] < mh) || amb;
    }
    push |= (uint32_t)pj << j;
    stop |= (uint32_t)sj << j;
  }
  const bool has_stop = stop != 0;
  const int t = has_stop ? low_bit(stop) : 0;
  const int t_eff = has_stop ? t : W;
  push &= (2u << t_eff) - 1u;                   // columns 0..t_eff
  out.fq = has_stop ? t + 1 : W;

  out.push = push;

  // advance / respawn
  const int stop_pos = pos + t;
  const bool amb_stop = has_stop && t == src_ln;
  const int npv = (a.r3 || amb_stop) ? stop_pos + 1 : stop_pos;
  const int newpiv =
      npv < L ? v.nxt[rid * L + clampll(npv, 0, L - 1)] : (int)L;
  const bool respawn = a.advance && has_stop && newpiv < rlen;
  if (respawn) {
    const int base =
        v.qflat[clampll(rid * L + newpiv, 0, a.nq - 1)];
    const int c = base > 3 ? 3 : base;
    v.k[i] = wadd(v.L2[c], (T)1);
    v.l[i] = wadd(v.L2[3 - c], (T)1);
    v.s[i] = wsub(v.L2[c + 1], v.L2[c]);
    v.pivot[i] = newpiv;
    v.pos[i] = newpiv + 1;
  } else if (!has_stop) {
    const int last = (int)clampll(src_ln - 1, 0, W - 1);
    T ek = CK[0], el = CL[0], es = CS[0];
    CS_UNROLL
    for (int j = 1; j < kMaxW; ++j) {
      if (j == last) {
        ek = CK[j];
        el = CL[j];
        es = CS[j];
      }
    }
    v.k[i] = ek;
    v.l[i] = el;
    v.s[i] = es;
    v.pos[i] = pos + W;
  }
  out.alive = (respawn || !has_stop) ? 1 : 0;
  v.alive[i] = (uint8_t)out.alive;
}

// Write a lane's pushes to the pool at rows base, base + 1, ... in
// column order (rows at or past GP dropped).
template <typename T>
CS_HD void flush_lane(const View<T>& v, const Args& a, const LaneOut<T>& o,
                      long long base) {
  const int W = (int)a.W;
  CS_UNROLL
  for (int j = 0; j < kMaxW; ++j) {
    if (j >= W) break;
    if (!((o.push >> j) & 1u)) continue;
    if (base < a.GP) {
      T r[kPoolCols];
      if (a.r3) {
        r[0] = o.CK[j];
        r[1] = o.CL[j];
        r[2] = o.CS[j];
        r[3] = (T)(int32_t)(o.pos + j + 1);
      } else {
        r[0] = j == 0 ? o.k : o.CK[j - 1];
        r[1] = j == 0 ? o.l : o.CL[j - 1];
        r[2] = j == 0 ? o.s : o.CS[j - 1];
        r[3] = (T)(int32_t)(o.pos + j);
      }
      r[4] = (T)o.pivot;
      r[5] = (T)o.row_id;
      for (int c = 0; c < kPoolCols; ++c) v.pool[c * a.GP + base] = r[c];
    }
    ++base;
  }
}

// The pool cursor after `pushes` more rows, and povf.
template <typename T>
CS_HD void pool_close(const View<T>& v, const Args& a, long long cursor) {
  const int c = (int)cursor;
  v.ctr[2] = c;
  v.ctr[3] = (v.ctr[3] != 0 || c > a.GP) ? 1 : 0;
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

template <typename T>
__global__ void __launch_bounds__(kBlock) chain_probe_kernel(const Args a) {
  const View<T> v(a);
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i == 0) v.sc[4] += 1;                     // a new round: its epoch
  if (i < a.w) probe_lane(v, a, i);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) chain_group_kernel(const Args a) {
  __shared__ int tot[kWarps + 1];
  __shared__ int ticket_s, prefix_s;
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kBlock - 1) / kBlock);
  const unsigned epoch = (unsigned)v.sc[4];
  const int t = take_ticket(v.sc + 5, n_blocks, &ticket_s);
  const long long p = (long long)t * kBlock + threadIdx.x;
  long long o = 0;
  bool h = false;
  if (p < a.w) {
    o = v.order[p];
    h = group_head(v, a, p, o);
  }
  int total;
  const int ex = block_excl_scan<kWarps>(h, tot, &total);
  const int prefix = look_back(v.lb_group, t, total, epoch, &prefix_s);
  if (p < a.w) group_emit(v, a, o, prefix + ex + h - 1, h);
  if (t == n_blocks - 1) group_close(v, a, prefix + total, threadIdx.x,
                                     kBlock);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) chain_apply_kernel(const Args a) {
  __shared__ int tot[kWarps + 1];
  __shared__ int ticket_s, prefix_s;
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kBlock - 1) / kBlock);
  const unsigned epoch = (unsigned)v.sc[4];
  const int n_w = v.sc[0], cur0 = v.sc[1];
  const long long cursor = v.sc[7];
  const int t = take_ticket(v.sc + 6, n_blocks, &ticket_s);
  const long long i = (long long)t * kBlock + threadIdx.x;
  int fc = 0;
  if (i < a.Uw) fc = insert_rep(v, a, i, cur0);
  LaneOut<T> o;
  o.fq = o.alive = 0;
  o.push = 0;
  if (i < a.w) apply_lane(v, a, i, n_w, o);
  const int n = popc(o.push);
  int total;
  const int ex = block_excl_scan<kWarps>(n, tot, &total);
  const int prefix = look_back(v.lb_apply, t, total, epoch, &prefix_s);
  if (n) flush_lane(v, a, o, cursor + prefix + ex);
  warp_add(v.ctr + 0, o.fq);
  warp_add(v.ctr + 1, fc);
  warp_add(v.sc + 2, o.alive);
  if (t == n_blocks - 1 && threadIdx.x == 0)
    pool_close(v, a, cursor + prefix + total);
}

long long blocks_for(long long n) { return (n + kBlock - 1) / kBlock; }

template <typename T>
int launch(int which, const Args& a, cudaStream_t st) {
  switch (which) {
    case 0:
      chain_probe_kernel<T><<<blocks_for(a.w), kBlock, 0, st>>>(a);
      break;
    case 1:
      chain_group_kernel<T><<<blocks_for(a.w), kBlock, 0, st>>>(a);
      break;
    default:
      chain_apply_kernel<T><<<blocks_for(a.w), kBlock, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int launch_any(int which, const long long* words, void* stream) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.Uw > a.w)
    return (int)cudaErrorInvalidValue;
  return a.idx64 ? launch<int64_t>(which, a, (cudaStream_t)stream)
                 : launch<int32_t>(which, a, (cudaStream_t)stream);
}
#else
// ---------------------------------------------------------------------------
// The host loops: the same lane routines, lane after lane, the scans as
// running sums.
template <typename T>
void host_probe(const Args& a) {
  const View<T> v(a);
  v.sc[4] += 1;
  for (long long i = 0; i < a.w; ++i) probe_lane(v, a, i);
}

template <typename T>
void host_group(const Args& a) {
  const View<T> v(a);
  int g = -1;
  for (long long p = 0; p < a.w; ++p) {
    const long long o = v.order[p];
    const bool h = group_head(v, a, p, o);
    g += h;
    group_emit(v, a, o, g, h);
  }
  group_close(v, a, g + 1, 0, 1);
}

template <typename T>
void host_apply(const Args& a) {
  const View<T> v(a);
  const int n_w = v.sc[0], cur0 = v.sc[1];
  int fc = 0, fq = 0, live = 0;
  for (long long j = 0; j < a.Uw; ++j) fc += insert_rep(v, a, j, cur0);
  long long at = v.sc[7];
  LaneOut<T> o;
  for (long long i = 0; i < a.w; ++i) {
    apply_lane(v, a, i, n_w, o);
    fq += o.fq;
    live += o.alive;
    flush_lane(v, a, o, at);
    at += popc(o.push);
    o.push = 0;
  }
  v.ctr[0] += fq;
  v.ctr[1] += fc;
  v.sc[2] += live;
  pool_close(v, a, at);
}

int host_any(int which, const long long* words) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.Uw > a.w) return -1;
  const bool i64 = a.idx64 != 0;
  switch (which) {
    case 0:
      i64 ? host_probe<int64_t>(a) : host_probe<int32_t>(a);
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

// Every entry takes the Args words (ops/chain_cuda.py::ARGS, in order).
#ifdef __CUDACC__
extern "C" int chain_probe_launch(const long long* a, void* stream) {
  return launch_any(0, a, stream);
}
extern "C" int chain_group_launch(const long long* a, void* stream) {
  return launch_any(1, a, stream);
}
extern "C" int chain_apply_launch(const long long* a, void* stream) {
  return launch_any(2, a, stream);
}

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* chain_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same rounds on the host; each returns 0, or -1 for arguments the
// launchers refuse.
extern "C" int chain_probe_host(const long long* a) { return host_any(0, a); }
extern "C" int chain_group_host(const long long* a) { return host_any(1, a); }
extern "C" int chain_apply_host(const long long* a) { return host_any(2, a); }

// slot_hash for n keys (window words, l and s sign-extended to int64).
extern "C" void chain_slot_hash_host(const long long* wv, const long long* l,
                                     const long long* s, long long n,
                                     long long H, long long* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = (long long)slot_hash((uint64_t)wv[i], l[i], s[i], (uint64_t)H);
}
#endif

// The size of Args in words, to check the Python layout against.
extern "C" int chain_args_words() { return (int)(sizeof(Args) / 8); }
