// The round body of the forward chain-memo scan (ops/seedscan.py::
// chain_scan), the default seeding engine's forward loop.
//
// In the JAX package the round is make_body (compseed_tpu/ops/seedscan.py
// :1494-1690), run inside jax.lax.while_loop: XLA compiles it into a few
// fusions around one sort and three scans, and carries the memo in place.
// These kernels are the port's counterpart of XLA's fusions; the sort is
// CUB's radix sort over the key's bits (key_sort.cuh; XLA's sort in the JAX
// package), the representatives' walk fm_chain_walk_kernel
// (csrc/fm_walk.cu), the compaction between segments and the while_loop's
// cond before a segment's first round chain_segment_entry_kernel
// (compact.cuh), and the cond after each round the apply kernel's last
// block below: a segment's rounds run as one CUDA graph (loop_graph.cuh).
// One round:
//
// chain_probe_kernel<T>      a thread a lane, blocks of kProbeBlock
//   Replaces JAX seedscan.py:1495-1520 (port seedscan.py
//   _chain_probe_plain).  The lane's W-char window from winflat, the
//   slot hash in native uint64 arithmetic, one table row [window, l0,
//   s0, k0, len, ptr, valid, pad] (make_chain_memo) read as 16-byte
//   loads; writes hit, ptr (clamped to [0, M - 1]), k0, len, the window
//   and slot, and the sort key: the slot for a live miss, H else.  Also
//   launched once per round, it counts the round (the epoch) and writes
//   every representative j < Uw as the plain step leaves a pad (lane 0's
//   window, k, l, s and slot, not valid), so that the group kernel only
//   overwrites the heads: the pads' fill is spread over the grid.  A
//   lane's read id, lane_rid0[lane0[i]], is the same in every round of a
//   segment (only the compaction between segments writes lane0), so
//   chain_scan carries it in a lane array of its own, lane_rid, which the
//   compaction moves beside lane0 (the call's first segment: lane_rid0
//   itself); the probe reads it beside the lane's own words.
// (the sort of the keys, stable: the lanes in slot order; key_sort.cuh)
// chain_group_kernel<T>      one thread a sorted position
//   Replaces JAX :1521-1563 (_chain_group_plain).  Group heads over the
//   sorted lanes (a live miss whose (window, l, s) differs from its
//   sorted predecessor's), their exclusive scan in sorted order
//   (scan_blocks: a block scan, then a warp-wide look-back across
//   blocks), each lane's group index, and the first Uw heads'
//   representatives (window, k, l, s, valid, slot) written by the head's
//   own thread; the last block writes n_u, n_w = min(n_u, Uw), the store
//   cursor's old value and its advance.
// (fm_chain_walk_kernel on the representatives)
// chain_apply_kernel<T, W>   one thread a lane, blocks of 64
//   Replaces JAX :1564-1688 (_chain_apply_plain).
//   Insert: representative j < n_w appends its chain at row cur0 + j
//   while that is < M, and writes the table slot when it is the first
//   representative of its slot (the representatives arrive in slot
//   order).  Apply: a lane's chain comes from its store row (a hit) or
//   its group's walk, k re-based by k - k0 in T; then the LEP or round-3
//   push / stop rule, the fq and fc sums and the live count (warp sums,
//   one atomic a warp), and the advance or respawn.  Flush: the lanes'
//   push counts are scanned in lane order (scan_blocks), and the pushes go
//   to the six pool columns at cursor + rank (rows past GP dropped): the
//   plain version's (lane, j) row-major order exactly; the last block
//   moves cursor and povf.  In a loop (the loop word set) the last block
//   to retire also counts the round and tests the next (loop_retire).
//   A hit reads a store row
//   written in an earlier round (rows below cur0) while this round's
//   inserts write rows from cur0 on, so the two never meet.
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
// what even one block pays: its dependent round trips to memory, its
// scattered accesses through one SM's memory pipeline, and the scan
// across blocks.  The design cuts each:
//   - the probe: three dependent levels of loads where the first design
//     waited on four (lane0, then lane_rid0, then the window word, then
//     the table row): a lane's read id comes from lane_rid, which the
//     segment's set-up fills, issued first, beside pos, l, s and alive
//     (every round alike, so a CUDA graph of a segment's rounds needs no
//     first round of its own); the table row's 16-byte loads go out as
//     soon as the slot is known, before the stores of the window, the
//     slot and the pad; thread 0 counts the epoch with a reduction it
//     does not wait for.  In the chunk the table (2^21 rows at 16,384
//     reads: 64 MB in int32) and the chain store do not fit in the 50 MB
//     L2, so the row is a trip to device memory whatever the levels
//     before it.  Blocks of 256: in the chunk 64, 128, 512 and 1,024
//     threads were slower (PERF.md, the chain probe).
//   - one level of loads at a time.  A block takes its lanes from its
//     block index and issues their first loads beside its ticket's atomic
//     (the ticket almost always equals the index; when it does not, the
//     block loads its ticket's lanes again).  Every load that depends only
//     on the lane index is issued before any store, the insert's table-row
//     words beside the lane's, its store-row words (only in blocks that n_w
//     says insert) beside the lane's second level: the apply's chain is
//     ticket and lane words, the
//     lane's per-read constants and its chain row, its next pivot and the
//     base there read together (the base at the pivot's own position
//     serves unless the next unambiguous base lies further on), then the
//     scan: four levels where the first design, whose lane routines read
//     as they went, waited on about eleven.  The round's scalars (n_w,
//     cur0, the pool cursor, the epoch) and the index's five L2 words are
//     read at the start beside the ticket, off the chain.  The group's
//     chain is ticket and sorted lanes, their keys and their
//     predecessors' keys, then the scan.
//   - coalesced stores in the apply, whose floor they set (PERF.md: with
//     each thread writing its own store row, its table row a word at a
//     time and each push a word a column, a block of 256 lanes sent some
//     9,000 sector writes through one SM).  The block's new store rows are
//     copied word by word by consecutive threads (insert_src, insert_dst),
//     a table row goes out as 16-byte stores, and the block's pushes,
//     whose pool rows are contiguous, are staged in shared memory and
//     written a column at a time.  Blocks of 64 threads spread a round
//     over four times the SMs (the staging, 6 x 64 W words of T, fits in
//     static shared memory only at that size for int64 and W up to 10).
//     The window width W is a template parameter of the apply
//     (launch_apply picks it), so the column loops have fixed trip counts.
//   - a warp-wide look-back (lookback.cuh::scan_blocks): 32 status words a
//     step, so a 65,536-lane round (256 group blocks, 1,024 apply blocks)
//     waits at most 8 or 32 steps.  (Four sorted positions a group thread,
//     a quarter of the blocks, was slower at every width.)
//   - no one-block tail: the pads, which the first design's last group
//     block wrote alone (up to Uw - n_w of 32,768), are written by the
//     probe, a thread each, lane 0's words read beside the lane's own.
// A round is four launches of its own (the walk's included), one pass over
// the lanes each on every SM, with no copy of the memo or the pool; the
// loop's test needs no launch of its own.  chain_segment_entry_kernel
// (compact.cuh) starts every segment: it compacts the previous segment's
// lanes into this one's (or, before a call's first segment, counts its
// live lanes) and tests its first round; after each round the apply's last
// block to retire counts the round and tests the next (loop_retire: one
// 64-bit atomic a block, the blocks retired and their live lanes, then
// loop_after and cudaGraphSetConditional inside a graph), where the first
// design ended every round with a one-thread cond kernel, a node's launch
// and drain for some 20 bytes of work.
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

#include "compact.cuh"
#include "key_sort.cuh"
#include "loop_graph.cuh"

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
  // pool cursor at the round's start, the apply's retire count (64 bits,
  // words 8-9)]
  long long lb_group, lb_apply, sc;
  // sizes and modes
  long long w, Uw, W, L, H, M, GP, nq, r3, advance, min_len, max_intv,
      idx64;
  // each lane's read id (w), lane_rid0[lane0[i]], which chain_scan
  // carries through its compaction beside lane0; after the words above,
  // so that an earlier build of this source reads a prefix of the words
  long long lane_rid;
  // the sort (key_sort.cuh): sorted keys (w), the lane indices 0..w-1
  // (int64), its temporary storage and size in bytes, the key's bits
  long long sorted_key, iota, sort_tmp, sort_bytes, key_bits;
  // the segment's loop (loop_graph.cuh): the call's round counter (one
  // int32), the live count the previous segment left (one int32, read by
  // the entry's pads; 0 before a call's first segment), the next
  // segment's width, RCAP, the live-lane histogram (RCAP int32, or 0),
  // the WHILE node's condition handle (0 outside a graph) and the
  // condition's last value (one int32)
  long long rnd, live_in, nxtw, rcap, hist, cond, go;
  // 1: the apply kernel ends a loop's body and runs the loop's test after
  // the round (loop_retire); 0 (a launch of its own): it touches no loop
  // word.  After the words above, so that an earlier build reads a prefix
  long long loop;
  // the segment's entry (compact.cuh): the previous segment's lanes
  // (src_w of each, in the order of the lane words above: lane0,
  // lane_rid, pivot, pos, k, l, s, alive) and its width, 0 before a
  // call's first segment; the entry's look-back words (a word a block:
  // the apply's, lb_apply, where they are enough)
  long long src_lane0, src_lane_rid, src_pivot, src_pos, src_k, src_l,
      src_s, src_alive, src_w, lb_entry;
};

// words of sc (Args): the live count; the round's epoch; the group's
// ticket counter (the segment entry's too, compact.cuh); the apply's
// retire count, 64 bits at 8-9 (loop_graph.cuh::loop_retire)
constexpr int kScLive = 2, kScEpoch = 4, kScTicket = 5, kScRetire = 8;

// chain_scan's lane arrays as the segment entry moves them (compact.cuh):
// lane0, lane_rid, pivot, pos and k, l, s; a pad's read id lane_rid0[0],
// lane 0's, so that lane_rid stays lane_rid0[lane0].
template <typename T>
CS_HD LaneSet<T, 4, 3> chain_lanes(const Args& a) {
  LaneSet<T, 4, 3> s;
  const long long src32[4] = {a.src_lane0, a.src_lane_rid, a.src_pivot,
                              a.src_pos};
  const long long dst32[4] = {a.lane0, a.lane_rid, a.pivot, a.pos};
  const long long srcT[3] = {a.src_k, a.src_l, a.src_s};
  const long long dstT[3] = {a.k, a.l, a.s};
  for (int j = 0; j < 4; ++j) {
    s.src32[j] = (const int32_t*)src32[j];
    s.dst32[j] = (int32_t*)dst32[j];
    s.pad32[j] = 0;
  }
  for (int j = 0; j < 3; ++j) {
    s.srcT[j] = (const T*)srcT[j];
    s.dstT[j] = (T*)dstT[j];
  }
  if (a.src_w > 0) s.pad32[1] = ((const int32_t*)a.lane_rid0)[0];
  s.src_alive = (const bool*)a.src_alive;
  s.dst_alive = (bool*)a.alive;
  return s;
}

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

// Typed views of the arguments.  Within a launch no two of them share
// memory (__restrict__); an array a kernel writes is written at indices
// that no other thread of that kernel reads.
template <typename T>
struct View {
  int32_t *__restrict__ lane0, *__restrict__ pivot, *__restrict__ pos;
  uint8_t* __restrict__ alive;
  T *__restrict__ k, *__restrict__ l, *__restrict__ s;
  const int32_t *__restrict__ lane_rid0, *__restrict__ lane_rid,
      *__restrict__ lane_rlen0, *__restrict__ row_id0, *__restrict__ nxt;
  const T* __restrict__ mh0;
  const long long* __restrict__ winflat;
  const uint8_t* __restrict__ qflat;
  const T* __restrict__ L2;
  T *__restrict__ tbl, *__restrict__ cst, *__restrict__ pool;
  int32_t *__restrict__ cur, *__restrict__ ctr;
  long long* __restrict__ p_wv;
  int32_t *__restrict__ p_slot, *__restrict__ p_ptr, *__restrict__ p_hln,
      *__restrict__ key;
  uint8_t* __restrict__ p_hit;
  T* __restrict__ p_hk0;
  const long long* __restrict__ order;
  int32_t *__restrict__ gidx, *__restrict__ rep_slot;
  long long* __restrict__ rep_wv;
  T *__restrict__ rep_k, *__restrict__ rep_l, *__restrict__ rep_s;
  uint8_t* __restrict__ rep_valid;
  const T *__restrict__ ck, *__restrict__ cl, *__restrict__ cs;
  const int32_t* __restrict__ ln;
  unsigned long long *__restrict__ lb_group, *__restrict__ lb_apply;
  int32_t* __restrict__ sc;

  CS_HD explicit View(const Args& a)
      : lane0((int32_t*)a.lane0),
        pivot((int32_t*)a.pivot),
        pos((int32_t*)a.pos),
        alive((uint8_t*)a.alive),
        k((T*)a.k),
        l((T*)a.l),
        s((T*)a.s),
        lane_rid0((const int32_t*)a.lane_rid0),
        lane_rid((const int32_t*)a.lane_rid),
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

// Write one table row (the layout of load_row8).
template <typename T>
CS_HD void store_row8(T* row, const T in[8]) {
#ifdef __CUDA_ARCH__
  uint4* p = reinterpret_cast<uint4*>(row);
  constexpr int kVec = 8 * sizeof(T) / 16;
  uint4 v[kVec];
  T* t = reinterpret_cast<T*>(v);
  for (int j = 0; j < 8; ++j) t[j] = in[j];
  for (int q = 0; q < kVec; ++q) p[q] = v[q];
#else
  for (int j = 0; j < 8; ++j) row[j] = in[j];
#endif
}

// The five L2 words, read once where a kernel starts, and the one of
// them at c in [0, 4] (a select, so that they stay in registers).
template <typename T>
CS_HD void load_l2(const View<T>& v, T out[5]) {
  for (int c = 0; c < 5; ++c) out[c] = v.L2[c];
}

template <typename T>
CS_HD T l2_at(const T l2[5], int c) {
  T r = l2[0];
  CS_UNROLL
  for (int q = 1; q < 5; ++q)
    if (c == q) r = l2[q];
  return r;
}

// ---------------------------------------------------------------------------
// The lane routines, shared by the kernels and the host loops.

template <typename T>
CS_HD long long key_slot(const Args& a, long long wv, T l, T s) {
  return (long long)slot_hash((uint64_t)wv, (int64_t)l, (int64_t)s,
                              (uint64_t)a.H);
}

// Representative j's inputs (valid: it walks).
template <typename T>
CS_HD void rep_write(const View<T>& v, long long j, long long wv, T k, T l,
                     T s, int slot, bool valid) {
  v.rep_wv[j] = wv;
  v.rep_k[j] = k;
  v.rep_l[j] = l;
  v.rep_s[j] = s;
  v.rep_valid[j] = valid ? 1 : 0;
  v.rep_slot[j] = slot;
}

// Probe: lane i's window, slot, table row, hit and sort key.  With pad
// >= 0 also representative `pad` as the plain step's zero-filled rep_take
// leaves it past n_w: lane 0's window, k, l, s and slot, not valid (the
// probe writes every pad j < Uw; the group kernel overwrites the heads
// j < n_w).  Lane 0's words are read beside lane i's, a level at a time:
// (1) the read ids, which head the chain, then the lanes' own words, (2)
// the window words, (3) lane i's table row, a live lane's only.
template <typename T>
CS_HD void probe_lane(const View<T>& v, const Args& a, long long i,
                      long long pad) {
  const long long rid = v.lane_rid[i], rid_z = v.lane_rid[0];
  const long long pc = clampll(v.pos[i], 0, a.L + 1);
  const long long pc_z = clampll(v.pos[0], 0, a.L + 1);
  const T l = v.l[i], s = v.s[i];
  const T k_z = v.k[0], l_z = v.l[0], s_z = v.s[0];
  const bool alive = v.alive[i] != 0;
  const long long wv = v.winflat[rid * (a.L + 2) + pc];
  const long long wv_z = v.winflat[rid_z * (a.L + 2) + pc_z];
  const long long slot = key_slot(a, wv, l, s);
  T row[8] = {};                 // a dead lane's: no hit, ptr, k0, len 0
  if (alive) load_row8(v.tbl + slot * 8, row);
  v.p_wv[i] = wv;
  v.p_slot[i] = (int32_t)slot;
  if (pad >= 0)
    rep_write(v, pad, wv_z, k_z, l_z, s_z, (int)key_slot(a, wv_z, l_z, s_z),
              false);
  const bool hit = alive && row[6] != 0 && row[0] == w_store<T>(wv) &&
                   row[1] == l && row[2] == s;
  v.p_hit[i] = hit ? 1 : 0;
  v.p_ptr[i] = (int)clampll((long long)row[5], 0, a.M - 1);
  v.p_hk0[i] = row[3];
  v.p_hln[i] = (int)row[4];
  v.key[i] = (int32_t)(alive && !hit ? slot : a.H);
}

// What the group reads of sorted position p: lane o there and lane q at
// p - 1 (first level), then o's key, window, k, l, s and slot and q's
// window, l and s (second level); whether p heads a group (a live miss
// whose key differs from its sorted predecessor's; position 0 always
// does).  Lanes are read whatever their key, so that no load waits on a
// test.
template <typename T>
struct GroupIn {
  long long o, q, wv;
  T k, l, s;
  int slot;
  bool head;
};

template <typename T>
CS_HD void group_order(const View<T>& v, const Args& a, long long p,
                       GroupIn<T>& g) {
  g.o = g.q = 0;
  if (p < a.w) {
    g.o = v.order[p];
    g.q = v.order[p > 0 ? p - 1 : 0];
  }
}

template <typename T>
CS_HD void group_read(const View<T>& v, const Args& a, long long p,
                      GroupIn<T>& g) {
  g.head = false;
  if (p >= a.w) return;
  const long long o = g.o, q = g.q;
  const bool miss = v.key[o] < a.H;
  g.wv = v.p_wv[o];
  g.k = v.k[o];
  g.l = v.l[o];
  g.s = v.s[o];
  g.slot = v.p_slot[o];
  const long long qwv = v.p_wv[q];
  const T ql = v.l[q], qs = v.s[q];
  g.head = miss && (p == 0 || g.wv != qwv || g.l != ql || g.s != qs);
}

// Sorted position p (lane o) has group index gi (the inclusive count of
// heads up to p, minus 1); a head below Uw is representative gi.
template <typename T>
CS_HD void group_emit(const View<T>& v, const Args& a, const GroupIn<T>& g,
                      int gi) {
  v.gidx[g.o] = gi;
  if (g.head && gi < a.Uw) rep_write(v, gi, g.wv, g.k, g.l, g.s, g.slot, true);
}

// After the scan: n_u heads, n_w = min(n_u, Uw) representatives; the
// store cursor's old value cur0 and its advance (the representatives
// j < n_w whose row cur0 + j is below M); the pool cursor as the round
// found it.
template <typename T>
CS_HD void group_close(const View<T>& v, const Args& a, int n_u, int cur0,
                       int cursor) {
  const int n_w = n_u < a.Uw ? n_u : (int)a.Uw;
  const long long room = a.M - cur0;
  v.sc[0] = n_w;
  v.sc[1] = cur0;
  v.sc[2] = 0;                      // the apply kernel's live count
  v.sc[3] = n_u;
  v.sc[7] = cursor;                 // the pool cursor the apply starts at
  *v.cur = cur0 + (int)(room < 0 ? 0 : (room < n_w ? room : n_w));
}

// What the apply reads at lane i (first level).
template <typename T>
struct LaneIn {
  T k, l, s, hk0;
  int pos, pivot, lane0, gidx, ptr, hln;
  bool alive, hit;
};

// What the insert reads at representative j (first level) for its table
// row and fc.  (The valid representatives are the prefix j < n_w, the
// heads the group wrote; the probe's pads past it are not valid.)
template <typename T>
struct RepIn {
  long long wv;
  T k, l, s;
  int ln;
  int32_t slot;
  bool first;
};

template <typename T>
CS_HD void lane_in(const View<T>& v, const Args& a, long long i,
                   LaneIn<T>& x) {
  x.alive = x.hit = false;
  if (i >= a.w) return;
  x.alive = v.alive[i] != 0;
  x.hit = v.p_hit[i] != 0;
  x.gidx = v.gidx[i];
  x.k = v.k[i];
  x.l = v.l[i];
  x.s = v.s[i];
  x.pos = v.pos[i];
  x.pivot = v.pivot[i];
  x.lane0 = v.lane0[i];
  x.ptr = v.p_ptr[i];
  x.hk0 = v.p_hk0[i];
  x.hln = v.p_hln[i];
}

template <typename T>
CS_HD void rep_in(const View<T>& v, const Args& a, long long j, RepIn<T>& r) {
  r = RepIn<T>();
  if (j >= a.Uw) return;
  r.ln = v.ln[j];
  r.slot = v.rep_slot[j];
  r.first = j == 0 || r.slot != v.rep_slot[j > 0 ? j - 1 : 0];
  r.wv = v.rep_wv[j];
  r.k = v.rep_k[j];
  r.l = v.rep_l[j];
  r.s = v.rep_s[j];
}

// Insert: representative j < n_w appends its chain at store row cur0 + j
// while that is below M (j is its rank).  Column c of that row is column
// c of its chain (ck | cl | cs): read it (j < Uw) and write it; the kernel
// gives consecutive threads consecutive words of the rows.
template <typename T, int kW>
CS_HD T insert_src(const View<T>& v, const Args& a, long long j, int c) {
  if (j >= a.Uw) return 0;
  const int part = c >= 2 * kW ? 2 : (c >= kW ? 1 : 0);
  const T* src = part == 0 ? v.ck : (part == 1 ? v.cl : v.cs);
  return src[j * kW + c - part * kW];
}

template <typename T, int kW>
CS_HD void insert_dst(const View<T>& v, const Args& a, long long j, int c,
                      int cur0, int n_w, T x) {
  const long long cptr = (long long)cur0 + j;
  if (j < n_w && cptr < a.M) v.cst[cptr * 3 * kW + c] = x;
}

// Insert representative j's table row when it has a store row and is the
// first representative of its slot (the representatives arrive in slot
// order).  Returns its contribution to fc (the extensions it walked).
template <typename T>
CS_HD int insert_table(const View<T>& v, const Args& a, long long j,
                       int cur0, int n_w, const RepIn<T>& r) {
  if (j >= n_w) return 0;
  const long long cptr = (long long)cur0 + j;
  if (cptr < a.M && r.first) {
    const T row[8] = {w_store<T>(r.wv), r.l, r.s, r.k, (T)r.ln, (T)cptr,
                      1, 0};
    store_row8(v.tbl + (long long)r.slot * 8, row);
  }
  return r.ln;
}

// A lane's round: what it consumed, whether it lives on, and its pushes
// (the chain's columns and the state before the round, kept until the
// lane knows its rows in the pool).
template <typename T, int kW>
struct LaneOut {
  int fq;              // columns consumed (applied lanes)
  int alive;           // alive after the round
  uint32_t push;       // columns pushed
  T k, l, s;           // the state before the round
  int pos, pivot, row_id;
  T CK[kW], CL[kW], CS[kW];
};

// Apply lane i (its first-level words x): consume its chain (a store row
// or its group's walk), decide its pushes, advance or respawn.  A lane
// that is neither a hit nor walked this round keeps its state and pushes
// nothing.  Second level: the lane's per-read constants and its chain;
// third: its next pivot and the base there.  kW is the window width W.
template <typename T, int kW>
CS_HD void apply_lane(const View<T>& v, const Args& a, long long i, int n_w,
                      const LaneIn<T>& x, const T l2[5],
                      LaneOut<T, kW>& out) {
  const bool walked = x.alive && !x.hit && x.gidx < n_w;
  out.fq = 0;
  out.alive = x.alive ? 1 : 0;
  out.push = 0;
  if (!(x.hit || walked)) return;
  constexpr int W = kW;
  const long long L = a.L;
  const long long grp = clampll(x.gidx, 0, a.Uw - 1);
  const T k = x.k, l = x.l, s = x.s;
  const int pos = x.pos, pivot = x.pivot;
  const long long rid = v.lane_rid0[x.lane0];
  const int rlen = v.lane_rlen0[x.lane0];
  const T mh = v.mh0[x.lane0];
  out.k = k;
  out.l = l;
  out.s = s;
  out.pos = pos;
  out.pivot = pivot;
  out.row_id = v.row_id0[x.lane0];

  T* CK = out.CK;
  T* CL = out.CL;
  T* CS = out.CS;
  T src_k0;
  int src_ln;
  // (the column loops have a fixed trip count, W, so that they unroll and
  // the columns stay in registers)
  const T* ck = v.ck + grp * W;
  const T* cl = v.cl + grp * W;
  const T* cs = v.cs + grp * W;
  if (x.hit) {
    ck = v.cst + (long long)x.ptr * 3 * W;
    cl = ck + W;
    cs = ck + 2 * W;
    src_k0 = x.hk0;
    src_ln = x.hln;
  } else {
    src_k0 = v.rep_k[grp];
    src_ln = v.ln[grp];
  }
  const T dk = wsub(k, src_k0);
  CS_UNROLL
  for (int j = 0; j < W; ++j) {
    CK[j] = wadd(ck[j], dk);
    CL[j] = cl[j];
    CS[j] = cs[j];
  }

  uint32_t push = 0, stop = 0;
  CS_UNROLL
  for (int j = 0; j < W; ++j) {
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

  // advance / respawn: the next unambiguous position from npv and the base
  // there; the base at npv itself is read beside it and serves when the
  // two agree
  const int stop_pos = pos + t;
  const bool amb_stop = has_stop && t == src_ln;
  const int npv = (a.r3 || amb_stop) ? stop_pos + 1 : stop_pos;
  bool respawn = false;
  int newpiv = (int)L, base = 0;
  if (a.advance && has_stop && npv < L) {
    const long long at = rid * L + clampll(npv, 0, L - 1);
    newpiv = v.nxt[at];
    base = v.qflat[clampll(rid * L + npv, 0, a.nq - 1)];
    respawn = newpiv < rlen;
    if (respawn && newpiv != npv)
      base = v.qflat[clampll(rid * L + newpiv, 0, a.nq - 1)];
  }
  if (respawn) {
    const int c = base > 3 ? 3 : base;
    v.k[i] = wadd(l2_at(l2, c), (T)1);
    v.l[i] = wadd(l2_at(l2, 3 - c), (T)1);
    v.s[i] = wsub(l2_at(l2, c + 1), l2_at(l2, c));
    v.pivot[i] = newpiv;
    v.pos[i] = newpiv + 1;
  } else if (!has_stop) {
    const int last = (int)clampll(src_ln - 1, 0, W - 1);
    T ek = CK[0], el = CL[0], es = CS[0];
    CS_UNROLL
    for (int j = 1; j < W; ++j) {
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

// The pool row of a lane's push at column j: k, l, s, end, pivot, row.
template <typename T, int kW>
CS_HD void push_row(const Args& a, const LaneOut<T, kW>& o, int j,
                    T r[kPoolCols]) {
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
}

// The pool cursor after the round's pushes, and povf (povf0: its value
// before the round).
template <typename T>
CS_HD void pool_close(const View<T>& v, const Args& a, long long cursor,
                      int povf0) {
  const int c = (int)cursor;
  v.ctr[2] = c;
  v.ctr[3] = (povf0 != 0 || c > a.GP) ? 1 : 0;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// The kernels: a lane (a sorted position) a thread, blocks of
// (ops/chain_cuda.py: PROBE_BLOCK, BLOCK, APPLY_BLOCK)
constexpr int kProbeBlock = 256;       // the probe
constexpr int kGroupBlock = 256;       // the group
constexpr int kApplyBlock = 64;        // the apply
using lookback::scan_blocks;
using lookback::take_ticket;
using lookback::warp_add;

template <typename T>
__global__ void __launch_bounds__(kProbeBlock) chain_probe_kernel(
    const Args a) {
  const View<T> v(a);
  const long long i = (long long)blockIdx.x * kProbeBlock + threadIdx.x;
  // a new round: its epoch, counted by a reduction that thread 0 does not
  // wait for (a load and a store would hold its warp a round trip)
  if (i == 0) atomicAdd(v.sc + 4, 1);
  if (i < a.w) probe_lane(v, a, i, i < a.Uw ? i : -1);
}

template <typename T>
__global__ void __launch_bounds__(kGroupBlock) chain_group_kernel(
    const Args a) {
  __shared__ int ticket_s, scan_s[34];
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kGroupBlock - 1) / kGroupBlock);
  const unsigned epoch = (unsigned)v.sc[4];
  int cur0 = 0, cursor = 0;                     // the last block's close
  if (threadIdx.x == 0) {
    cur0 = *v.cur;
    cursor = v.ctr[2];
  }
  // the first level at the block index, beside the ticket's atomic
  long long p = (long long)blockIdx.x * kGroupBlock + threadIdx.x;
  GroupIn<T> g;
  group_order(v, a, p, g);
  const int t = take_ticket(v.sc + 5, n_blocks, &ticket_s);
  if (t != (int)blockIdx.x) {
    p = (long long)t * kGroupBlock + threadIdx.x;
    group_order(v, a, p, g);
  }
  group_read(v, a, p, g);
  int first, upto;
  const int ex = scan_blocks<kGroupBlock / 32>(g.head, v.lb_group, t, epoch,
                                               scan_s, &first, &upto);
  if (p < a.w) group_emit(v, a, g, ex + g.head - 1);
  if (t == n_blocks - 1 && threadIdx.x == 0)
    group_close(v, a, upto, cur0, cursor);
}

// The store-row words of the block with ticket t (the rows of its
// representatives j = t kApplyBlock + row): thread x's k-th is word
// k kApplyBlock + x of the block's kApplyBlock rows of 3W, its row and
// column stepped a word at a time.
template <int kW>
struct RowWord {
  static constexpr int kRowStep = kApplyBlock / (3 * kW);
  static constexpr int kColStep = kApplyBlock % (3 * kW);
  int row, col;
  __device__ __forceinline__ RowWord()
      : row(threadIdx.x / (3 * kW)), col(threadIdx.x % (3 * kW)) {}
  __device__ __forceinline__ void next() {
    row += kRowStep;
    col += kColStep;
    if (col >= 3 * kW) {
      col -= 3 * kW;
      ++row;
    }
  }
};

template <typename T, int kW>
__device__ __forceinline__ void insert_load(const View<T>& v, const Args& a,
                                            int t, T (&x)[3 * kW]) {
  const long long j0 = (long long)t * kApplyBlock;
  RowWord<kW> w;
  CS_UNROLL
  for (int k = 0; k < 3 * kW; ++k, w.next())
    x[k] = insert_src<T, kW>(v, a, j0 + w.row, w.col);
}

// kW: the window width W.
template <typename T, int kW>
__global__ void __launch_bounds__(kApplyBlock) chain_apply_kernel(
    const Args a) {
  __shared__ int ticket_s, scan_s[34];
  __shared__ T stage[kPoolCols][kApplyBlock * kW];   // the block's pushes
  const View<T> v(a);
  const int n_blocks = (int)((a.w + kApplyBlock - 1) / kApplyBlock);
  // independent of the lane: the round's scalars and L2
  const unsigned epoch = (unsigned)v.sc[4];
  const int n_w = v.sc[0], cur0 = v.sc[1];
  const long long cursor = v.sc[7];
  const int povf0 = threadIdx.x == 0 ? v.ctr[3] : 0;   // the last block's
  const LoopPre pre = loop_pre<kScLive>(a);   // the loop's words, if any
  T l2[5];
  load_l2(v, l2);
  // the first level at the block index, beside the ticket's atomic
  long long i = (long long)blockIdx.x * kApplyBlock + threadIdx.x;
  LaneIn<T> x;
  RepIn<T> r;
  T words[3 * kW];
  lane_in(v, a, i, x);
  rep_in(v, a, i, r);
  const int t = take_ticket(v.sc + 6, n_blocks, &ticket_s);
  if (t != (int)blockIdx.x) {
    i = (long long)t * kApplyBlock + threadIdx.x;
    lane_in(v, a, i, x);
    rep_in(v, a, i, r);
  }
  // the store rows only where the block has representatives that insert:
  // read beside the lane's second level, written after its work
  const bool inserts = (long long)t * kApplyBlock < n_w;
  if (inserts) insert_load<T, kW>(v, a, t, words);
  const int fc = insert_table(v, a, i, cur0, n_w, r);
  LaneOut<T, kW> o;
  apply_lane(v, a, i, n_w, x, l2, o);
  if (inserts) {
    RowWord<kW> rw;
    CS_UNROLL
    for (int k = 0; k < 3 * kW; ++k, rw.next())
      insert_dst<T, kW>(v, a, (long long)t * kApplyBlock + rw.row, rw.col,
                        cur0, n_w, words[k]);
  }
  const int n = popc(o.push);
  int first, upto;
  const int ex = scan_blocks<kApplyBlock / 32>(n, v.lb_apply, t, epoch,
                                               scan_s, &first, &upto);
  // flush: the block's pushes are rows cursor + [first, upto) of the pool,
  // staged in shared memory and written a column at a time
  int at = ex - first;
  CS_UNROLL
  for (int j = 0; j < kW; ++j) {
    if (!((o.push >> j) & 1u)) continue;
    T row[kPoolCols];
    push_row(a, o, j, row);
    CS_UNROLL
    for (int c = 0; c < kPoolCols; ++c) stage[c][at] = row[c];
    ++at;
  }
  __syncthreads();
  const long long base = cursor + first;
  for (int q = threadIdx.x; q < upto - first; q += kApplyBlock) {
    if (base + q >= a.GP) break;                    // rows past GP dropped
    CS_UNROLL
    for (int c = 0; c < kPoolCols; ++c)
      v.pool[c * a.GP + base + q] = stage[c][q];
  }
  warp_add(v.ctr + 0, o.fq);
  warp_add(v.ctr + 1, fc);
  if (!a.loop) warp_add(v.sc + kScLive, o.alive);
  if (t == n_blocks - 1 && threadIdx.x == 0)
    pool_close(v, a, cursor + upto, povf0);
  // in a loop: the live lanes and the round's test by the last block to
  // retire
  loop_retire<kScLive, kScRetire, kApplyBlock / 32>(a, o.alive, n_blocks,
                                                    pre);
}

// The segment's entry (compact.cuh): the previous segment's lanes
// compacted into this one's (or, before a call's first segment, its live
// lanes counted), the live count and the segment's first test, the WHILE
// node's condition set from it inside a graph.
template <typename T>
__global__ void __launch_bounds__(kEntryBlock) chain_segment_entry_kernel(
    const Args a) {
  segment_entry<kScLive, kScTicket, kScEpoch>(a, chain_lanes<T>(a));
}

long long blocks_for(long long n, int block) {
  return (n + block - 1) / block;
}

// The apply kernel for the window width a.W (kW and up).
template <typename T, int kW = 1>
void launch_apply(const Args& a, cudaStream_t st) {
  if constexpr (kW < kMaxW) {
    if (a.W != kW) return launch_apply<T, kW + 1>(a, st);
  }
  chain_apply_kernel<T, kW>
      <<<blocks_for(a.w, kApplyBlock), kApplyBlock, 0, st>>>(a);
}

// The entry: a block a tile of the source's lanes (or, with none, of the
// segment's).
template <typename T>
void launch_entry(const Args& a, cudaStream_t st) {
  const long long n = a.src_w > 0 ? a.src_w : a.w;
  chain_segment_entry_kernel<T>
      <<<blocks_for(n, kEntryBlock * kEntryItems), kEntryBlock, 0, st>>>(a);
}

template <typename T>
int launch(int which, const Args& a, cudaStream_t st) {
  switch (which) {
    case 0:
      chain_probe_kernel<T>
          <<<blocks_for(a.w, kProbeBlock), kProbeBlock, 0, st>>>(a);
      break;
    case 1:
      chain_group_kernel<T>
          <<<blocks_for(a.w, kGroupBlock), kGroupBlock, 0, st>>>(a);
      break;
    case 2:
      launch_apply<T>(a, st);
      break;
    case 3: {
      const int e = key_sort((const int32_t*)a.key, (int32_t*)a.sorted_key,
                             (const int64_t*)a.iota, (int64_t*)a.order, a.w,
                             (int)a.key_bits, (void*)a.sort_tmp,
                             a.sort_bytes, st);
      if (e) return e;
      break;
    }
    default:
      launch_entry<T>(a, st);
  }
  return (int)cudaGetLastError();
}

int launch_any(int which, const long long* words, void* stream) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.Uw > a.w)
    return (int)cudaErrorInvalidValue;
  if (which == 3 && (a.key_bits < 1 || a.key_bits > 32 || !a.sort_tmp))
    return (int)cudaErrorInvalidValue;
  // the entry covers the source's lanes, the new width's among them
  if (which == 4 && (a.src_w < 0 || a.src_w >= INT32_MAX ||
                     (a.src_w > 0 && a.src_w < a.w) || !a.lb_entry))
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
  for (long long i = 0; i < a.w; ++i) probe_lane(v, a, i, i < a.Uw ? i : -1);
}

template <typename T>
void host_group(const Args& a) {
  const View<T> v(a);
  int n = 0;
  for (long long p = 0; p < a.w; ++p) {
    GroupIn<T> g;
    group_order(v, a, p, g);
    group_read(v, a, p, g);
    n += g.head;
    group_emit(v, a, g, n - 1);
  }
  group_close(v, a, n, *v.cur, v.ctr[2]);
}

// The apply for the window width a.W (kW and up).
template <typename T, int kW = 1>
void host_apply(const Args& a) {
  if constexpr (kW < kMaxW) {
    if (a.W != kW) return host_apply<T, kW + 1>(a);
  }
  const View<T> v(a);
  const int n_w = v.sc[0], cur0 = v.sc[1];
  T l2[5];
  load_l2(v, l2);
  for (long long j = 0; j < a.Uw; ++j)
    for (int c = 0; c < 3 * kW; ++c)
      insert_dst<T, kW>(v, a, j, c, cur0, n_w, insert_src<T, kW>(v, a, j, c));
  int fc = 0, fq = 0, live = 0;
  long long at = v.sc[7];
  LaneIn<T> x;
  RepIn<T> r;
  LaneOut<T, kW> o;
  for (long long i = 0; i < a.w; ++i) {
    lane_in(v, a, i, x);
    rep_in(v, a, i, r);
    fc += insert_table(v, a, i, cur0, n_w, r);
    apply_lane(v, a, i, n_w, x, l2, o);
    fq += o.fq;
    live += o.alive;
    for (int j = 0; j < kW; ++j) {           // the pushes, rows past GP
      if (!((o.push >> j) & 1u)) continue;    // dropped
      T row[kPoolCols];
      push_row(a, o, j, row);
      for (int c = 0; c < kPoolCols && at < a.GP; ++c)
        v.pool[c * a.GP + at] = row[c];
      ++at;
    }
  }
  v.ctr[0] += fq;
  v.ctr[1] += fc;
  v.sc[kScLive] += live;
  pool_close(v, a, at, v.ctr[3]);
  if (a.loop) loop_step<kScLive>(a);             // the folded loop test
}

int host_any(int which, const long long* words) {
  Args a;
  memcpy(&a, words, sizeof(Args));
  if (a.w <= 0) return 0;
  if (a.W < 1 || a.W > kMaxW || a.Uw < 1 || a.Uw > a.w) return -1;
  if (which == 3 && (a.key_bits < 1 || a.key_bits > 32)) return -1;
  if (which == 4 && (a.src_w < 0 || (a.src_w > 0 && a.src_w < a.w)))
    return -1;
  const bool i64 = a.idx64 != 0;
  switch (which) {
    case 0:
      i64 ? host_probe<int64_t>(a) : host_probe<int32_t>(a);
      break;
    case 1:
      i64 ? host_group<int64_t>(a) : host_group<int32_t>(a);
      break;
    case 2:
      i64 ? host_apply<int64_t>(a) : host_apply<int32_t>(a);
      break;
    case 3:
      key_sort_host((const int32_t*)a.key, (int32_t*)a.sorted_key,
                    (int64_t*)a.order, a.w, (int)a.key_bits);
      break;
    default:
      if (i64)
        segment_entry_host<kScLive, kScEpoch>(a, chain_lanes<int64_t>(a));
      else
        segment_entry_host<kScLive, kScEpoch>(a, chain_lanes<int32_t>(a));
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
extern "C" int chain_sort_launch(const long long* a, void* stream) {
  return launch_any(3, a, stream);
}
extern "C" int chain_segment_entry_launch(const long long* a,
                                          void* stream) {
  return launch_any(4, a, stream);
}

// The sort's temporary storage for n keys of `bits` bits.
extern "C" long long chain_sort_bytes(long long n, int bits) {
  return key_sort_bytes(n, bits);
}

LOOP_GRAPH_ENTRIES(chain)

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
extern "C" int chain_sort_host(const long long* a) { return host_any(3, a); }
extern "C" int chain_segment_entry_host(const long long* a) {
  return host_any(4, a);
}

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
