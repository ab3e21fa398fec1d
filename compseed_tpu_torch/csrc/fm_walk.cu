// The FM-index primitives of the seeding walks and the suffix-array walk.
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
//   extension of a bi-interval (k, l, s) by base c: one step of the chain
//   walk, so the same pair of threads a lane, one a row.  Plain version:
//   compseed_tpu_torch/ops/fm.py::_extend_sel_plain.
// fm_chain_walk_kernel<T>
//   Replaces compseed_tpu/ops/seedscan.py:1341 _chain_walk: W <= 10 pure
//   extensions per representative over the 3-bit codes of its packed
//   window word, stopping at the first ambiguous base (and, with stop_s,
//   once the interval drops below the group's smallest min_hits).  Two
//   threads a lane, one a row, over the packed occ rows.  Plain version:
//   compseed_tpu_torch/ops/seedscan.py::_chain_walk_plain.
// fm_inv_psi_walk_kernel<T>
//   Replaces compseed_tpu/ops/fm.py:166 inv_psi_batch stepped n times, as
//   the step loops of sa_batch (:200) and sa_batch_compact (run, :256) do:
//   per step kk = invPsi(kk) and steps += 1 on live lanes, then a lane dies
//   once kk is a sampled row.  Two threads a lane, over the packed occ
//   rows.  Plain version: compseed_tpu_torch/ops/fm.py::_walk_plain.  It
//   may write in place (kk_out == kk and so on): a lane's words are read
//   before its pair's first shuffle and written after its last.  With
//   a tail (SaTail: a retire word, which only ops/fm_cuda.SaLoop passes)
//   it also ends the body of sa_batch_compact's last stage, a while_loop
//   on jnp.any(alive) (compseed_tpu/ops/fm.py:282): its last block to
//   retire (loop_graph.cuh::retire_last: one 64-bit atomic a block, the
//   blocks retired and their live lanes) sets go and the WHILE node's
//   condition to live > 0.  Without one (sa_batch, densify_sa, the exact
//   rerun and the stages before the loop) the walk touches no loop word.
// sa_stage_entry_kernel<T>
//   Replaces the boundaries between sa_batch_compact's stages
//   (compseed_tpu/ops/fm.py:268-291, XLA: the done lanes scattered to
//   out_steps / out_k with mode="drop", then argsort(~alive, stable)[:cap]
//   and four gathers, ovf |= sum(alive) > cap, and before the last stage
//   the while_loop's first test): one launch a boundary, where the port
//   ran some 25 PyTorch operations (a stable sort, gathers, index_put_s)
//   and, before the last stage, a one-block loop kernel.  In one pass over
//   the stage's lanes (compact.cuh's rank_tile, 512 lanes a block, alive
//   bytes loaded beside the ticket, then the words of the live and done
//   lanes): each lane that died in the stage that ended and holds a slot
//   writes its steps and position to out_steps[slot], out_k[slot]; each
//   live lane goes to its rank among the live lanes in the next stage's
//   lanes, a rank at or past the cap dropped; lanes [min(live, cap), cap)
//   are dead fillers (slot -1, zeros), each block clearing its tile of
//   them and fencing before the scan publishes its count (a release); a
//   lane's rank is at most its index, so every lane moved into that tile
//   comes from a block that waits on the count, and that block fences
//   after its look-back's reads before it stores (an acquire:
//   lookback.cuh's kAcquire).  The block with the last ticket has the
//   scan's total: ovf |= live > cap, and at the boundary before the last stage
//   the loop's first test, live > 0, in go and the WHILE node's condition
//   (it opens the loop's graph).  The first boundary starts the outputs:
//   its live lanes write out_steps[i] = 0 and out_k[i] = the call's
//   position, as the JAX package's initial arrays hold, and it sets ovf.
//   After the loop one more launch (no next stage) writes the last
//   stage's done lanes.  JAX's argsort puts particular dead lanes into
//   the fillers; nothing reads them: the first stage has no compaction
//   and writes out every lane it leaves dead, so at every boundary each
//   dead lane has slot -1 once the done lanes are written.  Plain version
//   ops/fm.py::_sa_boundary_plain; host twin sa_stage_entry_host.  What
//   bounds it: a few hundred kB at the widest boundary (98,304 lanes to
//   24,576), well under a microsecond at 3.35 TB/s; the launch and one
//   pass's dependent steps (ticket, alive bytes, words, look-back, stores)
//   decide, as for the round loops' segment entries.
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
// What bounds them on Hopper.  A step ranks at one (inverse Psi) or two
// (extension) data-dependent occ rows, and step j + 1 of a lane needs
// step j's interval: each lane is a dependent chain of random reads, with
// a few popcounts a step.  The bytes a call needs are a few kB to a few MB
// (chip_smoke.py's fm_rank_need counts them), so the bound by HBM bytes is
// microseconds; what decides is (a) how many L1 wavefronts and sectors
// each rank costs, since a warp-wide load whose 32 threads hit 32 rows is
// served a row at a time, (b) how many SMs have lanes, and (c) the
// latency of W dependent reads, which nothing can overlap within a lane.
// The first kernels (one thread a lane, 12 scalar 8-byte loads of a
// 96-byte int64 row per rank, blocks of 256) paid 12 wavefronts a row per
// rank, left 100 of 132 SMs idle on the forward walk's 8,192 lanes and
// wrote their outputs a column at a time, stride W or 3.  The design here:
//   - rows are the packed table (ops/device_index.py::pack_occ_rows): 16
//     uint32 words, 64 bytes, 64-byte aligned: quarter 0 (words 0-3) the
//     A/C/G/T checkpoint counts, quarter 1 (4-7) hi0 lo0 hi1 lo1, quarter 2
//     (8-11) hi2 lo2 hi3 lo3, quarter 3 zero.  Sector 0 serves every block
//     offset below 64; sector 1 is read only for offsets 64-127;
//   - a rank reads quarter 0 and the plane quarters it needs by 16-byte
//     loads, so it costs two or three loads of at most two sectors; a
//     rank may be cut into two pieces (rank_piece), one a plane quarter,
//     whose popcounts, 8 bits a base in one word, add up to the rank;
//   - every kernel gives a lane a pair of threads.  An extension, alone
//     or a step of the chain walk, ranks at two rows, one a thread, so
//     both rows are read at once, and the pair exchanges the ranks by
//     shuffles (both threads then hold both and step the same interval:
//     control flow stays uniform in the pair); the chain walk's W columns
//     stay in registers until the walk ends, then thread t of the pair
//     writes columns t, t + 2, ... (the extension: words t and t + 2 of
//     its three), so a warp's stores cover contiguous runs of its lanes'
//     rows.  The inverse-Psi walk's pair ranks one row in two pieces; the
//     base code at the offset comes from the piece that holds its word,
//     and the popcounts are added, by shuffles;
//   - blocks of 64 threads: the forward walk's and the exact rerun's
//     8,192 lanes make 256 blocks, every SM has lanes.
// The walks' sizes were chosen on the H100 (PERF.md): four threads a
// chain-walk lane (two a row) step a lane faster, two run more lanes at
// once, and the seeder's walks (65 forward calls of 8,192 lanes and 8
// backward calls of 196,608 lanes a chunk) take the least card time at
// two; a second thread a row pays off for the inverse-Psi walk.  The
// extension takes the chain walk's pair: it is as fast as one thread a
// lane on the exact rerun's 8,192-lane calls and slower on its L2-warm
// 131,072-lane batches, where many lanes rank in the same rows.  The
// latency of the dependent chain stays: chip_smoke.py measures it (the
// chain walk at 32 lanes, W = 1 against W = 10).
//
// The lane arithmetic is shared between the card and a host build (the
// index, the ranks and the extension live in fm_rank.cuh, which
// smem_seed.cu includes too): the extension and the walk loops take the
// ranks as a functor, which on the
// card is the pair's shuffles and on the host a loop over the same
// pieces, so the CPU tests run the arithmetic of every piece.
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
#include <cstring>

#include "compact.cuh"
#include "fm_rank.cuh"

namespace {

constexpr int kPsiPieces = 2;   // pieces of an inverse-Psi rank, a thread each
constexpr int kMaxW = 10;                       // a window packs into 30 bits

// W extensions of one lane over the 3-bit codes of window word wv; the
// state after column j goes to ck[j], cl[j], cs[j] (j < W).  ranks(a, b,
// tk, tl) gives occ4 at a and at b.  Returns the number of steps taken.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks>
FM_HD int chain_walk(const FmPacked<T>& fm, long long wv, int W, T k, T l,
                     T s, bool alive, bool is_back, bool has_stop, T stop,
                     T ck[kMaxW], T cl[kMaxW], T cs[kMaxW],
                     const Ranks& ranks) {
  int ln = 0;
  FM_UNROLL
  for (int j = 0; j < kMaxW; ++j) {
    if (j < W) {
      const int base = (int)((wv >> (3 * j)) & 7);
      const bool step = alive && base <= 3;
      if (step) {
        const T ik[3] = {k, l, s};
        const T xm1 = wsub(is_back ? k : l, (T)1);
        T tk[4], tl[4], o[3];
        ranks(xm1, wadd(xm1, s), tk, tl);
        child_of(fm, ik, is_back ? base : 3 - base, is_back, tk, tl, o);
        k = o[0];
        l = o[1];
        s = o[2];
        ++ln;
      }
      ck[j] = k;
      cl[j] = l;
      cs[j] = s;
      alive = step && (!has_stop || s >= stop);
    }
  }
  return ln;
}

// One LF step (bwt_invPsi; ops/fm.py::inv_psi_batch): the row at
// x = k - (k > primary) serves both the base and its rank.
// pieces(row, off, pc, code) gives the summed popcounts and the code.
FM_FUNCTOR_CALLER
template <typename T, typename Pieces>
FM_HD T inv_psi(const FmPacked<T>& fm, T k, const Pieces& pieces) {
  const T x = (long long)k > fm.primary ? wsub(k, (T)1) : k;
  const long long row = row_of(fm.n_rows, fm.fill_oob, (long long)x);
  const int off = (int)((long long)x & 127);
  const Quarter cnt = load_quarter(fm.rows, row, 0);
  uint32_t pc;
  int c;
  pieces(row, off, pc, c);
  const T occ = rank_of<T>(sel4(cnt.w, c), pc, c);
  return (long long)k == fm.primary ? (T)0 : wadd(sel4(fm.L2, c), occ);
}

// Up to n masked steps of one lane (ops/fm.py::_walk_plain).
FM_FUNCTOR_CALLER
template <typename T, typename Pieces>
FM_HD void inv_psi_walk(const FmPacked<T>& fm, T& kk, T& steps, bool& alive,
                        int n_steps, long long mask, const Pieces& pieces) {
  for (int i = 0; i < n_steps && alive; ++i) {
    kk = inv_psi(fm, kk, pieces);
    steps = wadd(steps, (T)1);
    alive = ((long long)kk & mask) != 0;
  }
}

// A stage entry of one sa_batch_compact call on the kernels
// (ops/fm_cuda.SaLoop): its words, one 64-bit word a field
// (ops/fm_cuda.SA_ARGS).
struct SaArgs {
  // 1 for an int64_t index type
  long long idx64;
  // a stage's lanes, n of each: kk, steps (index type), alive (a byte a
  // lane) and slot (int32: the lane's output index, -1 once it is
  // written; 0 in the first stage, whose lane i has slot i)
  long long kk, steps, alive, slot, n;
  // the next stage's lanes (w of each), which the stage entry writes;
  // w = 0: no next stage (the call's last launch)
  long long next_kk, next_steps, next_alive, next_slot, w;
  // the call's positions (N, index type), read by the first boundary;
  // out_steps, out_k (N, index type) and ovf (one bool): the outputs
  long long kk0, out_steps, out_k, ovf;
  // int32 words: the entry's ticket counter and look-back epoch (the
  // walk's retire word follows them, ops/fm_cuda.SaLoop.words); the
  // look-back's status words, one a block of the widest entry
  long long sc, lb;
  // open: the entry runs the loop's first test (the boundary before the
  // last stage); the WHILE node's condition handle (0 outside a graph)
  // and go (one int32, the condition's last value)
  long long open, cond, go;
};

constexpr int kSaTicket = 0, kSaEpoch = 1;  // words of sc

// The suffix-array walk's lanes as the stage entry moves them
// (compact.cuh): slot (int32), kk and steps (T), alive; a filler's slot -1.
template <typename T>
FM_HD LaneSet<T, 1, 2> sa_lanes(const SaArgs& a) {
  LaneSet<T, 1, 2> s;
  s.src32[0] = (const int32_t*)a.slot;
  s.srcT[0] = (const T*)a.kk;
  s.srcT[1] = (const T*)a.steps;
  s.src_alive = (const bool*)a.alive;
  s.dst32[0] = (int32_t*)a.next_slot;
  s.dstT[0] = (T*)a.next_kk;
  s.dstT[1] = (T*)a.next_steps;
  s.dst_alive = (bool*)a.next_alive;
  s.pad32[0] = -1;
  return s;
}

// Lane i of a stage whose slot s was read (the first stage's is i): its
// words.
template <typename T>
FM_HD void sa_load(const LaneSet<T, 1, 2>& ln, long long i, int32_t s,
                   typename LaneSet<T, 1, 2>::Lane& x) {
  x.i32[0] = s;
  x.t[0] = ln.srcT[0][i];
  x.t[1] = ln.srcT[1][i];
}

// A lane of a stage: a done one (dead, a slot held) written out (JAX
// fm.py:286-291); a live one of the first stage given its output's first
// values (steps 0, the call's position: JAX fm.py:262-263).
template <typename T>
FM_HD void sa_out(const SaArgs& a, long long i, bool live,
                  const typename LaneSet<T, 1, 2>::Lane& x) {
  T* out_steps = (T*)a.out_steps;
  T* out_k = (T*)a.out_k;
  if (!live) {
    out_steps[x.i32[0]] = x.t[1];
    out_k[x.i32[0]] = x.t[0];
  } else if (!a.slot) {
    out_steps[i] = (T)0;
    out_k[i] = ((const T*)a.kk0)[i];
  }
}

// The boundary's end once the stage's live lanes are counted: ovf |= live
// > w (the first boundary sets it), and with `open` go = live > 0, the
// loop's first test.  Returns live > 0.
FM_HD bool sa_close(const SaArgs& a, long long live) {
  bool* ovf = (bool*)a.ovf;
  *ovf = (a.slot && *ovf) || live > a.w;
  if (a.open) *(int32_t*)a.go = live > 0 ? 1 : 0;
  return live > 0;
}

// Whether the words name what a stage entry reads and writes: the
// launcher refuses any others.
inline bool sa_words_ok(const SaArgs& a) {
  if (a.n < 1 || a.n >= INT32_MAX || !a.kk || !a.steps || !a.alive)
    return false;
  if (!a.out_steps || !a.out_k || (!a.slot && !a.kk0) || a.w < 0 ||
      a.w > a.n)
    return false;
  if (a.w > 0 && (!a.next_kk || !a.next_steps || !a.next_alive ||
                  !a.next_slot || !a.ovf || !a.sc || !a.lb))
    return false;
  return !a.open || (a.w > 0 && a.go);
}

#ifdef __CUDACC__
constexpr int kBlock = 64;          // threads a block

// pieces(row, off, pc, code) of an inverse-Psi lane: one piece a thread
// of the pair, the popcounts and the code (held by one piece) summed by
// shuffles.
template <typename T>
struct PairPieces {
  const FmPacked<T>& fm;
  Pair p;
  __device__ void operator()(long long row, int off, uint32_t& pc,
                             int& code) const {
    pc = rank_piece(fm.rows, row, p.t, kPsiPieces, off, &code);
    pc += p.other(pc);
    code += (int)p.other((uint32_t)code);
  }
};

// v[c] for the c of this thread's column, by selects.
template <typename T>
__device__ T pick(const T v[kMaxW], int c) {
  T x = v[0];
  FM_UNROLL
  for (int j = 1; j < kMaxW; ++j)
    if (j == c) x = v[j];
  return x;
}

// Both threads of a pair load the lane's ik (a broadcast); thread t
// writes words t and t + 2 of its three.
template <typename T>
__global__ void __launch_bounds__(kBlock) fm_extend_sel_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const T* __restrict__ ik, const int* __restrict__ c, int is_back,
    T* __restrict__ out, long long n) {
  const long long i = ((long long)blockIdx.x * kBlock + threadIdx.x) / 2;
  if (i >= n) return;                   // a whole pair
  const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
  const PairRanks<T> ranks{fm, Pair()};
  const T in[3] = {ik[3 * i], ik[3 * i + 1], ik[3 * i + 2]};
  T o[3];
  extend_sel(fm, in, c[i], is_back != 0, o, ranks);
  const int t = ranks.p.t;
  out[3 * i + t] = t ? o[1] : o[0];
  if (t == 0) out[3 * i + 2] = o[2];
}

template <typename T>
__global__ void __launch_bounds__(kBlock) fm_chain_walk_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const long long* __restrict__ wv, const T* __restrict__ k,
    const T* __restrict__ l, const T* __restrict__ s,
    const uint8_t* __restrict__ valid, const T* __restrict__ stop_s,
    int is_back, int W, T* __restrict__ ck, T* __restrict__ cl,
    T* __restrict__ cs, int* __restrict__ ln, long long n) {
  const long long i = ((long long)blockIdx.x * kBlock + threadIdx.x) / 2;
  if (i >= n) return;                   // a whole pair
  const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
  const PairRanks<T> ranks{fm, Pair()};
  T vk[kMaxW] = {}, vl[kMaxW] = {}, vs[kMaxW] = {};
  const int len = chain_walk(fm, wv[i], W, k[i], l[i], s[i], valid[i] != 0,
                             is_back != 0, stop_s != nullptr,
                             stop_s ? stop_s[i] : (T)0, vk, vl, vs, ranks);
  const size_t o = (size_t)i * W;
  const int t = ranks.p.t;
  FM_UNROLL
  for (int r = 0; r < (kMaxW + 1) / 2; ++r) {
    const int col = t + 2 * r;
    if (col < W) {
      ck[o + col] = pick(vk, col);
      cl[o + col] = pick(vl, col);
      cs[o + col] = pick(vs, col);
    }
  }
  if (t == 0) ln[i] = len;
}

// The walk's end when it ends the suffix-array loop's body: the retire
// word (64 bits, 0 between launches), the WHILE node's condition handle
// (0 outside a graph) and go; retire null for a walk of its own.
struct SaTail {
  unsigned long long* retire;
  long long cond;
  int32_t* go;
};

// The loop's test after a round, live > 0, by the walk's last block to
// retire (retire_last), in go and the WHILE node's condition.  Every
// thread of every block calls it with its lane's live count.
__device__ __forceinline__ void sa_tail(const SaTail& tail, int live) {
  int total;
  if (!retire_last<kBlock / 32>(tail.retire, live, gridDim.x, &total))
    return;
  *tail.go = total > 0 ? 1 : 0;
  if (tail.cond)
    cudaGraphSetConditional((cudaGraphConditionalHandle)tail.cond, total > 0);
}

// The lane words are not __restrict__: the walk may run in place.
template <typename T>
__global__ void __launch_bounds__(kBlock) fm_inv_psi_walk_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const T* kk, const T* steps, const uint8_t* alive, int n_steps,
    long long mask, T* kk_out, T* steps_out, uint8_t* alive_out,
    long long n, SaTail tail) {
  const long long i = ((long long)blockIdx.x * kBlock + threadIdx.x) / 2;
  bool a = false;
  if (i < n) {                          // a whole pair
    const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
    const PairPieces<T> pieces{fm, Pair()};
    T k = kk[i], st = steps[i];
    a = alive[i] != 0;
    inv_psi_walk(fm, k, st, a, n_steps, mask, pieces);
    if (pieces.p.t == 0) {
      kk_out[i] = k;
      alive_out[i] = a ? 1 : 0;
    } else {
      steps_out[i] = st;
    }
  }
  if (tail.retire) sa_tail(tail, (threadIdx.x & 1) == 0 && a);
}

// A boundary between two stages of the suffix-array walk, or with no
// next stage (w = 0) the call's last launch (the done lanes alone: no
// ticket, no scan).  Blocks of kEntryBlock threads, kEntryItems
// consecutive lanes a thread.
template <typename T>
__global__ void __launch_bounds__(kEntryBlock) sa_stage_entry_kernel(
    const SaArgs a) {
  using L = LaneSet<T, 1, 2>;
  const L ln = sa_lanes<T>(a);
  bool live[kEntryItems];
  typename L::Lane x[kEntryItems];
  // a thread's lanes: the live and the done ones' words loaded, the
  // done ones written out (a filler, dead with slot -1, reads nothing
  // more)
  const auto lanes = [&](long long i0) {
    FM_UNROLL
    for (int j = 0; j < kEntryItems; ++j) {
      const long long i = i0 + j;
      if (i >= a.n) continue;
      const int32_t s = a.slot ? ln.src32[0][i] : (int32_t)i;
      if (!live[j] && s < 0) continue;
      sa_load(ln, i, s, x[j]);
      sa_out<T>(a, i, live[j], x[j]);
    }
  };
  if (a.w == 0) {
    tile_alive(ln.src_alive, a.n, blockIdx.x, live);
    lanes(tile_lane0(blockIdx.x));
    return;
  }
  int32_t* sc = (int32_t*)a.sc;
  const unsigned epoch = (unsigned)sc[kSaEpoch] + 1u;
  const TileRank r = rank_tile<true>(
      ln.src_alive, a.n, sc + kSaTicket, (unsigned long long*)a.lb, epoch,
      live, [&](long long i0) {
        // this ticket's tile of the next stage's lanes cleared (fillers)
        // and the clears made visible before the scan publishes the
        // tile's count (a release: this fence, then the barrier before
        // the look-back's store of the count): a lane moved into the tile
        // comes from this tile or a later one, whose block stores only
        // after its look-back has read that count or a later block's
        // prefix, and fenced (rank_tile<true>: an acquire, and a release
        // of its own prefix for the blocks after it)
        FM_UNROLL
        for (int j = 0; j < kEntryItems; ++j)
          if (i0 + j < a.w) ln.pad(i0 + j);
        lanes(i0);
        __threadfence();
      });
  store_ranked(ln, r.rank, live, x, a.w);
  if (r.t == (int)gridDim.x - 1 && threadIdx.x == 0) {
    sc[kSaEpoch] = (int32_t)epoch;
    const bool go = sa_close(a, r.upto);
    if (a.open) loop_cond(a, go);
  }
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kBlock - 1) / kBlock);
}

template <typename T>
int launch_extend_sel(const uint32_t* rows, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const void* ik,
                      const int* c, int is_back, void* out, long long n,
                      void* stream) {
  fm_extend_sel_kernel<T>
      <<<blocks_for(2 * n), kBlock, 0, (cudaStream_t)stream>>>(
          rows, n_rows, (const T*)L2, primary, fill_oob, (const T*)ik, c,
          is_back, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain_walk(const uint32_t* rows, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const long long* wv,
                      const void* k, const void* l, const void* s,
                      const uint8_t* valid, const void* stop_s, int is_back,
                      int W, void* ck, void* cl, void* cs, int* ln,
                      long long n, void* stream) {
  fm_chain_walk_kernel<T>
      <<<blocks_for(2 * n), kBlock, 0, (cudaStream_t)stream>>>(
          rows, n_rows, (const T*)L2, primary, fill_oob, wv, (const T*)k,
          (const T*)l, (const T*)s, valid, (const T*)stop_s, is_back, W,
          (T*)ck, (T*)cl, (T*)cs, ln, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv_psi_walk(const uint32_t* rows, long long n_rows,
                        const void* L2, long long primary, int fill_oob,
                        const void* kk, const void* steps,
                        const uint8_t* alive, int n_steps, long long mask,
                        void* kk_out, void* steps_out, uint8_t* alive_out,
                        long long n, SaTail tail, void* stream) {
  fm_inv_psi_walk_kernel<T>
      <<<blocks_for(2 * n), kBlock, 0, (cudaStream_t)stream>>>(
          rows, n_rows, (const T*)L2, primary, fill_oob, (const T*)kk,
          (const T*)steps, alive, n_steps, mask, (T*)kk_out, (T*)steps_out,
          alive_out, n, tail);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sa_stage(const SaArgs& a, void* stream) {
  const long long tile = kEntryBlock * kEntryItems;
  sa_stage_entry_kernel<T>
      <<<(unsigned)((a.n + tile - 1) / tile), kEntryBlock, 0,
         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#else
// The host loops run the lane routines lane by lane, each pair's ranks
// and pieces one after the other; a lane that would trap on the card
// makes the call return -1.
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
int host_extend_sel(const uint32_t* rows, long long n_rows, const void* L2,
                    long long primary, int fill_oob, const void* ik,
                    const int* c, int is_back, void* out, long long n) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const ThreadRanks<T> ranks{fm};
  const T* in = (const T*)ik;
  T* o = (T*)out;
  return host_lanes(n, [&](long long i) {
    extend_sel(fm, in + 3 * i, c[i], is_back != 0, o + 3 * i, ranks);
  });
}

template <typename T>
int host_chain_walk(const uint32_t* rows, long long n_rows, const void* L2,
                    long long primary, int fill_oob, const long long* wv,
                    const void* k, const void* l, const void* s,
                    const uint8_t* valid, const void* stop_s, int is_back,
                    int W, void* ck, void* cl, void* cs, int* ln,
                    long long n) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const T* stop = (const T*)stop_s;
  const ThreadRanks<T> ranks{fm};
  return host_lanes(n, [&](long long i) {
    T vk[kMaxW], vl[kMaxW], vs[kMaxW];
    ln[i] = chain_walk(fm, wv[i], W, ((const T*)k)[i], ((const T*)l)[i],
                       ((const T*)s)[i], valid[i] != 0, is_back != 0,
                       stop != nullptr, stop ? stop[i] : (T)0, vk, vl, vs,
                       ranks);
    for (int j = 0; j < W; ++j) {
      ((T*)ck)[i * W + j] = vk[j];
      ((T*)cl)[i * W + j] = vl[j];
      ((T*)cs)[i * W + j] = vs[j];
    }
  });
}

// With a tail (go not null) the loop's test after the walk: go = any
// lane alive (the retire word stays 0).
template <typename T>
int host_inv_psi_walk(const uint32_t* rows, long long n_rows, const void* L2,
                      long long primary, int fill_oob, const void* kk,
                      const void* steps, const uint8_t* alive, int n_steps,
                      long long mask, void* kk_out, void* steps_out,
                      uint8_t* alive_out, long long n, int32_t* go) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const auto pieces = [&](long long row, int off, uint32_t& pc, int& code) {
    pc = 0;
    code = 0;
    for (int p = 0; p < kPsiPieces; ++p) {
      int cp;
      pc += rank_piece(rows, row, p, kPsiPieces, off, &cp);
      code += cp;
    }
  };
  const int e = host_lanes(n, [&](long long i) {
    T k = ((const T*)kk)[i], st = ((const T*)steps)[i];
    bool a = alive[i] != 0;
    inv_psi_walk(fm, k, st, a, n_steps, mask, pieces);
    ((T*)kk_out)[i] = k;
    ((T*)steps_out)[i] = st;
    alive_out[i] = a ? 1 : 0;
  });
  if (e || !go) return e;
  long long live = 0;
  for (long long i = 0; i < n; ++i) live += alive_out[i];
  *go = live > 0 ? 1 : 0;
  return 0;
}

// A stage entry lane after lane: the fillers first (the kernel's blocks
// clear their tiles before any lane moves there), the done lanes out,
// the live ones to their running count, then the close.  (sc[kSaEpoch],
// the look-back's epoch, counted as the kernel counts it.)
template <typename T>
void host_sa_stage(const SaArgs& a) {
  const LaneSet<T, 1, 2> ln = sa_lanes<T>(a);
  for (long long r = 0; r < a.w; ++r) ln.pad(r);
  long long live = 0;
  for (long long i = 0; i < a.n; ++i) {
    const bool on = ln.src_alive[i];
    const int32_t s = a.slot ? ln.src32[0][i] : (int32_t)i;
    if (!on && s < 0) continue;
    typename LaneSet<T, 1, 2>::Lane x;
    sa_load(ln, i, s, x);
    sa_out<T>(a, i, on, x);
    if (!on) continue;
    if (live < a.w) ln.store(live, x);
    ++live;
  }
  if (a.w == 0) return;
  ((int32_t*)a.sc)[kSaEpoch] += 1;
  sa_close(a, live);
}
#endif

}  // namespace

// Every entry takes the index as (rows, row count, L2 pointer in the
// index type, primary, fill_oob) and idx64 = 1 for an int64_t index type,
// 0 for int32_t.  The rows are the (n_rows, 16) packed table
// (DeviceFMIndex.occ_packed), 64-byte aligned.  Lane arrays are
// contiguous: ik / out (n,
// 3), c (n,) int32, wv (n,) int64 window words, valid / alive one byte a
// lane, ck / cl / cs (n, W), stop_s null or (n,).  The inverse-Psi walk's
// tail (retire, cond, go: SaTail) is null, 0, null for a walk of its own;
// with a retire word it needs go and a lane.
#ifdef __CUDACC__
extern "C" int fm_extend_sel_launch(const uint32_t* rows, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const void* ik,
                                    const int* c, int is_back, void* out,
                                    long long n, int idx64, void* stream) {
  if (n <= 0) return 0;
  return idx64 ? launch_extend_sel<int64_t>(rows, n_rows, L2, primary,
                                            fill_oob, ik, c, is_back, out, n,
                                            stream)
               : launch_extend_sel<int32_t>(rows, n_rows, L2, primary,
                                            fill_oob, ik, c, is_back, out, n,
                                            stream);
}

extern "C" int fm_chain_walk_launch(const uint32_t* rows, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const long long* wv,
                                    const void* k, const void* l,
                                    const void* s, const uint8_t* valid,
                                    const void* stop_s, int is_back, int W,
                                    void* ck, void* cl, void* cs, int* ln,
                                    long long n, int idx64, void* stream) {
  if (n <= 0) return 0;
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  return idx64 ? launch_chain_walk<int64_t>(rows, n_rows, L2, primary,
                                            fill_oob, wv, k, l, s, valid,
                                            stop_s, is_back, W, ck, cl, cs,
                                            ln, n, stream)
               : launch_chain_walk<int32_t>(rows, n_rows, L2, primary,
                                            fill_oob, wv, k, l, s, valid,
                                            stop_s, is_back, W, ck, cl, cs,
                                            ln, n, stream);
}

extern "C" int fm_inv_psi_walk_launch(const uint32_t* rows, long long n_rows,
                                      const void* L2, long long primary,
                                      int fill_oob, const void* kk,
                                      const void* steps, const uint8_t* alive,
                                      int n_steps, long long mask,
                                      void* kk_out, void* steps_out,
                                      uint8_t* alive_out, long long n,
                                      int idx64, unsigned long long* retire,
                                      long long cond, int32_t* go,
                                      void* stream) {
  if (retire && (!go || n < 1)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const SaTail tail{retire, cond, go};
  return idx64 ? launch_inv_psi_walk<int64_t>(rows, n_rows, L2, primary,
                                              fill_oob, kk, steps, alive,
                                              n_steps, mask, kk_out,
                                              steps_out, alive_out, n, tail,
                                              stream)
               : launch_inv_psi_walk<int32_t>(rows, n_rows, L2, primary,
                                              fill_oob, kk, steps, alive,
                                              n_steps, mask, kk_out,
                                              steps_out, alive_out, n, tail,
                                              stream);
}

// A stage entry from its SaArgs words (ops/fm_cuda.SA_ARGS, in order).
extern "C" int sa_stage_entry_launch(const long long* words, void* stream) {
  SaArgs a;
  memcpy(&a, words, sizeof(SaArgs));
  if (!sa_words_ok(a)) return (int)cudaErrorInvalidValue;
  return a.idx64 ? launch_sa_stage<int64_t>(a, stream)
                 : launch_sa_stage<int32_t>(a, stream);
}

LOOP_GRAPH_ENTRIES(fm)

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* fm_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// A stage entry on the host, from the same words: 0, or -1 for words the
// launcher refuses.
extern "C" int sa_stage_entry_host(const long long* words) {
  SaArgs a;
  memcpy(&a, words, sizeof(SaArgs));
  if (!sa_words_ok(a)) return -1;
  if (a.idx64)
    host_sa_stage<int64_t>(a);
  else
    host_sa_stage<int32_t>(a);
  return 0;
}

// The same lanes on the host; each returns 0, or -1 where a lane would
// trap on the card.
extern "C" int fm_extend_sel_host(const uint32_t* rows, long long n_rows,
                                  const void* L2, long long primary,
                                  int fill_oob, const void* ik, const int* c,
                                  int is_back, void* out, long long n,
                                  int idx64) {
  return idx64 ? host_extend_sel<int64_t>(rows, n_rows, L2, primary,
                                          fill_oob, ik, c, is_back, out, n)
               : host_extend_sel<int32_t>(rows, n_rows, L2, primary,
                                          fill_oob, ik, c, is_back, out, n);
}

extern "C" int fm_chain_walk_host(const uint32_t* rows, long long n_rows,
                                  const void* L2, long long primary,
                                  int fill_oob, const long long* wv,
                                  const void* k, const void* l, const void* s,
                                  const uint8_t* valid, const void* stop_s,
                                  int is_back, int W, void* ck, void* cl,
                                  void* cs, int* ln, long long n, int idx64) {
  if (W < 1 || W > kMaxW) return -1;
  return idx64 ? host_chain_walk<int64_t>(rows, n_rows, L2, primary,
                                          fill_oob, wv, k, l, s, valid,
                                          stop_s, is_back, W, ck, cl, cs, ln,
                                          n)
               : host_chain_walk<int32_t>(rows, n_rows, L2, primary,
                                          fill_oob, wv, k, l, s, valid,
                                          stop_s, is_back, W, ck, cl, cs, ln,
                                          n);
}

extern "C" int fm_inv_psi_walk_host(const uint32_t* rows, long long n_rows,
                                    const void* L2, long long primary,
                                    int fill_oob, const void* kk,
                                    const void* steps, const uint8_t* alive,
                                    int n_steps, long long mask, void* kk_out,
                                    void* steps_out, uint8_t* alive_out,
                                    long long n, int idx64,
                                    unsigned long long* retire,
                                    long long cond, int32_t* go) {
  (void)cond;
  if (retire && (!go || n < 1)) return -1;
  if (!retire) go = nullptr;
  return idx64 ? host_inv_psi_walk<int64_t>(rows, n_rows, L2, primary,
                                            fill_oob, kk, steps, alive,
                                            n_steps, mask, kk_out, steps_out,
                                            alive_out, n, go)
               : host_inv_psi_walk<int32_t>(rows, n_rows, L2, primary,
                                            fill_oob, kk, steps, alive,
                                            n_steps, mask, kk_out, steps_out,
                                            alive_out, n, go);
}

// The ranks of packed rows, piece by piece: for each (row[j], off[j]), the
// counts of quarter 0 plus the popcounts of `pieces` pieces (1 or 2),
// summed as the walks' shuffles sum them, into out[4j..4j+3], and the sum
// of the pieces' codes into code[j].  Returns -1 for another piece count.
extern "C" int fm_rank_pieces_host(const uint32_t* rows, const long long* row,
                                   const int* off, long long n, int pieces,
                                   long long* out, int* code) {
  if (pieces != 1 && pieces != 2) return -1;
  for (long long j = 0; j < n; ++j) {
    const Quarter c = load_quarter(rows, row[j], 0);
    uint32_t pc = 0;
    code[j] = 0;
    for (int p = 0; p < pieces; ++p) {
      int cp;
      pc += rank_piece(rows, row[j], p, pieces, off[j], &cp);
      code[j] += cp;
    }
    for (int b = 0; b < 4; ++b) out[4 * j + b] = rank_of<int64_t>(c.w[b], pc, b);
  }
  return 0;
}
#endif

// The size of SaArgs in words, to check the Python layout against.
extern "C" int fm_sa_args_words() { return (int)(sizeof(SaArgs) / 8); }
