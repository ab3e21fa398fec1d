// The lockstep engines' loops on Hopper: the forward LEP scan and the
// staged backward walk of ops/seedscan.py, and fwd_staged's staged forward
// walk.
//
// In the JAX package all three are device loops: the scan a per-read
// lax.while_loop that make_scan vmaps, each walk a lax.while_loop over
// every lane at once; XLA fuses each body, there is no Pallas source.  The
// port first ran each as batched eager PyTorch steps, one extension launch
// a step and a host test every few steps; here the scan is one launch a
// call, the backward walk one CUDA graph loop a stage and the forward walk
// one launch a stage.
//
// scan_lanes_kernel<T>
//   Replaces compseed_tpu/ops/seedscan.py:62-146 _scan_one (a
//   lax.while_loop at :143 over fori_loops of 8 masked steps), vmapped by
//   make_scan (:148-160), for one lane.  Plain version:
//   compseed_tpu_torch/ops/seedscan.py::_scan_lanes_plain.  Every update
//   of the JAX loop is gated by the lane's own done, so a lane runs its
//   program to its end in one launch, with no loop test: the all-done test
//   every 8 steps changes no lane's result.  A pair of threads a lane
//   (fm_rank.cuh's PairRanks, as smem_strategy_kernel): the forward child
//   of each step is extend_sel(..., is_back = false) by base 3 - q[i], the
//   pair ranking its two occ rows at once; a push writes its row (k, l, s,
//   end, pivot) at min(cnt, capl - 1), as JAX writes a full buffer's last
//   row again, sets ovf and leaves cnt.  An ambiguous base stops the sweep
//   without an extension, and a lane that is not active reads nothing.
//   Deliberate difference: the kernel writes cnt, ovf and the rows < cnt
//   (all capl rows once cnt reaches capl); the rows past cnt are
//   unspecified, where the plain version (and JAX) hold zeros.  Their one
//   reader, build_pool, writes the pool rows it takes past n_valid as
//   zeros (ops/seedscan.py), so the pool equals JAX's.  Zeroing them was
//   most of a call's bytes: 42 of round 2's 53 MB, at one 32-byte sector
//   a word (PERF.md).
// walk_stage_kernel<T>
//   Replaces the body of compseed_tpu/ops/seedscan.py:187-275 walk_stage
//   (a lax.while_loop at :273 over segments of SEG = min(REV_W,
//   max_steps) masked backward steps, fori_loop :258).  Plain version:
//   ops/seedscan.py::_walk_stage_plain.  One launch is one segment: every
//   live lane takes up to min(SEG, max_steps - t) backward extensions from
//   (k, l, s), the base from one packed reverse window a lane a segment
//   (rwflat) or from qflat a step, dying on an ambiguous base, past the
//   read's start or below its min_hits; steps counts the extensions (an
//   mh death counts its killing call, an N or past-start death does not).
//   One thread a lane (ThreadRowRanks): each step issues both of the
//   lane's occ-row reads before it ranks either, a block a tile of 64
//   lanes; a dead lane reads only its alive byte.  The first design, a
//   pair of threads a lane, a row each, held 48 registers a thread (96 a
//   lane); a thread a lane holds 64 (int32), so an SM keeps 1,024 lanes in
//   flight where it kept 672.  Measured against them (PERF.md, H100): K
//   lanes a pair stepped together over a grid of the card's resident
//   blocks striding over the lanes, which covers a stage in about one
//   wave, ran 1.3-2.2x slower than the first design at 589,824 lanes (a
//   pair's lanes one after another; 91 and 153 registers at K = 2 and 4):
//   the walk is bound by the memory system's throughput for its
//   random row reads, not by a wave's latency.
//   The loop's condition, t < max_steps and live > fit, is collective, so
//   it cannot be a lane's: the kernel's last block to retire
//   (loop_graph.cuh::retire_last) adds the segment's steps to t, leaves
//   the live lanes in sc[kLive] and sets go and the WHILE node's
//   condition.  t is a device word, which the next stage of a walk_pool
//   call reads as its t0.
// walk_stage_entry_kernel<T>
//   The loop's entry (compact.cuh): JAX's while_loop tests its cond
//   before the first segment (compseed_tpu/ops/seedscan.py:266-270), and a
//   segment run when live <= fit would move the lanes, so the entry runs
//   that test on the card.  Between the stages of a walk_pool call it also
//   compacts the previous stage's live lanes into this stage's
//   (compseed_tpu/ops/seedscan.py:277-297 compact_state: a stable
//   rank-scatter; segment_entry's look-back scan), the lanes after them
//   pads (dead, slot -1, steps 0, as every dead lane is once walk_pool has
//   written out the finished ones); before a call's first stage it counts
//   the live lanes (count_entry: a count needs no order, so one atomic a
//   block and the last block to retire, no ticket and no look-back).  Plain
//   version: ops/seedscan.py::compact_state and the test of
//   _walk_stage_plain.  A compaction takes the chain's tile, 2 lanes a
//   thread (kEntryItems), a count 8 (kCountItems: its bytes are the alive
//   bytes alone, 8 a load).  Measured at every captured width
//   (24,576-589,824 lanes, PERF.md; scripts/walk_entry_variants.patch
//   rebuilds the variants): a compaction at 4 or 8 lanes a thread took
//   1.8x and 3.5x as long at 589,824 lanes (a thread's consecutive lanes
//   make every load and store of a live lane's words stride over that
//   many more sectors, though the tiles fit in one wave).
//
// fwd_stage_kernel<T>
//   Replaces compseed_tpu/ops/seedscan.py:854-1005 _fwd_stage_walk (a
//   lax.while_loop at :1005 over segments of 8 guarded steps, :992-997,
//   with the cond any(alive & pos < pos_end) at :1001-1003): one stage of
//   the staged forward walk of fwd_staged (forward_scan_dedup, :1020),
//   the LEP sweep ("lep") or round 3's greedy segment ("r3"), with the
//   in-window respawn, the jump through nxtflat and the park for the
//   boundary respawn (advance).  Plain version: ops/seedscan.py::
//   _fwd_stage_walk_plain.  One launch a stage and no loop test: a lane
//   that is not active (dead, or its position past its window) never
//   becomes active again within the stage (a respawn needs a stop, a stop
//   an active lane), so each lane runs its steps j < B while it is active,
//   and the all-lanes test every 8 steps changes no lane's state and no
//   record that pf marks.  A pair of threads a lane (PairRanks): the
//   forward child of base 3 - q[pos] at the l coordinate (extend_sel,
//   is_back = false); "r3" extends at an ambiguous base too (by child 0),
//   since its record is the extension's output, pushed or not.  A warp
//   steps its 16 lanes kFwdSeg = 8 steps at a time (each lane while it is
//   active), stages the records in shared memory and flushes the segment
//   whole, a lane's 8 columns from 8 consecutive threads; past its last
//   segment it writes pf false in its lanes' remaining columns.  The
//   wrapper allocates the records uninitialised: no zeroing.
//   Deliberate difference: of the records (U, B), pf is written in every
//   column (false past the lane's steps), pk, pl, ps, pe, pp for the
//   lane's steps j < steps[u] only, as the JAX body writes them, pushed
//   or not; past steps[u] those five are unspecified, where the plain
//   version (and JAX) write the lane's frozen values with pf false.
//   forward_scan_dedup reads no record whose pf is false (each goes to
//   the dropped slot GP).
//
// T is the index type (int32_t or int64_t); arithmetic on intervals wraps
// in T as the plain version's tensors do, and the occ rows are read as
// fm_walk.cu reads them (fm_rank.cuh: fill_oob's all-ones row for a block
// outside the table where the seeder sets it, else a trap; fwd_staged
// sets it, so a representative past a rep-cap overflow, whose interval is
// garbage, reads that row).
//
// What bounds them: each lane is a chain of dependent extensions, each two
// random occ rows, one a thread of the pair; the bytes a call needs (the
// distinct rows and the lanes' words, ops/lockstep_cases.py counts them)
// are a few MB, so the bound by HBM bytes is microseconds.  The scan and
// the forward stage run in about one wave, so the latency of the longest
// lane's dependent steps decides: a round-1 scan lane takes some 100-300
// extensions, a forward stage at most B (8 to L + 2).  A walk segment (at
// most 8 steps) is 262,144-589,824 lanes wide, 2.5-5 waves: there the rate
// at which the memory system serves the rows' random 16-byte reads (each
// from L2: the table is 1 MB) decides.  The forward stage's records are
// (U, B) rows, one a lane (forward_scan_dedup gathers them by row): what a
// stage must write is pf for every column and the five others for the
// steps taken, so it zeroes nothing and stores whole segments of a row.
//
// The launchers allocate nothing, launch on the given stream of the
// calling thread's current device (ops/lockstep_cuda.py makes the tensors'
// device current) and return the CUDA error code.  Compiled as C++ without
// nvcc, the same lane routines run in host loops (scan_lanes_host,
// walk_stage_host, walk_stage_entry_host, fwd_stage_host), for the CPU
// tests.

#include <cstdint>
#include <cstring>

#include "compact.cuh"
#include "fm_rank.cuh"

namespace {

// ---------------------------------------------------------------------------
// The scan

// L2[c] for c in [0, 4] by selects.
template <typename T>
FM_HD T l2_at(const FmPacked<T>& fm, int c) {
  return c == 4 ? fm.L2[4] : sel4(fm.L2, c);
}

// The bi-interval of the single base c in [0, 3] (seedscan._set_intv).
template <typename T>
FM_HD void set_intv(const FmPacked<T>& fm, int c, T ik[3]) {
  ik[0] = wadd(l2_at(fm, c), (T)1);
  ik[1] = wadd(l2_at(fm, 3 - c), (T)1);
  ik[2] = wsub(l2_at(fm, c + 1), l2_at(fm, c));
}

// q[clip(i, 0, L - 1)] of a lane's read.
FM_HD int char_at(const uint8_t* q, int i, int L) {
  return q[i < 0 ? 0 : i > L - 1 ? L - 1 : i];
}

// A lane's min_hits, int32 or int64 as given, in T (as .to(dt) casts it).
template <typename T>
FM_HD T hits_at(const void* min_hits, int hits64, long long lane) {
  return hits64 ? (T)((const int64_t*)min_hits)[lane]
                : (T)((const int32_t*)min_hits)[lane];
}

// One lane's forward pass (JAX seedscan.py:86-134): at phase 0 a pivot
// starts (the single-base interval) or is skipped (an ambiguous base);
// at phase 1 one forward step, which pushes (k, l, s, end, pivot) when
// the interval changes or the base is ambiguous (past rlen: ambiguous),
// and stops when the base is ambiguous or the changed interval falls
// below min_hits; after a stop the lane moves to its next pivot
// (advance) or ends.  push(slot, row) stores a row; cnt and ovf the count
// and the overflow.  A lane that is not active does nothing.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks, typename Push>
FM_HD void scan_lane(const FmPacked<T>& fm, const uint8_t* q, int L, int rlen,
                     int pivot, T min_hits, bool active, bool advance,
                     int capl, const Ranks& ranks, const Push& push, int& cnt,
                     bool& ovf) {
  const T mh = min_hits < (T)1 ? (T)1 : min_hits;
  int i = 0, end = 0;
  bool sweep = false;
  T ik[3] = {0, 0, 0};
  cnt = 0;
  ovf = false;
  if (!active) return;
  for (;;) {
    if (!sweep) {
      if (pivot >= rlen) return;
      const int b0 = char_at(q, pivot, L);
      if (b0 > 3) {
        ++pivot;
        continue;
      }
      set_intv(fm, b0, ik);
      end = i = pivot + 1;
      sweep = true;
    }
    const int base = i < rlen ? char_at(q, i, L) : 4;
    const bool amb = base > 3;
    T okc[3] = {0, 0, 0};
    bool changed = false;
    if (!amb) {
      extend_sel(fm, ik, 3 - base, false, okc, ranks);
      changed = okc[2] != ik[2];
    }
    if (amb || changed) {
      const T row[5] = {ik[0], ik[1], ik[2], (T)end, (T)pivot};
      push(cnt < capl - 1 ? cnt : capl - 1, row);
      ovf = ovf || cnt >= capl;
      if (cnt < capl) ++cnt;
    }
    if (amb || (changed && okc[2] < mh)) {
      if (!advance) return;
      pivot = amb ? i + 1 : i;
      sweep = false;
    } else {
      for (int k = 0; k < 3; ++k) ik[k] = okc[k];
      end = i = i + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// The walk: a stage's words, one 64-bit word a field (ops/lockstep_cuda.py
// WALK_ARGS names them in order).  compact.cuh and loop_graph.cuh read the
// loop's words by their names there: rnd is the walk's t, rcap its
// max_steps and nxtw its fit.
struct WalkArgs {
  // 1 for an int64_t index type
  long long idx64;
  // the index: the (n_rows, 16) packed occ rows, L2 (5, index type),
  // primary, fill_oob
  long long rows, n_rows, L2, primary, fill_oob;
  // the stage's lanes, w of each: k, l, s, mh (index type); rid, i,
  // death, slot, steps (int32; steps 0: not counted); alive (bool)
  long long k, l, s, mh, rid, i, death, slot, steps, alive, w;
  // the bases: rwflat (int64 packed reverse windows) or, when it is 0,
  // qflat (uint8 codes), n_q words or codes; the read length L
  long long rwflat, qflat, n_q, L;
  // the loop: t (one int32, the steps spent across a call's stages),
  // max_steps, fit, SEG, a live-lane histogram (none: 0)
  long long rnd, rcap, nxtw, seg, hist;
  // int32 words [live, ticket, epoch, -, retire (64 bits, words 4-5)];
  // the entry's look-back status words (a word a block)
  long long sc, lb_entry;
  // the entry's source: the previous stage's lanes (src_w of each, in the
  // order of the lane words above) and its live count (one int32); src_w
  // 0 before a call's first stage
  long long src_k, src_l, src_s, src_mh, src_rid, src_i, src_death, src_slot,
      src_steps, src_alive, src_w, live_in;
  // the WHILE node's condition handle (0 outside a graph), go (one int32,
  // the condition's last value) and loop (1: the stage kernel ends a
  // loop's body; 0, a launch of its own: it touches no loop word)
  long long cond, go, loop;
};

constexpr int kLive = 0, kTicket = 1, kEpoch = 2, kRetire = 4;  // sc words

// A walk stage's lane arrays as the entry moves them: rid, i, death, slot,
// steps and k, l, s, mh; a pad is dead with slot -1, the rest 0.
template <typename T>
FM_HD LaneSet<T, 5, 4> stage_lanes(const WalkArgs& a) {
  LaneSet<T, 5, 4> s;
  const long long src32[5] = {a.src_rid, a.src_i, a.src_death, a.src_slot,
                              a.src_steps};
  const long long dst32[5] = {a.rid, a.i, a.death, a.slot, a.steps};
  const long long srcT[4] = {a.src_k, a.src_l, a.src_s, a.src_mh};
  const long long dstT[4] = {a.k, a.l, a.s, a.mh};
  for (int j = 0; j < 5; ++j) {
    s.src32[j] = (const int32_t*)src32[j];
    s.dst32[j] = (int32_t*)dst32[j];
    s.pad32[j] = j == 3 ? -1 : 0;
  }
  for (int j = 0; j < 4; ++j) {
    s.srcT[j] = (const T*)srcT[j];
    s.dstT[j] = (T*)dstT[j];
  }
  s.src_alive = (const bool*)a.src_alive;
  s.dst_alive = (bool*)a.alive;
  return s;
}

// Whether the words name what the stage kernel and the entry read and
// write: the launchers refuse any others.
inline bool walk_words_ok(const WalkArgs& a) {
  if (a.w < 1 || a.w >= INT32_MAX || !a.rows || !a.L2 || a.L < 1 ||
      a.n_q < 1 || a.seg < 1 || a.seg > 8 || !a.rnd || !a.sc || !a.lb_entry)
    return false;
  if (!a.k || !a.l || !a.s || !a.mh || !a.rid || !a.i || !a.death ||
      !a.slot || !a.alive || (!a.rwflat && !a.qflat))
    return false;
  if (a.loop && !a.go) return false;
  if (a.src_w < 0 || a.src_w >= INT32_MAX) return false;
  return a.src_w == 0 ||
         (a.src_w >= a.w && a.steps && a.src_k && a.src_l && a.src_s &&
          a.src_mh && a.src_rid && a.src_i && a.src_death && a.src_slot &&
          a.src_steps && a.src_alive && a.live_in);
}

// One lane of a walk stage, as its words stand.
template <typename T>
struct WalkLane {
  T k, l, s, mh;
  int32_t rid, i, death, steps;
  bool alive;
};

// The segment's steps before it: min(SEG, max_steps - t).
FM_HD int seg_steps(const WalkArgs& a, int32_t t) {
  const long long left = a.rcap - t;
  return (int)(left < a.seg ? left : a.seg);
}

// A lane's segment (JAX seedscan.py:222-248, n steps): the bases from one
// window gather (rwflat: a lane alive at local step tl sits at i0 - tl) or
// one qflat read a step; below position 0 the base is 4.  A dead lane
// reads nothing.
FM_FUNCTOR_CALLER
template <typename T, typename Ranks>
FM_HD void walk_lane(const FmPacked<T>& fm, const WalkArgs& a,
                     WalkLane<T>& x, int n, const Ranks& ranks) {
  if (!x.alive || n <= 0) return;
  const long long L = a.L, last = a.n_q - 1;
  const bool packed = a.rwflat != 0;
  long long win = 0;
  if (packed) {
    const long long i0 = x.i < 0 ? 0 : x.i > L - 1 ? L - 1 : x.i;
    long long j = (long long)x.rid * L + i0;
    j = j < 0 ? 0 : j > last ? last : j;
    win = ((const long long*)a.rwflat)[j];
  }
  for (int tl = 0; tl < n; ++tl) {
    int src;
    if (packed) {
      src = (int)((win >> (3 * tl)) & 7);
    } else {
      long long j = (long long)x.rid * L + x.i;
      j = j < 0 ? 0 : j > last ? last : j;
      src = ((const uint8_t*)a.qflat)[j];
    }
    const int base = x.i >= 0 ? src : 4;
    if (base > 3) {
      x.death = x.i;
      x.alive = false;
      return;
    }
    const T ik[3] = {x.k, x.l, x.s};
    T okc[3];
    extend_sel(fm, ik, base, true, okc, ranks);
    ++x.steps;
    if (okc[2] >= x.mh) {
      x.k = okc[0];
      x.l = okc[1];
      x.s = okc[2];
      x.i -= 1;
    } else {
      x.death = x.i;
      x.alive = false;
      return;
    }
  }
}

// Lane j of a stage: its alive byte, then, for a live lane, its other
// words; a dead lane reads nothing more.
template <typename T>
FM_HD WalkLane<T> load_lane(const WalkArgs& a, long long j) {
  WalkLane<T> x{};
  x.alive = ((const bool*)a.alive)[j];
  if (!x.alive) return x;
  x.k = ((const T*)a.k)[j];
  x.l = ((const T*)a.l)[j];
  x.s = ((const T*)a.s)[j];
  x.mh = ((const T*)a.mh)[j];
  x.rid = ((const int32_t*)a.rid)[j];
  x.i = ((const int32_t*)a.i)[j];
  x.death = ((const int32_t*)a.death)[j];
  x.steps = a.steps ? ((const int32_t*)a.steps)[j] : 0;
  return x;
}

// The words of a lane a segment changes.
template <typename T>
FM_HD void store_lane(const WalkArgs& a, long long j, const WalkLane<T>& x) {
  ((T*)a.k)[j] = x.k;
  ((T*)a.l)[j] = x.l;
  ((T*)a.s)[j] = x.s;
  ((int32_t*)a.i)[j] = x.i;
  ((int32_t*)a.death)[j] = x.death;
  if (a.steps) ((int32_t*)a.steps)[j] = x.steps;
  ((bool*)a.alive)[j] = x.alive;
}

// The loop's step after a segment of n steps from t that leaves `live`
// live lanes: t += n, sc[kLive] = live, then loop_go (go and the
// histogram word).  Returns go.
FM_HD bool walk_after(const WalkArgs& a, int32_t t, int n, int32_t live) {
  *(int32_t*)a.rnd = t + n;
  ((int32_t*)a.sc)[kLive] = live;
  return loop_go(a, t + n, live);
}

// ---------------------------------------------------------------------------
// The staged forward walk: a stage's words, one 64-bit word a field
// (ops/lockstep_cuda.py FWD_ARGS names them in order).
struct FwdArgs {
  // 1 for an int64_t index type
  long long idx64;
  // the index, as WalkArgs'
  long long rows, n_rows, L2, primary, fill_oob;
  // the stage's representatives, U of each: k, l, s, mh (index type);
  // pos, pivot, rid (int32); alive (bool)
  long long k, l, s, mh, pos, pivot, rid, alive, U;
  // the bases: qflat (uint8 codes) and nxtflat (int32: the next
  // non-ambiguous position), n_q of each; the read length L; the stage's
  // steps B
  long long qflat, nxtflat, n_q, L, B;
  // 1: round 3's greedy segment, 0: the LEP sweep; 1: respawn in the
  // window (advance); round 3's min_len and max_intv
  long long r3, advance, min_len, max_intv;
  // the state after the stage, U of each: k, l, s (index type); pos,
  // pivot, wait_npv, steps (int32); alive, waiting (bool)
  long long out_k, out_l, out_s, out_pos, out_pivot, out_wait_npv, out_steps,
      out_alive, out_waiting;
  // the records, (U, B) each: pf (bool); pk, pl, ps (index type); pe, pp
  // (int32); the kernel writes pf in every column, the others for a
  // lane's steps j < steps only
  long long pf, pk, pl, ps, pe, pp;
};

// Whether the words name what the stage kernel reads and writes: the
// launcher refuses any others.
inline bool fwd_words_ok(const FwdArgs& a) {
  if (a.U < 1 || a.U >= INT32_MAX || a.B < 1 || a.B > INT32_MAX / 2 ||
      a.L < 1 || a.L > INT32_MAX / 2 || a.n_q < 1 || !a.rows || !a.L2)
    return false;
  const long long need[] = {
      a.k, a.l, a.s, a.mh, a.pos, a.pivot, a.rid, a.alive, a.qflat,
      a.nxtflat, a.out_k, a.out_l, a.out_s, a.out_pos, a.out_pivot,
      a.out_wait_npv, a.out_steps, a.out_alive, a.out_waiting, a.pf, a.pk,
      a.pl, a.ps, a.pe, a.pp};
  for (long long p : need)
    if (!p) return false;
  return true;
}

// One representative of a forward stage as its words stand.
template <typename T>
struct FwdLane {
  T k, l, s, mh;
  int32_t pos, pivot, rid, wait_npv, steps;
  bool alive, waiting;
};

// One step's record: the JAX body's writes at column j (:937-943).
template <typename T>
struct FwdRecord {
  bool push;
  T k, l, s;
  int32_t e, p;
};

// x[clip(rid * L + p, 0, n_q - 1)] of a flat (R, L) array.
FM_HD long long flat_at(const FwdArgs& a, int32_t rid, int32_t p) {
  const long long j = (long long)rid * a.L + p;
  return j < 0 ? 0 : j > a.n_q - 1 ? a.n_q - 1 : j;
}

// The base at p of read rid: 4 from L on.
FM_HD int fwd_base(const FwdArgs& a, int32_t rid, int32_t p) {
  return p < a.L ? ((const uint8_t*)a.qflat)[flat_at(a, rid, p)] : 4;
}

// Whether a representative takes another step of its stage (JAX
// seedscan.py:886-888): alive and inside its window [pos0, pos_end).
template <typename T>
FM_HD bool fwd_active(const FwdLane<T>& x, int32_t pos_end) {
  return x.alive && x.pos < pos_end;
}

// One step of an active representative (JAX seedscan.py:889-988): its
// record, the state after it (steps counted, the in-window respawn).
FM_FUNCTOR_CALLER
template <typename T, typename Ranks>
FM_HD FwdRecord<T> fwd_step(const FmPacked<T>& fm, const FwdArgs& a,
                            FwdLane<T>& x, int32_t pos_end,
                            const Ranks& ranks) {
  const int32_t L = (int32_t)a.L;
  const bool r3 = a.r3 != 0;
  const int32_t pos = x.pos;
  const int base = fwd_base(a, x.rid, pos);
  const bool amb = base > 3;
  T okc[3] = {0, 0, 0};
  if (r3 || !amb) {
    const T ik[3] = {x.k, x.l, x.s};
    extend_sel(fm, ik, 3 - (amb ? 3 : base), false, okc, ranks);
  }
  FwdRecord<T> r;
  bool stop;
  if (r3) {
    // emit the post-extension interval when it first drops below
    // max_intv at length >= min_len (bwt_seed_strategy1)
    const bool hit = !amb && okc[2] < (T)a.max_intv &&
                     (long long)(pos - x.pivot) >= a.min_len;
    stop = hit || amb;
    r = FwdRecord<T>{hit, okc[0], okc[1], okc[2], pos + 1, x.pivot};
  } else {
    const bool changed = !amb && okc[2] != x.s;
    stop = amb || (changed && okc[2] < x.mh);
    r = FwdRecord<T>{amb || changed, x.k, x.l, x.s, pos, x.pivot};
  }
  ++x.steps;
  if (!stop) {
    x.k = okc[0];
    x.l = okc[1];
    x.s = okc[2];
    x.pos = pos + 1;
    return r;
  }
  x.alive = false;
  if (!a.advance) return r;
  // the in-window respawn: a non-ambiguous stop re-consumes pos as the
  // new pivot; an ambiguous one (any stop in round 3) jumps to the next
  // non-ambiguous position inside the window, else parks
  const bool here = !r3 && !amb;
  const int32_t npv = pos + 1;
  const int32_t nx =
      npv < L ? ((const int32_t*)a.nxtflat)[flat_at(a, x.rid, npv)] : L;
  const bool in_win = nx < pos_end && nx < L;
  const bool jumper = r3 || amb;
  const int32_t newpiv = here ? pos : nx;
  const int base_n = fwd_base(a, x.rid, newpiv);
  if ((here || (jumper && in_win)) && base_n < 4) {
    T ik[3];
    set_intv(fm, base_n, ik);
    x.pivot = newpiv;
    x.k = ik[0];
    x.l = ik[1];
    x.s = ik[2];
    x.pos = newpiv + 1;
    x.alive = true;
  }
  if (jumper && !in_win) {
    x.waiting = true;
    x.wait_npv = npv;
  }
  return r;
}

template <typename T>
FM_HD FwdLane<T> fwd_load(const FwdArgs& a, long long u) {
  FwdLane<T> x;
  x.k = ((const T*)a.k)[u];
  x.l = ((const T*)a.l)[u];
  x.s = ((const T*)a.s)[u];
  x.mh = ((const T*)a.mh)[u];
  x.pos = ((const int32_t*)a.pos)[u];
  x.pivot = ((const int32_t*)a.pivot)[u];
  x.rid = ((const int32_t*)a.rid)[u];
  x.alive = ((const bool*)a.alive)[u];
  x.wait_npv = 0;
  x.steps = 0;
  x.waiting = false;
  return x;
}

// The state after the stage; part 0 of 2 the first thread of a pair's
// words (k, s, pos, steps, alive), part 1 the other's (l, pivot,
// wait_npv, waiting), part -1 all of them.
template <typename T>
FM_HD void fwd_store(const FwdArgs& a, long long u, const FwdLane<T>& x,
                     int part) {
  if (part != 1) {
    ((T*)a.out_k)[u] = x.k;
    ((T*)a.out_s)[u] = x.s;
    ((int32_t*)a.out_pos)[u] = x.pos;
    ((int32_t*)a.out_steps)[u] = x.steps;
    ((bool*)a.out_alive)[u] = x.alive;
  }
  if (part != 0) {
    ((T*)a.out_l)[u] = x.l;
    ((int32_t*)a.out_pivot)[u] = x.pivot;
    ((int32_t*)a.out_wait_npv)[u] = x.wait_npv;
    ((bool*)a.out_waiting)[u] = x.waiting;
  }
}

#ifdef __CUDACC__
constexpr int kScanBlock = 64;     // threads a block, 2 a lane
constexpr int kWalkBlock = 64;     // threads a block, 1 a lane
constexpr int kFwdBlock = 64;      // threads a block, 2 a lane
constexpr int kFwdSeg = 8;         // steps a lane stages before a flush
constexpr int kWarpLanes = 16;     // a warp's lanes (pairs)

template <typename T>
__global__ void __launch_bounds__(kScanBlock) scan_lanes_kernel(
    const uint32_t* __restrict__ rows, long long n_rows,
    const T* __restrict__ L2, long long primary, int fill_oob,
    const uint8_t* __restrict__ q, int L, const int32_t* __restrict__ rlen,
    const int32_t* __restrict__ pivot0, const void* __restrict__ min_hits,
    int hits64, const uint8_t* __restrict__ active, int capl, int advance,
    T* __restrict__ lep, T* __restrict__ cnt_out, T* __restrict__ ovf_out,
    long long R) {
  const long long lane =
      ((long long)blockIdx.x * kScanBlock + threadIdx.x) / 2;
  if (lane >= R) return;                // a whole pair
  const FmPacked<T> fm = make_fm(rows, n_rows, L2, primary, fill_oob);
  const PairRanks<T> ranks{fm, Pair()};
  const int t = ranks.p.t;
  T* o = lep + lane * (long long)capl * 5;
  int cnt;
  bool ovf;
  scan_lane(fm, q + lane * (long long)L, L, rlen[lane], pivot0[lane],
            hits_at<T>(min_hits, hits64, lane), active[lane] != 0,
            advance != 0, capl, ranks,
            [&](int slot, const T r[5]) {
              FM_UNROLL
              for (int k = 0; k < 5; ++k)
                if ((k & 1) == t) o[5 * slot + k] = r[k];
            },
            cnt, ovf);
  if (t == 0)
    cnt_out[lane] = (T)cnt;
  else
    ovf_out[lane] = (T)(ovf ? 1 : 0);
}

// A segment of the stage's loop, a thread a lane.  Every thread reads t
// at its start (no block writes it before the last block to retire, which
// is the last to read it); with a.loop the last block to retire advances
// t, leaves the live count and sets go and the WHILE node's condition.
template <typename T>
__global__ void __launch_bounds__(kWalkBlock) walk_stage_kernel(
    const WalkArgs a) {
  const long long j = (long long)blockIdx.x * kWalkBlock + threadIdx.x;
  const int32_t t0 = *(const int32_t*)a.rnd;
  const int n = seg_steps(a, t0);
  bool live = false;
  if (j < a.w) {
    const FmPacked<T> fm = make_fm((const uint32_t*)a.rows, a.n_rows,
                                   (const T*)a.L2, a.primary,
                                   (int)a.fill_oob);
    const ThreadRowRanks<T> ranks{fm};
    WalkLane<T> x = load_lane<T>(a, j);
    const bool was = x.alive;
    walk_lane(fm, a, x, n, ranks);
    if (was) store_lane(a, j, x);
    live = x.alive;
  }
  if (!a.loop) return;
  int total;
  if (retire_last<kWalkBlock / 32>(
          (unsigned long long*)((int32_t*)a.sc + kRetire), live, gridDim.x,
          &total))
    loop_cond(a, walk_after(a, t0, n, total));
}

// The stage's entry (compact.cuh): the previous stage's live lanes
// compacted into this stage's by segment_entry's look-back, or, before a
// call's first stage, its live lanes counted by count_entry (no order: no
// ticket, no look-back); then the live count and the loop's first test,
// the WHILE node's condition set from it inside a graph.
template <typename T>
__global__ void __launch_bounds__(kEntryBlock) walk_stage_entry_kernel(
    const WalkArgs a) {
  if (a.src_w > 0)
    segment_entry<kLive, kTicket, kEpoch>(a, stage_lanes<T>(a));
  else
    count_entry<kLive, kEpoch, kRetire>(a, stage_lanes<T>(a));
}

// A warp's records of one segment of its stage (kFwdSeg steps of each of
// its lanes, row r the warp's r-th lane), staged in shared memory for the
// flush; rows padded to kFwdSeg + 1 words against bank conflicts.
template <typename T>
struct FwdSegment {
  T k[kWarpLanes][kFwdSeg + 1], l[kWarpLanes][kFwdSeg + 1],
      s[kWarpLanes][kFwdSeg + 1];
  int32_t e[kWarpLanes][kFwdSeg + 1], p[kWarpLanes][kFwdSeg + 1];
  bool f[kWarpLanes][kFwdSeg + 1];
  int n[kWarpLanes];                   // each lane's steps in the segment
};

// Step c of the segment of lane r, by thread t of its pair (0: k, s, e;
// 1: l, p, pf).
template <typename T>
__device__ __forceinline__ void fwd_stage_record(FwdSegment<T>& sg, int r,
                                                 int c,
                                                 const FwdRecord<T>& rec,
                                                 int t) {
  if (t == 0) {
    sg.k[r][c] = rec.k;
    sg.s[r][c] = rec.s;
    sg.e[r][c] = rec.e;
  } else {
    sg.l[r][c] = rec.l;
    sg.p[r][c] = rec.p;
    sg.f[r][c] = rec.push;
  }
}

// The warp's segment to the records (columns j0 .. j0 + m - 1 of its
// lanes' rows, from lane u0 on): thread `lt` of the warp takes element lt,
// lt + 32, ..., kFwdSeg consecutive threads a lane's kFwdSeg columns; pf
// for every column, the other five for the lane's steps in it.
template <typename T>
__device__ void fwd_flush(const FwdArgs& a, const FwdSegment<T>& sg,
                          long long u0, int32_t j0, int m, int lt) {
#pragma unroll
  for (int el = lt; el < kWarpLanes * kFwdSeg; el += 32) {
    const int r = el / kFwdSeg, c = el % kFwdSeg;
    const long long u = u0 + r;
    if (u >= a.U || c >= m) continue;
    const long long at = u * a.B + j0 + c;
    const bool stepped = c < sg.n[r];
    ((bool*)a.pf)[at] = stepped && sg.f[r][c];
    if (!stepped) continue;
    ((T*)a.pk)[at] = sg.k[r][c];
    ((T*)a.pl)[at] = sg.l[r][c];
    ((T*)a.ps)[at] = sg.s[r][c];
    ((int32_t*)a.pe)[at] = sg.e[r][c];
    ((int32_t*)a.pp)[at] = sg.p[r][c];
  }
}

// A forward stage: each representative's steps to its end, a pair of
// threads a lane, which run the same program.  A warp steps its lanes a
// segment of kFwdSeg steps at a time while any of them is active, staging
// the records in shared memory, and flushes each segment whole (a lane's
// kFwdSeg columns from kFwdSeg consecutive threads); past its last
// segment it writes pf false in its lanes' remaining columns.  The
// records of the five other kinds past a lane's steps are not written.
template <typename T>
__global__ void __launch_bounds__(kFwdBlock) fwd_stage_kernel(
    const FwdArgs a) {
  __shared__ FwdSegment<T> segs[kFwdBlock / 32];
  const int lt = (int)(threadIdx.x & 31);
  const long long u0 =
      ((long long)blockIdx.x * kFwdBlock + (threadIdx.x & ~31u)) / 2;
  if (u0 >= a.U) return;                // a whole warp
  FwdSegment<T>& sg = segs[threadIdx.x >> 5];
  const int r = lt >> 1;
  const long long u = u0 + r;
  const FmPacked<T> fm = make_fm((const uint32_t*)a.rows, a.n_rows,
                                 (const T*)a.L2, a.primary, (int)a.fill_oob);
  const PairRanks<T> ranks{fm, Pair()};
  const int t = ranks.p.t;
  FwdLane<T> x{};
  if (u < a.U) x = fwd_load<T>(a, u);
  const int32_t B = (int32_t)a.B;
  const int32_t pos_end = x.pos + B;
  bool act = fwd_active(x, pos_end);
  int32_t j0 = 0;
  for (; j0 < B && __any_sync(0xFFFFFFFFu, act); j0 += kFwdSeg) {
    const int m = B - j0 < kFwdSeg ? (int)(B - j0) : kFwdSeg;
    int c = 0;
    for (; c < m && act; ++c) {
      fwd_stage_record(sg, r, c, fwd_step(fm, a, x, pos_end, ranks), t);
      act = fwd_active(x, pos_end);
    }
    if (t == 0) sg.n[r] = c;
    __syncwarp();
    fwd_flush(a, sg, u0, j0, m, lt);
    __syncwarp();
  }
  // no lane of the warp steps from j0 on: pf false there
  for (int rr = 0; rr < kWarpLanes && u0 + rr < a.U; ++rr)
    for (int32_t c = j0 + lt; c < B; c += 32)
      ((bool*)a.pf)[(u0 + rr) * a.B + c] = false;
  if (u < a.U) fwd_store(a, u, x, t);
}

template <typename T>
int launch_fwd(const FwdArgs& a, cudaStream_t st) {
  fwd_stage_kernel<T>
      <<<(unsigned)((2 * a.U + kFwdBlock - 1) / kFwdBlock), kFwdBlock, 0,
         st>>>(a);
  return (int)cudaGetLastError();
}

// What the card gives a kernel launched in blocks of `block` threads, `lanes`
// lanes a block at once, `threads` a lane (out, 6 ints): resident blocks an
// SM, lanes a block, registers a thread, local (spill) bytes a thread,
// static shared bytes a block, threads a lane.
template <typename F>
int kernel_occupancy(F kernel, int block, int lanes, int threads, int* out) {
  int blocks = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, 0);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = lanes;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)fa.sharedSizeBytes;
  out[5] = threads;
  return 0;
}

template <typename T>
int launch_scan(const uint32_t* rows, long long n_rows, const void* L2,
                long long primary, int fill_oob, const uint8_t* q, int L,
                const int32_t* rlen, const int32_t* pivot0,
                const void* min_hits, int hits64, const uint8_t* active,
                int capl, int advance, void* lep, void* cnt, void* ovf,
                long long R, void* stream) {
  const long long threads = 2 * R;
  scan_lanes_kernel<T>
      <<<(unsigned)((threads + kScanBlock - 1) / kScanBlock), kScanBlock, 0,
         (cudaStream_t)stream>>>(rows, n_rows, (const T*)L2, primary,
                                 fill_oob, q, L, rlen, pivot0, min_hits,
                                 hits64, active, capl, advance, (T*)lep,
                                 (T*)cnt, (T*)ovf, R);
  return (int)cudaGetLastError();
}

// kernel_occupancy of each kernel at index type T.
template <typename T>
int fwd_occupancy(int* out) {
  return kernel_occupancy(fwd_stage_kernel<T>, kFwdBlock, kFwdBlock / 2, 2,
                          out);
}

template <typename T>
int scan_occupancy(int* out) {
  return kernel_occupancy(scan_lanes_kernel<T>, kScanBlock, kScanBlock / 2,
                          2, out);
}

template <typename T>
int walk_occupancy(int* out) {
  return kernel_occupancy(walk_stage_kernel<T>, kWalkBlock, kWalkBlock, 1,
                          out);
}

template <typename T>
int entry_occupancy(int* out) {
  return kernel_occupancy(walk_stage_entry_kernel<T>, kEntryBlock,
                          kEntryBlock * kEntryItems, 1, out);
}

template <typename T>
int launch_walk(const WalkArgs& a, int entry, cudaStream_t st) {
  if (entry) {
    const bool move = a.src_w > 0;
    const long long n = move ? a.src_w : a.w;
    const long long tile = kEntryBlock * (move ? kEntryItems : kCountItems);
    walk_stage_entry_kernel<T>
        <<<(unsigned)((n + tile - 1) / tile), kEntryBlock, 0, st>>>(a);
  } else {
    walk_stage_kernel<T>
        <<<(unsigned)((a.w + kWalkBlock - 1) / kWalkBlock), kWalkBlock, 0,
           st>>>(a);
  }
  return (int)cudaGetLastError();
}
#else
// What a host loop may record of a call, for ops/lockstep_cases.py's work
// counts: the positions every rank asks occ4 at, in order (the first cap
// kept, n counts them all), and each lane's extensions.
struct Trace {
  long long* pos;
  long long cap;
  long long n;
  int* steps;
  void add(long long k) {
    if (n < cap) pos[n] = k;
    ++n;
  }
};

// ThreadRanks that records both positions when a trace is given.
template <typename T>
struct HostRanks {
  ThreadRanks<T> rank;
  Trace* tr;
  void operator()(T a, T b, T tk[4], T tl[4]) const {
    if (tr) {
      tr->add((long long)a);
      tr->add((long long)b);
    }
    rank(a, b, tk, tl);
  }
};

// The host loops run a lane after another; a lane that would trap on the
// card makes the call return -1.
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
int host_scan(const uint32_t* rows, long long n_rows, const void* L2,
              long long primary, int fill_oob, const uint8_t* q, int L,
              const int32_t* rlen, const int32_t* pivot0,
              const void* min_hits, int hits64, const uint8_t* active,
              int capl, int advance, void* lep, void* cnt_out, void* ovf_out,
              long long R, Trace* tr) {
  const FmPacked<T> fm = make_fm(rows, n_rows, (const T*)L2, primary,
                                 fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
  return host_lanes(R, [&](long long lane) {
    const long long n0 = tr ? tr->n : 0;
    T* o = (T*)lep + lane * (long long)capl * 5;
    int cnt;
    bool ovf;
    scan_lane(fm, q + lane * (long long)L, L, rlen[lane], pivot0[lane],
              hits_at<T>(min_hits, hits64, lane), active[lane] != 0,
              advance != 0, capl, ranks,
              [&](int slot, const T r[5]) {
                for (int k = 0; k < 5; ++k) o[5 * slot + k] = r[k];
              },
              cnt, ovf);
    ((T*)cnt_out)[lane] = (T)cnt;
    ((T*)ovf_out)[lane] = (T)(ovf ? 1 : 0);
    if (tr) tr->steps[lane] = (int)((tr->n - n0) / 2);
  });
}

// A segment lane after lane, then with a.loop the loop's step (what the
// kernel's last block to retire runs).
template <typename T>
int host_walk(const WalkArgs& a, Trace* tr) {
  const FmPacked<T> fm = make_fm((const uint32_t*)a.rows, a.n_rows,
                                 (const T*)a.L2, a.primary, (int)a.fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
  const int32_t t0 = *(const int32_t*)a.rnd;
  const int n = seg_steps(a, t0);
  int32_t live = 0;
  const int e = host_lanes(a.w, [&](long long j) {
    const long long n0 = tr ? tr->n : 0;
    WalkLane<T> x = load_lane<T>(a, j);
    const bool was = x.alive;
    walk_lane(fm, a, x, n, ranks);
    if (was) store_lane(a, j, x);
    live += x.alive;
    if (tr) tr->steps[j] += (int)((tr->n - n0) / 2);
  });
  if (e == 0 && a.loop) walk_after(a, t0, n, live);
  return e;
}

// A forward stage lane after lane: each step's six records where the
// kernel writes them, then pf false in the lane's remaining columns.
template <typename T>
int host_fwd(const FwdArgs& a, Trace* tr) {
  const FmPacked<T> fm = make_fm((const uint32_t*)a.rows, a.n_rows,
                                 (const T*)a.L2, a.primary, (int)a.fill_oob);
  const HostRanks<T> ranks{ThreadRanks<T>{fm}, tr};
  return host_lanes(a.U, [&](long long u) {
    const long long n0 = tr ? tr->n : 0;
    FwdLane<T> x = fwd_load<T>(a, u);
    const int32_t pos_end = x.pos + (int32_t)a.B;
    long long at = u * a.B;
    for (; at < (u + 1) * a.B && fwd_active(x, pos_end); ++at) {
      const FwdRecord<T> r = fwd_step(fm, a, x, pos_end, ranks);
      ((bool*)a.pf)[at] = r.push;
      ((T*)a.pk)[at] = r.k;
      ((T*)a.pl)[at] = r.l;
      ((T*)a.ps)[at] = r.s;
      ((int32_t*)a.pe)[at] = r.e;
      ((int32_t*)a.pp)[at] = r.p;
    }
    for (; at < (u + 1) * a.B; ++at) ((bool*)a.pf)[at] = false;
    fwd_store(a, u, x, -1);
    if (tr) tr->steps[u] = (int)((tr->n - n0) / 2);
  });
}
#endif

}  // namespace

// The scan's entries take the index as fm_walk.cu's do (the (n_rows, 16)
// packed rows, row count, L2 pointer in the index type, primary,
// fill_oob) and idx64 = 1 for an int64_t index type, 0 for int32_t.  Lane
// arrays are contiguous: q (R, L) base codes (uint8), rlen and pivot0 (R,)
// int32, min_hits (R,) int32 or (hits64 = 1) int64, active a byte a lane;
// lep (R, capl, 5), cnt and ovf (R,) in the index type.  capl at least 1,
// L at least 1.  The walk's entries take the WalkArgs words
// (ops/lockstep_cuda.py WALK_ARGS, in order), the forward stage's the
// FwdArgs words (FWD_ARGS); fwd_stage_occupancy, scan_lanes_occupancy,
// walk_stage_occupancy and walk_stage_entry_occupancy (its compacting
// tile's) give kernel_occupancy's six numbers of their kernel
// for the index type (a call of any lanes: every call takes the same
// kernel; on the current device) and return the CUDA error code.
#ifdef __CUDACC__
extern "C" int scan_lanes_launch(const uint32_t* rows, long long n_rows,
                                 const void* L2, long long primary,
                                 int fill_oob, const uint8_t* q, int L,
                                 const int32_t* rlen, const int32_t* pivot0,
                                 const void* min_hits, int hits64,
                                 const uint8_t* active, int capl, int advance,
                                 void* lep, void* cnt, void* ovf, long long R,
                                 int idx64, void* stream) {
  if (capl < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (R <= 0) return 0;
  return idx64 ? launch_scan<int64_t>(rows, n_rows, L2, primary, fill_oob, q,
                                      L, rlen, pivot0, min_hits, hits64,
                                      active, capl, advance, lep, cnt, ovf, R,
                                      stream)
               : launch_scan<int32_t>(rows, n_rows, L2, primary, fill_oob, q,
                                      L, rlen, pivot0, min_hits, hits64,
                                      active, capl, advance, lep, cnt, ovf, R,
                                      stream);
}

static int walk_launch_any(const long long* words, int entry, void* stream) {
  WalkArgs a;
  memcpy(&a, words, sizeof(WalkArgs));
  if (!walk_words_ok(a)) return (int)cudaErrorInvalidValue;
  return a.idx64 ? launch_walk<int64_t>(a, entry, (cudaStream_t)stream)
                 : launch_walk<int32_t>(a, entry, (cudaStream_t)stream);
}

extern "C" int walk_stage_launch(const long long* words, void* stream) {
  return walk_launch_any(words, 0, stream);
}

extern "C" int walk_stage_entry_launch(const long long* words,
                                       void* stream) {
  return walk_launch_any(words, 1, stream);
}

extern "C" int fwd_stage_launch(const long long* words, void* stream) {
  FwdArgs a;
  memcpy(&a, words, sizeof(FwdArgs));
  if (!fwd_words_ok(a)) return (int)cudaErrorInvalidValue;
  return a.idx64 ? launch_fwd<int64_t>(a, (cudaStream_t)stream)
                 : launch_fwd<int32_t>(a, (cudaStream_t)stream);
}

extern "C" int fwd_stage_occupancy(int idx64, long long lanes, int* out) {
  return idx64 ? fwd_occupancy<int64_t>(out) : fwd_occupancy<int32_t>(out);
}

extern "C" int scan_lanes_occupancy(int idx64, long long lanes, int* out) {
  return idx64 ? scan_occupancy<int64_t>(out) : scan_occupancy<int32_t>(out);
}

extern "C" int walk_stage_occupancy(int idx64, long long lanes, int* out) {
  return idx64 ? walk_occupancy<int64_t>(out) : walk_occupancy<int32_t>(out);
}

extern "C" int walk_stage_entry_occupancy(int idx64, long long lanes,
                                          int* out) {
  return idx64 ? entry_occupancy<int64_t>(out)
               : entry_occupancy<int32_t>(out);
}

LOOP_GRAPH_ENTRIES(lockstep)

// The name of a CUDA error code, for the wrapper's messages.
extern "C" const char* lockstep_cuda_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
#else
// The same lanes on the host; each returns 0, or -1 for arguments the
// launchers refuse and where a lane would trap on the card.  With steps
// not null the scan and the segment record the call (Trace): the first
// cap positions ranked into pos, their count into *n_pos, each lane's
// extensions into steps (the segment adds them to what steps holds).
extern "C" int scan_lanes_host(const uint32_t* rows, long long n_rows,
                               const void* L2, long long primary,
                               int fill_oob, const uint8_t* q, int L,
                               const int32_t* rlen, const int32_t* pivot0,
                               const void* min_hits, int hits64,
                               const uint8_t* active, int capl, int advance,
                               void* lep, void* cnt, void* ovf, long long R,
                               int idx64, long long* pos, long long cap,
                               long long* n_pos, int* steps) {
  if (capl < 1 || L < 1) return -1;
  if (R <= 0) return 0;
  Trace t{pos, cap, 0, steps};
  Trace* tr = steps ? &t : nullptr;
  const int e =
      idx64 ? host_scan<int64_t>(rows, n_rows, L2, primary, fill_oob, q, L,
                                 rlen, pivot0, min_hits, hits64, active, capl,
                                 advance, lep, cnt, ovf, R, tr)
            : host_scan<int32_t>(rows, n_rows, L2, primary, fill_oob, q, L,
                                 rlen, pivot0, min_hits, hits64, active, capl,
                                 advance, lep, cnt, ovf, R, tr);
  if (tr) *n_pos = t.n;
  return e;
}

extern "C" int walk_stage_host(const long long* words) {
  WalkArgs a;
  memcpy(&a, words, sizeof(WalkArgs));
  if (!walk_words_ok(a)) return -1;
  return a.idx64 ? host_walk<int64_t>(a, nullptr)
                 : host_walk<int32_t>(a, nullptr);
}

// walk_stage_host recording the segment (Trace; pos as scan_lanes_host's,
// *n_pos counting on from its value).
extern "C" int walk_stage_trace_host(const long long* words, long long* pos,
                                     long long cap, long long* n_pos,
                                     int* steps) {
  WalkArgs a;
  memcpy(&a, words, sizeof(WalkArgs));
  if (!walk_words_ok(a) || !steps) return -1;
  Trace t{pos, cap, *n_pos, steps};
  const int e = a.idx64 ? host_walk<int64_t>(a, &t) : host_walk<int32_t>(a, &t);
  *n_pos = t.n;
  return e;
}

extern "C" int walk_stage_entry_host(const long long* words) {
  WalkArgs a;
  memcpy(&a, words, sizeof(WalkArgs));
  if (!walk_words_ok(a)) return -1;
  if (a.idx64)
    segment_entry_host<kLive, kEpoch>(a, stage_lanes<int64_t>(a));
  else
    segment_entry_host<kLive, kEpoch>(a, stage_lanes<int32_t>(a));
  return 0;
}

static int fwd_host_any(const long long* words, Trace* tr) {
  FwdArgs a;
  memcpy(&a, words, sizeof(FwdArgs));
  if (!fwd_words_ok(a)) return -1;
  return a.idx64 ? host_fwd<int64_t>(a, tr) : host_fwd<int32_t>(a, tr);
}

extern "C" int fwd_stage_host(const long long* words) {
  return fwd_host_any(words, nullptr);
}

// fwd_stage_host recording the stage (Trace; pos as scan_lanes_host's,
// *n_pos counting on from its value, each lane's extensions into steps).
extern "C" int fwd_stage_trace_host(const long long* words, long long* pos,
                                    long long cap, long long* n_pos,
                                    int* steps) {
  if (!steps) return -1;
  Trace t{pos, cap, *n_pos, steps};
  const int e = fwd_host_any(words, &t);
  *n_pos = t.n;
  return e;
}
#endif

// The sizes of WalkArgs and FwdArgs in words, to check the Python layouts
// against.
extern "C" int lockstep_walk_args_words() {
  return (int)(sizeof(WalkArgs) / 8);
}

extern "C" int lockstep_fwd_args_words() {
  return (int)(sizeof(FwdArgs) / 8);
}
