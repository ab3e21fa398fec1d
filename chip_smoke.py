"""Smoke run of compseed_tpu_torch's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  0. device   — a CUDA card must be present; prints its nvidia-smi
                name and power limit.
  1. build    — compiles csrc/bsw_extend.cu, csrc/fm_walk.cu,
                csrc/chain_scan.cu, csrc/walk_chain.cu (the two with
                csrc/lookback.cuh), csrc/smem_seed.cu (with fm_walk.cu,
                csrc/fm_rank.cuh) and csrc/lockstep.cu with nvcc for
                sm_90a (side by side, and beside them the host tail and
                the host loops of smem_seed.cu and lockstep.cu, for the
                work counts, with g++), loads the
                libraries and runs the launch
                self-check: the probe kernel against its plain version; a
                wrong tile is fatal.  The probe and
                torch.add are timed two ways each: a loop of launches
                between two events, and the same launches captured once
                in a CUDA graph and replayed.  For smem_collect_kernel,
                smem_strategy_kernel, walk_stage_entry_kernel,
                fwd_stage_kernel, scan_lanes_kernel and walk_stage_kernel
                it prints the lanes the card keeps resident (the
                occupancy query times the SMs), int32 and int64, and
                ptxas' registers and spills (the parent's builds' too,
                with the options below).
  2. kernels  — the DP kernel (H/E rows in shared memory) and its
                device-memory-scratch variant against the plain PyTorch
                version on the card, exactly, on seeded random pairs at
                the main path's shapes (z-drop breaks, band shrink, h0
                near the bound, empty queries, tlen=0 lanes); on a second
                set whose h0 keeps the int16 gate, three ways: int16
                kernel == plain int16 version == int32 kernel.  Then the
                fused kernel (tile decode + both band rounds + acceptance
                in one launch) against its plain version on seeded pair
                tables over the bench index: forward and reverse lanes,
                reads across l_pac, lanes rejected at round 0, pad lanes,
                narrow and wide r0, int32 and int16 rows.  A Q = 1024
                table goes through _meta_dual_core both ways: int32 rows
                do not fit, so it builds tiles and launches the scratch
                kernel once per round; int16 rows fit, one fused launch.
                Then the FM kernels (one-child extension, W-step chain
                walk, inverse-Psi walk) against their plain versions,
                exactly, over the bench index with int32 and with int64
                positions: 16,384 lanes and a (2048, MLEP, 3) batch both
                ways, chain walks at W = 1, 5, 8, 10 with and without
                stop_s and an ambiguous base at every column, the walk
                over 1, sa_intv and 2 sa_intv steps, and garbage lanes
                under fill_oob; one counted launch per kernel call.
                Then chain_scan's round kernels (probe, group, apply)
                against their plain steps, exactly, output by
                output, on the rounds the first bench chunk's seeding
                runs (the first round of each width of each chain_scan
                call: round 1 at 16,384 lanes and its narrower segments,
                round 2 at 65,536, round 3), with int32 and int64
                positions, and each round again over a 1,024-slot table
                with 200 free store rows (slot collisions, a full store).
                From the same seeding run, walk_pool_chain's round
                kernels (key, group, apply) against their plain steps,
                exactly, on the first round of each width of both calls
                (round 1 at 393,216 lanes and its narrower segments,
                round 2 at 262,144, ...), int32 and int64, each also with
                64 representatives (groups wait a round) and in the forced
                forms of walk_cases.forced (two lanes whose keys collide
                while their (window, k, s) differ, a live lane keyed
                INT32_MAX, one after a dead lane of its (window, k, s)).
                Then the round loops as CUDA graphs (each segment of
                chain_scan and walk_pool_chain one graph with a WHILE
                node): every call of one seeding run of the first chunk,
                int32 and int64, chain_scan with report_rounds on, run
                again from its arguments through the plain loop, every
                output equal (chain_cases.CallCapture, call_vs_plain); on
                every round of those runs the round's sort (CUB's, over
                the key's bits) equal to torch.sort(stable=True); the
                two segment entry kernels (chain and walk) with no source
                (a call's first segment: the live lanes counted) and the
                two apply kernels' folded loop tests (the apply with its
                loop word set, whose last block counts the round and
                tests the next) against their plain version (seedscan.
                loop_step_plain; the tail after the apply without the
                word, every other output held equal too) at a running
                round, the RCAP cap, a segment exit and no live lane.
                The segment entry kernels (the lanes compacted into the
                next segment's, the live count, the loop test) on every
                boundary between two segments of the first chunk's
                seeding (entry_cases.BoundaryCapture), int32 and int64,
                as captured, with no live lane, exactly w live and w + 37
                live at the RCAP cap (the lanes past w dropped), by the
                port's build and any other build with a segment entry (a
                variant passed as --chain-old-source / --walk-old-source):
                exact against seedscan.segment_entry_plain; then each
                boundary timed on the card alone (a CUDA graph of 20
                launches, replayed) in turns with the PyTorch compaction
                it replaced and, with the parent's sources, its
                one-thread loop entry kernel.
                The suffix-array walk's stage entry kernel (a boundary
                between two stages of sa_batch_compact: the lanes that
                died written out, the live ones compacted into the next
                stage's, ovf, before the last stage the loop's first
                test) on every boundary of the first chunk's call and of
                a 40-lane call (a last stage of one lane), int32 and
                int64, as captured, with no live lane, cap // 2, cap and
                cap + 37 live lanes: exact against its plain version
                (fm._sa_boundary_plain); each call by the kernels against
                the plain version; each boundary of the int32 chunk timed
                on the card alone in turns with the PyTorch sequence it
                replaced; the walk with its loop word (its last block to
                retire runs the loop's test after a round) against
                alive.any() on the last stage's lanes before each round,
                all dead and only the last alive, and timed with and
                without the word in turns.
                The lockstep kernels (csrc/lockstep.cu: the scan, a walk
                stage's segment and its entry) on every scan and stage
                call of all_off's and bwd_win's first chunk, and the
                forward stage kernel on all 17 stages of fwd_staged's,
                int32 and int64, exact against their plain versions (a
                scan's cnt, ovf, each lane's rows < cnt and the pools
                build_pool makes of both; a stage's lanes, t and live
                count; a forward stage's state, pf (false past a lane's
                steps), and its other records where j < steps), the
                outputs poisoned before each launch.
                Then each seeding call as one CUDA graph (DeviceSeeder.
                _call: the default engine's whole call captured once a
                thread and call shape, its loops joining the capture)
                against the eager _run on every chunk of the stream, with
                int32 and with int64 positions, head and seed matrix
                equal; the first chunk's capture and instantiation ms and
                the bytes a kept shape holds on the card (its private
                memory pool), also for the sharded path's shape; every
                other engine (fwd_staged, fwd_off, bwd_win, bwd_whole,
                bwd_off, r2_off, all_off) the same on every chunk with
                int32 positions and the first with int64.
  3. goldens  — tests/fixtures reads, each 2,000-read file as ONE chunk,
                through align_stream with the port's seeder, DP engine
                and native tail: the seeder's caps overflow, the chunk
                is rerun exactly on the lockstep seeder and a cap is
                raised; SAM must be byte-equal to the committed bwamem /
                CompSeed goldens, and the DP kernel must have launched
                in that run (counts set to 0 just before it); the rerun
                must run each collect and round-3 call as one launch of
                smem_collect_kernel / smem_strategy_kernel and launch no
                extension kernel, and its merged SAL's sa_batch must run
                its loop as a graph, with no host test (no
                fm._sa_loop_plain call); its calls are kept for phase 4,
                its split (BatchSeeder.prof: r1, r2, r3, sal, post)
                printed.
  4. main     — the bench input (2 Mbp repeat-structured genome,
                sa_intv=8, 30x layout-ordered 101 bp reads): 4 chunks of
                16,384 reads through align_stream, one warm-up stream
                and 3 timed ones, with int32 DP state and again with an
                engine built under COMPSEED_BSW_I16=1 (then int32 once
                more, to time the two in turns); each kernel must have
                launched; the first 1,024 reads must give SAM
                byte-equal to the host oracle path.  A third window
                takes the tile route (build_tiles + one DP launch per
                band round) so that the engine's call time is read both
                ways in turns.  The pair tables captured from the first
                chunk go through the fused kernel, the DP kernels on the
                tiles decoded from them, and every plain version once
                more.  Then a forced overflow: a fresh seeder with
                GP_F=18 takes two chunks; the first must overflow, be
                rerun on the lockstep seeder and double GP_F, the second
                must not overflow, the SAM of both must equal the
                unforced run's, and the DP kernel's launches are counted
                for this run alone; the rerun as the goldens' (one smem
                kernel launch a call, no extension kernel), its rerun_s
                and split.  The exact rerun's kernels: every captured
                call of the goldens' and the forced run's reruns through
                its kernel and its plain version on the card, over the
                index with int32 and with int64 positions, exactly; each
                of the forced run's calls timed in a loop and on the card
                alone (a CUDA graph replayed), the plain version's time
                of the first two round-1 calls, round 2 and round 3,
                beside the bound (smem_cases.work: the distinct occ rows'
                and the lanes' bytes against the ranks' operations) and
                two latency floors (the longest lane's dependent steps
                times the chain walk's step latency on the bench table,
                and times the card's dependent 16-byte load from L2:
                csrc/load_chase.cu, one thread chasing a random cycle
                through a table of the bench occ table's bytes, and one
                of a 2^30-base genome's, from device memory); one
                dependent step of the round-3 kernel (one lane, a read of
                101 bases against one of 11, no hit: (t101 - t11) / 90).
                The lockstep kernels: every scan and stage call of
                all_off's and bwd_win's first chunk and every forward
                stage of fwd_staged's (int32) timed in a loop and alone,
                the stage's entry alone and its first segment alone, the
                plain version's ms, the bound (lockstep_cases.work) and
                the latency floors; cell A's stream through align_stream
                under COMPSEED_FWD_MEMO=0 (fwd_staged by its call graph
                until
                its caps' response switches it off), SAM byte-equal to
                this phase's stream, the forward stage and the fused DP
                kernel launched, the extension not; sa_batch by its loop graph
                and by the host-tested loop in turns on the goldens'
                rerun calls, with the graph's capture and instantiation
                ms (the graph kept per lane count).  The int16 and the
                tile-route window
                time one stream each.  The FM kernels: launches per
                chunk (the chain walk and the inverse-Psi walk must have
                launched in the int32 window; the extension, which no
                path of the seeder launches, in fwd_staged's first chunk
                with its staged walk's plain version patched in,
                seedscan._fwd_route); the first call of each kind that
                the first chunk (and that run) makes, through the kernel and its
                plain version, exact, timed (in a loop, and replayed
                from a CUDA graph), with its bound; the calls of each kind
                in one run of the first chunk (the chain walk's by
                direction), which must build no occ table.  The kernels'
                builds (the port's; with --fm-old-source also an earlier
                source) on the main path's forward and backward chain
                walk and every inverse-Psi stage, exact, in turns; the
                bench index's bytes on the card (one 64-byte-row occ
                table, no larger copy while it loads); a random BWT of
                2^30 bases built on the card straight into that table
                (8,388,609 rows, 537 MB, more than 10x L2; its first 2^16
                bases held to build_occ_rows; its bytes and its peak while
                built), the forward, backward and first inverse-Psi shapes
                and a 131,072-lane extension over it through the kernels
                and their plain versions, exact, timed from cold L2, with
                their bound, and every build in turns; one dependent
                step's latency on both tables (32 lanes, W = 10 against
                W = 1; cold on the large one); fwd_staged's
                captured extensions through every build in turns;
                torch.profiler over one chunk (launches, stream syncs,
                async copies, the card's busy share: ``profile_chunk``,
                which scripts/torch_seeding_ab.py --profile runs on other
                checkouts); round 1's live lanes before each round
                (chain_scan's ``report_rounds``).  The chain kernels:
                launches per chunk (each must have launched in the int32
                window); each timed at round 1's widths (16,384, 4,096,
                1,024) and at round 2's 65,536 (in a loop, replayed from
                a CUDA graph; the plain steps in a loop) beside its
                bound; every captured round shape, one block of round 1
                and round 1 padded through each build of the kernels (the
                port's; with --chain-old-source also other sources),
                exact against the plain steps, timed on the card alone in
                turns, the probe also with L2 evicted before each
                launch; with --chain-old-source every round of the first
                chunk's three chain_scan calls (chain_cases.EveryRound:
                each round's w, Uw, live) through each build, exact, the
                probe timed there warm and cold on the card alone in
                turns and by the profiler inside the chunk, and each
                build's profiler means per launch over one chunk, in
                turns; round
                1's chain_scan with the kernels and with the plain round
                in turns; the chunk by stage under torch.profiler, on the
                call graph's route (the call graph: the copies into its
                inputs and its launch; the rest) and on the eager route
                (chain_scan's set-up and tail, its segments: a round's
                arguments, the capture of its loop graph and the launch;
                walk_pool_chain's set-up and compactions, its widths; the
                rest): host calls (kernel and
                graph launches, syncs, copies, captures, instantiations)
                by stage, what the card ran, and the kernels and memsets
                of each segment's body graph, what the card runs a round;
                on the eager route each loop graph's capture and
                instantiation ms and the segment's whole host call over 3
                runs of the chunk
                (``segment_costs``); each round's sort beside torch.sort
                (``sort_time``).  The walk kernels: launches per
                chunk (each must have launched in the int32 window); each
                timed at the first width of round 1's and round 2's
                walk_pool_chain call (393,216 and 262,144 lanes; on the
                card alone, in a loop, by the profiler's records; the
                plain steps in a loop) beside its bound, at a ragged
                width (round 1's first 393,216 - 333 lanes) and padded
                (Uw = w, a quarter of the lanes alive); every round of
                the first chunk's two walk_pool_chain calls (each round's
                w, Uw, live, n_u, n_w), those forms and one block through
                each build of the kernels (the port's; with
                --walk-old-source also other sources), exact against the
                plain steps, timed on the card alone in turns; each
                build's profiler mean per launch over one chunk, in
                turns.  The chain and
                the walk kernels again on round 1's first 256 lanes (one
                block: a launch and a lane's dependent reads, their
                latency floor).  The apply kernels with their loop word
                set and without it (the folded loop test against the
                apply alone) in turns at the chain's round-1 and round-2
                widths and the walk's (loop_tail_turns).  Gates (the
                measured values and a stated margin, MAX_*): at most 10
                kernels the card runs a chain_scan round and 11 a
                walk_pool_chain round; at most 4 host launches (kernels
                and graphs), 2 stream syncs (the two fetches) and 8 async
                copies a chunk; on the profiled chunk at most 5
                one-thread loop entry kernels, a segment entry kernel,
                no suffix-array loop kernel of its own (sa_loop_*), and
                neither the PyTorch compaction between segments nor
                sa_batch_compact's plain version run on the main path
                (counted over the int32 window, whose first chunk
                captures the call graphs the profiled chunk replays).
  5. cli      — the command line, ``compseed_tpu_torch.cli.main``, at its
                defaults (device engine on the card).  ``index`` on
                tests/fixtures/tiny.fa must write the committed index
                byte for byte; ``mem -o`` on the seven golden inputs
                (single-end FASTQ, reordered raw reads, two-file
                paired-end, -p smart pairing, ALT contigs single-end,
                with -j and paired-end) must give every SAM line but @PG
                equal to its golden.  Then at full width: the bench
                reads as a raw-reads file through ``mem -K`` (16,384
                reads a chunk), SAM byte-equal to phase 4's stream and
                the exit report's reuse equal to the expected numbers,
                reads/s of the whole command and, in turns with it, of
                the same file through align_stream without the command;
                the bench genome indexed at
                interval 32 through ``mem --sa-intv 8`` against the index
                built at 8 (equal suffix-array sample, equal SAM);
                16,384 simulated pairs through ``mem r1 r2``, the first
                512 pairs equal to ``--engine oracle``; ``mem -y 0`` on
                1,024 reads against ``--engine oracle``.  The DP launch
                counts are set to 0 before every ``mem`` run and must be
                above 0 after it.
  6. engines  — every seeding engine of ``seeder2.ENGINES`` on the card.
                (a) The first 16,384 bench reads as one chunk through
                each: head and seed matrix equal the JAX package's,
                stored in compseed_tpu_torch/engine_heads.json.  (b) Two
                more runs of that chunk per engine, a fresh seeder a run:
                seeds equal the default engine's; device seconds, BWT
                hit and SAL merged shares, overflows and per-read
                splices and the FM and lockstep kernels' launches
                recorded; then one chunk on the engine's own route (the
                call graph, captured by the run before) under
                torch.profiler: host launches, syncs and copies and the
                extension kernel's launches a chunk; every engine must
                take the call graph and make at most MAX_CHUNK_LAUNCHES
                launches, MAX_CHUNK_SYNCS syncs and no extension launch a
                chunk (an engine whose chunk overflows its caps,
                fwd_staged on the bench chunks, by its call alone:
                engine_call, on a fresh seeder, no rerun).  (c) Cell
                A'':
                a seeder under COMPSEED_ADAPTIVE_CAPS=0 with the memo
                round-3 pool forced to R (MEM3_F = 1) streams phase 4's
                4 x 16,384 reads: chunk 1 alone overflows, is rerun and
                switches the forward dedup off, chunks 2-4 run the
                fwd_off engine; SAM byte-equal to phase 4's.  (d) The two
                2,000-read goldens under the all_off engine, one chunk
                each, SAM byte-equal.
  7. mesh     — the sharded path (parallel/sharded.py) on this card, S
                shards on [cuda:0] * S: they run in turn, so this
                measures the code path, not scaling.  (a) Phase 4's
                stream at S = 1, 2 and 4, SAM byte-equal to phase 4's,
                reads/s, shard width, per-shard seconds and launches for
                each (counts set to 0 before the engines are built and
                read after the stream; 2 fused launches a shard a
                chunk); (b) at S = 4 the first chunk's shard heads equal
                the JAX package's ShardedSeeder's, stored in
                compseed_tpu_torch/mesh_heads.json; (c) GP_F = 2 at S =
                4 on the first chunk: every shard overflows and reruns,
                SAM equal; (f) the index with int64 positions at S = 4 on
                the first chunk: heads equal the JAX int64 heads, SAM
                equal; (d) ``mem --mesh 1`` on the bench file (SAM equal
                to phase 4's) and ``mem --mesh 2``, which must return 1
                on one card; (e) two ``mem`` processes under
                COMPSEED_COORD=localhost:<port> on this card, then
                ``merge``: equal to one process's SAM.

With --scratch-variants (and --old-source FILE, an earlier
csrc/bsw_extend.cu whose launcher has no pairs-per-block argument) the
source is also built with the scratch variant's hoisted loads off and on,
and the builds are timed in turns on the Q = 2048 pairs and on the main
path's captured tiles, each held to the plain version first.  With
--fm-old-source FILE (an earlier csrc/fm_walk.cu whose extension reads
the (n_rows, 12) int64 occ rows and whose walks read the packed table)
that file is built too, and phase 4 times its extension and its walks
against the port's in turns, handing its extension int64 rows unpacked
from the packed table for those calls only.  With --chain-old-source
FILE (another csrc/chain_scan.cu whose struct Args is the port's or a
prefix of it, such as the parent's: ``git show
<commit>:compseed_tpu_torch/csrc/chain_scan.cu > FILE``; repeatable) each
file is built too, with the port's csrc/ on the include path unless a
lookback.cuh sits beside FILE, and phase 4 holds its kernels to the plain
steps on every captured round shape, one block, round 1 padded and every
round of the first chunk, times them against the port's in turns there
and by the profiler over one chunk's seeding.  --walk-old-source FILE
(another csrc/walk_chain.cu with the port's struct Args, such as the
parent's; repeatable) does the same for
the walk kernels, with the port's csrc/ on the include path unless a
lookback.cuh sits beside FILE, on every round of the first chunk's two
walk_pool_chain calls and their forms, and over one chunk's seeding by
the profiler.  --smem-old-source FILE and --lockstep-old-source FILE
(another csrc/smem_seed.cu or csrc/lockstep.cu with the port's
launchers, such as the parent's, built with the port's csrc/ on the
include path after the file's own directory) time that build's collect
kernel on every collect call of the forced overflow's rerun, and its
scan, walk and forward stage kernels on every such call of all_off's,
bwd_win's and fwd_staged's first chunk (a walk stage's loop and its first
segment alone; a forward stage on records zeroed first, as the parent's
wrapper zeroed them), against the port's in turns (old, new, new, old) on
the card alone, each held to the plain version first; the round-3
kernel also on every round-3 call of the forced overflow and one
dependent step, and every walk stage's entry alone.  --entry-old-csrc
DIR (another csrc/ directory with chain_scan.cu, walk_chain.cu and
fm_walk.cu and their headers, such as the parent's) builds those three
sources too, and phase 2 times their
segment and stage entry kernels in turns with the port's at every
boundary ("parent").  No option changes what the port itself runs.

Phases 3 to 7 seed every chunk of every engine by its call graph (the
first chunk of a shape on a thread captures it).

Prints the CLI phase's, the engine phase's and the mesh phase's numbers
and the kernel table as one JSON line each, the card's nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Imports torch, numpy
and compseed_tpu_torch only.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "compseed_tpu_torch/csrc/bsw_extend.cu"
FM_SOURCE = "compseed_tpu_torch/csrc/fm_walk.cu"
CHAIN_SOURCE = "compseed_tpu_torch/csrc/chain_scan.cu"
WALK_SOURCE = "compseed_tpu_torch/csrc/walk_chain.cu"
SMEM_SOURCE = "compseed_tpu_torch/csrc/smem_seed.cu"
CHUNK = 16384          # reads per chunk, the bench's default
N_CHUNKS = 4
RUNS = 3               # timed streams after one warm-up stream
ORACLE_READS = 1024
PE_PAIRS = 16384       # simulated pairs through ``mem r1 r2``
PE_ORACLE_PAIRS = 512  # of them against the host oracle path
PE_INSERT = "400,50"   # -I: both runs see one insert-size distribution
FORCED_GP_F = 18       # the bench input needs a round-1 pool of ~23.2 R
LONG_READS = 16        # reads of LONG_LEN + 3 bp for the Q = 2048 class
LONG_LEN = 1500
LONG_Q = 2048          # their query-length class
LONG_SEED = 11
MESH_SHARDS = (1, 2, 4)   # phase 7: shards of the sharded path, on one card
MESH_GP_F = 2             # dryrun_multichip's forced round-1 pool
# bwt_hit_pct, sal_merged_pct of one unforced stream: the seeder is
# bit-exact, so these are fixed numbers of the input and the chunking
EXPECT_REUSE = (38.4605, 39.9724)

# Roofline inputs.  HBM rate: NVIDIA's H100 SXM data sheet.  The data
# sheet gives no int32 rate; an SM has 64 int32 lanes against 128 fp32
# lanes and no fused multiply-add to count twice, so the int32 peak is
# the 67 TFLOP/s fp32 figure / 4.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# integer operations per band cell that the recurrence itself needs
# (ksw_extend2's inner loop; addressing, loop control and the clamp of
# the input codes are not counted): add score + select (2), two max for
# h (2), row-max compare + two selects (3), E: sub, max0, sub, max (4),
# F: sub, max0, sub, max (4)
OPS_PER_CELL = 15
# The FM kernels rank in occ rows of 12 uint32 words, 4 bytes each, as
# the JAX layout and the packed table both store them: 4 checkpoint
# counts, then 4 hi and 4 lo bit-plane words of 32 bases
# (ops/device_index.py).  A rank at block offset o needs the count words of
# the bases it reports and the hi / lo words up to word o >> 5, and the
# bound counts each such (row, word) once per call, however often the
# walks read it again (fm_rank_need).  Integer operations: per word ranked
# mask 3, and/not 6, popcount 4, add 4; per rank 4 more (the checkpoint
# adds); per extension 20 more ($ adjustments, sizes, child select,
# coordinates); per inverse-Psi step 10 more (base decode, L2 add,
# sampled-row test).
FM_WORD_BYTES = 4
FM_OPS_WORD = 17
FM_OPS_RANK = 4
FM_OPS_EXTEND = 20
FM_OPS_LF = 10
FM_KERNELS = ("fm_extend_sel_kernel", "fm_chain_walk_kernel",
              "fm_inv_psi_walk_kernel")
# the exact rerun's per-read programs (csrc/smem_seed.cu) and what of the
# JAX package each replaces (vmapped, jitted per-read programs; XLA, no
# Pallas)
SMEM_KERNELS = ("smem_collect_kernel", "smem_strategy_kernel")
SMEM_REPLACES = {
    "collect": "compseed_tpu/ops/smem.py:51-219 _collect_one (while_loops "
               ":119 and :210; vmapped, jitted by _collect_fn :293-298; XLA "
               "fusion, no Pallas)",
    "strategy": "compseed_tpu/ops/smem.py:222-271 _seed_strategy_one "
                "(fori_loop :268; vmapped, jitted by _round3_fn :300-307; "
                "XLA fusion, no Pallas)"}
# chain_scan's round (csrc/chain_scan.cu) and the lines of the JAX
# package's round body (make_body, XLA fusions, no Pallas) each replaces
CHAIN_KERNELS = ("chain_probe_kernel", "chain_group_kernel",
                 "chain_apply_kernel")
CHUNK_TURNS = 6             # chain_chunk_means' turns (each both orders)
CHAIN_REPLACES = {
    "chain_probe_kernel": "compseed_tpu/ops/seedscan.py:1495-1520 "
                          "(chain_scan's probe; XLA fusion, no Pallas)",
    "chain_group_kernel": "compseed_tpu/ops/seedscan.py:1521-1563 "
                          "(chain_scan's grouping; XLA fusion, no Pallas)",
    "chain_apply_kernel": "compseed_tpu/ops/seedscan.py:1564-1688 "
                          "(insert, apply, flush, advance; XLA fusion, no "
                          "Pallas) and, in a loop, :1720-1726 (the "
                          "while_loop cond after each round)"}
# walk_pool_chain's round (csrc/walk_chain.cu) and the lines of the JAX
# package's round body (make_body, XLA fusions, no Pallas) each replaces
WALK_KERNELS = ("walk_key_kernel", "walk_group_kernel", "walk_apply_kernel")
WALK_REPLACES = {
    "walk_key_kernel": "compseed_tpu/ops/seedscan.py:633-645 "
                       "(walk_pool_chain's window and sort key; XLA fusion, "
                       "no Pallas)",
    "walk_group_kernel": "compseed_tpu/ops/seedscan.py:646-670 "
                         "(walk_pool_chain's grouping and group minima; XLA "
                         "fusion, no Pallas)",
    "walk_apply_kernel": "compseed_tpu/ops/seedscan.py:682-720 "
                         "(deaths, advance; XLA fusion, no Pallas) and, in "
                         "a loop, :734-738 (the while_loop cond after each "
                         "round)"}
# the round loops' segment entry kernels (each segment one CUDA graph:
# csrc/loop_graph.cuh; the entry csrc/compact.cuh) and what of the JAX
# package each replaces: the rank-scatter compaction between segments and
# the lax.while_loop cond before a segment's first round; the same cond
# after each round is the apply kernel's folded tail (its last block to
# retire, when the loop word is set)
LOOP_KERNELS = ("chain_segment_entry_kernel", "walk_segment_entry_kernel")
LOOP_REPLACES = {
    "chain_segment_entry_kernel": "compseed_tpu/ops/seedscan.py:1727-1737 "
                                  "(chain_scan's rank-scatter compaction "
                                  "between segments) and :1720-1726 (the "
                                  "while_loop cond before a segment's first "
                                  "round, with instrument's alive_hist at "
                                  ":1695-1704); XLA, no Pallas",
    "walk_segment_entry_kernel": "compseed_tpu/ops/seedscan.py:739-748 "
                                 "(walk_pool_chain's rank-scatter "
                                 "compaction between widths) and :734-738 "
                                 "(the while_loop cond before a width's "
                                 "first round); XLA, no Pallas"}
LOOP_SOURCES = {"chain": CHAIN_SOURCE, "walk": WALK_SOURCE}
ENTRY_TURNS = 3             # entry_time's turns (each both orders)
TAIL_TURNS = 3              # loop_tail_turns' turns (each both orders)
# the suffix-array walk's stage entry kernel (the boundaries between
# sa_batch_compact's stages) and what of the JAX package it replaces
SA_KERNELS = ("sa_stage_entry_kernel",)
SA_REPLACES = {
    "sa_stage_entry_kernel": "compseed_tpu/ops/fm.py:268-291 "
                             "(sa_batch_compact's boundaries between stages: "
                             "the done lanes scattered with mode=\"drop\", "
                             "argsort(~alive, stable)[:cap] and the gathers, "
                             "ovf) and :282 (the last stage's while_loop "
                             "cond before its first round); XLA, no Pallas"}
SA_TURNS = 3                # sa_time's and sa_tail's turns (each both orders)
# the lockstep engines' loops (csrc/lockstep.cu) and what of the JAX
# package each replaces (while_loops over XLA fusions, no Pallas)
LOCKSTEP_SOURCE = "compseed_tpu_torch/csrc/lockstep.cu"
LOAD_CHASE_SOURCE = "compseed_tpu_torch/csrc/load_chase.cu"
# the parent's round sources whose entries --entry-old-csrc times in turns
ENTRY_PARENT_SOURCES = dict(chain="chain_scan.cu", walk="walk_chain.cu",
                            sa="fm_walk.cu")
LOCKSTEP_KERNELS = ("scan_lanes_kernel", "walk_stage_kernel",
                    "walk_stage_entry_kernel", "fwd_stage_kernel")
LOCKSTEP_REPLACES = {
    "scan_lanes_kernel": "compseed_tpu/ops/seedscan.py:62-146 _scan_one "
                         "(while_loop :143), vmapped by make_scan :148-160; "
                         "XLA, no Pallas",
    "walk_stage_kernel": "compseed_tpu/ops/seedscan.py:187-275 walk_stage "
                         "(a segment of its while_loop :273, and its cond "
                         "after each segment :266-270); XLA, no Pallas",
    "walk_stage_entry_kernel": "compseed_tpu/ops/seedscan.py:277-297 "
                               "compact_state (between walk_pool's stages, "
                               ":395) and walk_stage's cond before its "
                               "first segment :266-270; XLA, no Pallas",
    "fwd_stage_kernel": "compseed_tpu/ops/seedscan.py:854-1005 "
                        "_fwd_stage_walk (while_loop :1005 over segments "
                        "of 8 guarded steps :992-997, cond :1001-1003), "
                        "once a stage by forward_scan_dedup :1020; XLA, "
                        "no Pallas"}
# the stages of fwd_staged's staged forward walk in one call of a chunk:
# round 1's 7 (seedscan.fwd_stages_for), round 2's 3, round 3's 7
FWD_STAGES = 17
# fwd_staged's int64 call graph is held to its eager _run on the first
# chunk's first reads (engine_graph_check says why not on all of them)
FWD_INT64_READS = 4096
# gates on one chunk of the main path's seeding (torch.profiler), each the
# value measured on an H100 (PERF.md) plus a stated margin: the kernels the
# card runs a chain_scan round and a walk_pool_chain round (the body
# graph's kernel nodes: 9 and 10 since the loop's test is the apply's
# tail, one more allowed for a sort pass CUB may add at another width);
# the chunk's host launches (cudaLaunchKernel and cudaGraphLaunch: 2, the
# call graph's launch and the copy of the seed matrix's columns; 2 more
# allowed), stream syncs (the two fetches, the
# JAX package's two device_gets; no margin) and async copies (6: two
# uploads, two copies into the graph's inputs, two fetches; 2 more
# allowed)
MAX_CHAIN_ROUND_KERNELS = 10
# lanes of the round the chain and walk kernels are timed at for their
# latency floor: one block (four of the chain apply's), so the time is
# what one block pays, a launch and a lane's path
FLOOR_LANES = 256
MAX_WALK_ROUND_KERNELS = 11
# the one-thread loop entry kernels a chunk (15 before the segment entry
# kernels compacted the lanes and folded them in, 0 since: a bound of 5)
MAX_LOOP_ENTRY_KERNELS = 5
MAX_CHUNK_LAUNCHES = 4
MAX_CHUNK_SYNCS = 2
MAX_CHUNK_COPIES = 8


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    import torch
    fn()                                        # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def random_pairs(rng, P: int, Q: int, T: int, big_h0: bool = True,
                 qmax: int = 101):
    """Extension-like pairs with the DP's corner cases mixed in."""
    import numpy as np
    qlens = rng.integers(1, qmax + 1, P).astype(np.int32)
    tlens = rng.integers(0, T + 1, P).astype(np.int32)
    queries = np.full((P, Q), 4, np.int8)
    targets = np.full((P, T), 4, np.int8)
    err = rng.choice([0.01, 0.05, 0.3], P)           # 0.3 => z-drop breaks
    for i in range(P):
        q = rng.integers(0, 4, int(qlens[i]))
        queries[i, :len(q)] = q
        tl = int(tlens[i])
        if tl:
            t = np.resize(q, tl).copy()
            e = rng.random(tl) < err[i]
            t[e] = rng.integers(0, 4, int(e.sum()))
            if rng.random() < 0.2:                    # indel: band shrink
                j = int(rng.integers(0, tl))
                t = np.concatenate([t[:j], rng.integers(0, 4, 3), t[j:]])[:tl]
            targets[i, :tl] = t
    queries[rng.random((P, Q)) < 0.01] = 4
    qlens[::97] = 0                                  # empty queries
    tlens[::89] = 0                                  # tlen = 0 lanes
    h0 = rng.integers(1, 120, P).astype(np.int32)
    if big_h0:
        h0[::13] = rng.integers(400, 1 << 14, len(h0[::13]))  # near bound
    ws = rng.choice([1, 5, 50, 100], P).astype(np.int32)
    return queries, qlens, targets, tlens, h0, ws


def graph_time_ms(fn, launches: int = 100, reps: int = 10) -> float:
    """ms per call of ``fn`` when ``launches`` calls are captured once in
    a CUDA graph on the capture stream and the graph is replayed: the
    card's time for a launch without the interpreter's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up on that stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * launches)


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): the bytes over the HBM rate against the
    integer operations over the int32 peak, the larger of the two."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def ops_bound(nbytes: int, cells: int):
    """bound_of for the DP: the band cells times the operations per cell."""
    return bound_of(nbytes, cells * OPS_PER_CELL)


def launch_counts() -> dict:
    """Every kernel's launches since the last reset_launches()."""
    from compseed_tpu_torch.ops import (bsw_cuda, chain_cuda, fm_cuda,
                                        lockstep_cuda, smem_cuda, walk_cuda)
    return {**bsw_cuda.LAUNCHES, **fm_cuda.LAUNCHES, **chain_cuda.LAUNCHES,
            **walk_cuda.LAUNCHES, **smem_cuda.LAUNCHES,
            **lockstep_cuda.LAUNCHES}


def reset_launches() -> None:
    from compseed_tpu_torch.ops import (bsw_cuda, chain_cuda, fm_cuda,
                                        lockstep_cuda, smem_cuda, walk_cuda)
    for counts in (bsw_cuda.LAUNCHES, fm_cuda.LAUNCHES, chain_cuda.LAUNCHES,
                   walk_cuda.LAUNCHES, smem_cuda.LAUNCHES,
                   lockstep_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0


def device_kind(name: str) -> str:
    """What a device event of the profiler is: "memsets", "copies" or
    "kernels"."""
    return "memsets" if name.startswith("Memset") else \
        "copies" if name.startswith("Memcpy") else "kernels"


# kernels the card runs counted by family in a profiled chunk: the
# one-thread loop entry kernels (chain_scan's and walk_pool_chain's, the
# port's before the segment entry kernels), the segment entry kernels, the
# suffix-array loop's one-block kernels (the port's before its stage entry
# kernel) and that kernel, and PyTorch's index_put_ and scan (cumsum)
# kernels
KERNEL_FAMILIES = dict(loop_entry=r"\b(?:chain|walk)_loop_entry_kernel",
                       segment_entry=r"_segment_entry_kernel",
                       sa_loop=r"\bsa_loop_(?:entry|cond)_kernel",
                       sa_stage=r"\bsa_stage_entry_kernel",
                       index_put=r"index_elementwise_kernel|index_put",
                       scan=r"(?i)scan")


def engine_call(sd, queries):
    """The engine's part of one chunk, as DeviceSeeder.run_flat runs it
    before it reads the head (the part ``prof["device_s"]`` times): the
    upload, the programs, the call (the call graph's replay, or the eager
    _run), the head's fetch and, unless the head flags an overflow, the
    seed matrix's first seed_bucket columns.  Nothing responds to an
    overflow (no rerun, no change of caps or engine), so a chunk that
    overflows the engine's caps can be timed and profiled on the engine's
    own route.  Returns the head and the seconds from the call to the
    last fetch (what ``prof["device_s"]`` holds after run_flat)."""
    from compseed_tpu_torch.ops.seeder2 import seed_bucket
    R, L, qd, rd = sd._upload(queries)
    fns = sd._build(R, L)
    t0 = time.time()
    head_d, seed_d = sd._call(fns, qd, rd)
    head = head_d.cpu().numpy()
    if not head[3:14].any():
        seed_d[:, :seed_bucket(head[1], fns["sizes"][4])].cpu()
    return head, time.time() - t0


def profile_chunk(run, sync, records=()) -> dict:
    """torch.profiler over one call of ``run`` (one chunk of seeding):
    the CUDA runtime calls that cost host time (kernel and graph
    launches, stream syncs, async copies; ``launches`` the host's
    cudaLaunchKernel and cudaGraphLaunch calls), what the card ran
    (``ran_kernels``, ``ran_memsets``, ``ran_copies``: a graph's kernels
    are launched by one host call; ``ran_by_family``: KERNEL_FAMILIES'
    counts) and the card's busy time, the union of
    the kernels' and copies' intervals on the device.  Also the wall time of the same call
    without the profiler, right after, and the mean device time per
    launch of each FM, chain and walk kernel; for each kernel of
    ``records``, the device ms of each of its launches in the order they
    ran (``records``).
    ``scripts/torch_seeding_ab.py --profile`` runs the same pass on other
    checkouts."""
    from torch.profiler import ProfilerActivity, profile
    calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
             "cudaStreamSynchronize", "cudaMemcpyAsync",
             "cudaDeviceSynchronize")
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_prof = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    run()
    sync()
    wall = time.perf_counter() - t0
    out = {c: 0 for c in calls}
    kernel_ms = {}
    for e in prof.key_averages():
        if e.key in out:
            out[e.key] = e.count
        m = re.search(
            r"\b((?:fm|chain|walk|sa|smem|scan|fwd)_[a-z_]+_kernel)", e.key)
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if m and dev_us:
            r = kernel_ms.setdefault(m.group(1),
                                     dict(launches=0, device_us=0.0))
            r["launches"] += e.count
            r["device_us"] += dev_us
    for r in kernel_ms.values():
        r["device_ms_per_launch"] = r.pop("device_us") / 1e3 / r["launches"]
    spans = []
    recs = {k: [] for k in records}
    ran = dict(kernels=0, memsets=0, copies=0)
    families = dict.fromkeys(KERNEL_FAMILIES, 0)
    for e in prof.events():
        dt = str(getattr(e, "device_type", ""))
        if dt.endswith("CUDA"):
            ran[device_kind(e.name)] += 1
            for fam, pat in KERNEL_FAMILIES.items():
                families[fam] += bool(re.search(pat, e.name))
        if dt.endswith("CUDA") and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            for k in records:
                if k in e.name:
                    recs[k].append((e.time_range.start, (
                        e.time_range.end - e.time_range.start) / 1e3))
    spans.sort()
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    out.update(launches=out["cudaLaunchKernel"] + out["cudaLaunchKernelExC"]
               + out["cudaGraphLaunch"],
               ran_kernels=ran["kernels"], ran_memsets=ran["memsets"],
               ran_copies=ran["copies"], ran_by_family=families,
               wall_s_profiled=wall_prof, wall_s=wall,
               device_busy_s=busy_us / 1e6,
               busy_pct_of_wall=100.0 * busy_us / 1e6 / wall,
               busy_pct_of_profiled=100.0 * busy_us / 1e6 / wall_prof,
               device_events=len(spans), kernels=kernel_ms,
               records={k: [ms for _, ms in sorted(v)]
                        for k, v in recs.items()})
    return out


def dp_bound_ms(tiles, cells: int):
    """Bound of one DP launch on tiles: each input read once and the
    output written once, against the band cells this data needs."""
    P = tiles[1].shape[0]
    return ops_bound(sum(x.numel() * x.element_size() for x in tiles)
                     + P * 8 * 4, cells)


def dual_bound_ms(meta, cells: int):
    """Bound of one fused launch: the pair table, the read bytes (one a
    query code) and the packed-reference bytes (8 per 16 bases as stored)
    that its pairs touch, and the output; cells over both rounds."""
    P = meta.shape[0]
    touched = int(meta[:, 2].clamp(min=0).sum()) \
        + int(meta[:, 6].clamp(min=0).sum()) // 2
    return ops_bound(P * 12 * 4 + touched + 25 * 4 + P * 8 * 4, cells)


def err(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_dual(args, kw, gap):
    """One pair table through the fused kernel and its plain version with
    int32 and with int16 rows.  Returns max_abs_err and times per variant,
    the band cells of both rounds (counted by the plain DP's loop bounds)
    and the tiles decoded from the table with round 0's bands."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core, _meta_dual_plain
    mat, qflat, pac, meta = args
    i32 = torch.int32

    def kern(s16):
        return lambda: bsw_cuda.bsw_meta_dual(*args, **kw, state16=s16)

    def plain(s16):
        return lambda: _meta_dual_plain(*args, **kw, state16=s16)

    r0 = meta[:, 4]
    if kw["wide_r0"]:
        r0 = (meta[:, 4].to(torch.int64) & 0xFFFFFFFF) | \
            (meta[:, 5].to(torch.int64) << 32)
    qt, ql, tt = bsw_cuda.build_tiles(
        qflat, pac, meta[:, 0:4], r0, meta[:, 6], Q=kw["Q"], T=kw["T"],
        L=kw["L"], l_pac=kw["l_pac"])
    col = lambda x: x[:, None].to(i32).contiguous()        # noqa: E731
    tiles = (mat, qt, col(ql), tt, col(meta[:, 6]), col(meta[:, 7]),
             col(meta[:, 9]))

    def cells_of(tl, ws):
        return _extend_core(*gap.values(), mat, ws, qt, ql.to(i32), tt, tl,
                            meta[:, 7], count_cells=True)

    out0, cells0 = cells_of(meta[:, 6], meta[:, 9])
    w0 = kw["w0"]
    accept0 = (out0[0] == meta[:, 8]) | (out0[5] < (w0 >> 1) + (w0 >> 2))
    _, cells1 = cells_of(torch.where(accept0, 0, meta[:, 6]), meta[:, 10])

    p32, p16 = plain(False)(), plain(True)()
    k32, k16 = kern(False)(), kern(True)()
    torch.cuda.synchronize()
    return dict(cells=int(cells0) + int(cells1), tiles=tiles,
                rejected=int((~accept0).sum()),
                err32=err(k32, p32), err16=err(k16, p16),
                k32_ms=cuda_time_ms(kern(False), 5),
                k16_ms=cuda_time_ms(kern(True), 5),
                p32_ms=cuda_time_ms(plain(False), 2),
                p16_ms=cuda_time_ms(plain(True), 2))


def fm_cases(dfi, rng) -> dict:
    """Every FM kernel against its plain version on the card, on seeded
    lanes at the main path's widths: max_abs_err per case (all must be
    0), and the launches the cases made (one per kernel call)."""
    import dataclasses

    import numpy as np
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops.fm_cases import (garbage, intervals, pack,
                                                 sa_lanes, windows)
    from compseed_tpu_torch.ops.smem import MLEP
    dev, dt = dfi.device, dfi.dtype
    oob = dataclasses.replace(dfi, fill_oob=True)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    errs, calls = {}, dict.fromkeys(FM_KERNELS, 0)
    n0 = dict(fm_cuda.LAUNCHES)

    def check(tag, kernel, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[tag] = max(err(g, w) for g, w in zip(got, want))
        calls[kernel] += 1

    def rand_c(n):
        return on(rng.integers(0, 4, n).astype(np.int32))

    # one-child extension: CHUNK lanes, a (2048, MLEP, 3) batch with a
    # broadcast child (the exact rerun's backward shrink), garbage lanes
    ik = intervals(dfi, rng, CHUNK, depth=14)
    c = rand_c(CHUNK)
    ikb = intervals(dfi, rng, 2048 * MLEP, depth=14).reshape(2048, MLEP, 3)
    cb = rand_c(2048)[:, None].expand(2048, MLEP)
    g = on(garbage(dfi, 2048)).to(dt)
    ikg = torch.stack([g, g.flip(0), torch.full_like(g, 9)], dim=1)
    cg = rand_c(2048)
    for is_back in (False, True):
        for tag, fm_, a, cc in (("lanes", dfi, ik, c), ("batch", dfi, ikb, cb),
                                ("fill_oob", oob, ikg, cg)):
            check(f"extend {tag} is_back={is_back}", "fm_extend_sel_kernel",
                  dfm.extend_sel_batch(fm_, a, cc, is_back),
                  dfm._extend_sel_plain(fm_, a, cc, is_back))

    # the chain walk: forward reps of a CHUNK-read round (U = CHUNK / 2),
    # W in {1, 5, 8, 10}, with and without stop_s, an ambiguous base at
    # every column; garbage lanes that step under fill_oob
    U = CHUNK // 2
    iku = intervals(dfi, rng, U, depth=14)
    valid = on(rng.random(U) < 0.9)
    stop = on(rng.integers(1, 40, U)).to(dt)
    gk = on(garbage(dfi, U)).to(dt)
    for W in (1, 5, 8, 10):
        wv = on(pack(windows(rng, U, W)))
        for is_back in (False, True):
            for stop_s in (None, stop):
                a = (wv, W, iku[:, 0].contiguous(), iku[:, 1].contiguous(),
                     iku[:, 2].contiguous(), valid)
                kw = dict(is_back=is_back, stop_s=stop_s)
                check(f"chain W={W} is_back={is_back} "
                      f"stop_s={stop_s is not None}", "fm_chain_walk_kernel",
                      fm_cuda.chain_walk(dfi, *a, **kw),
                      ss._chain_walk_plain(dfi, *a, **kw))
        if W == 8:
            a = (wv, W, gk, gk.flip(0), torch.full_like(gk, 9),
                 torch.ones_like(valid))
            check("chain fill_oob", "fm_chain_walk_kernel",
                  fm_cuda.chain_walk(oob, *a, is_back=True),
                  ss._chain_walk_plain(oob, *a, is_back=True))

    # the inverse-Psi walk: CHUNK lanes, some on sampled rows and dead
    # from the start, n_steps in {1, sa_intv, 2 sa_intv}; garbage lanes
    kk, steps, alive = (on(x) for x in sa_lanes(dfi, rng, CHUNK))
    for n in (1, dfi.sa_intv, 2 * dfi.sa_intv):
        check(f"inv_psi n_steps={n}", "fm_inv_psi_walk_kernel",
              fm_cuda.inv_psi_walk(dfi, kk, steps, alive, n),
              dfm._walk_plain(dfi, kk, steps, alive, n))
    gg = g.abs() | 1
    live = torch.ones(2048, dtype=torch.bool, device=dev)
    check("inv_psi fill_oob", "fm_inv_psi_walk_kernel",
          fm_cuda.inv_psi_walk(oob, gg, gg * 0, live, 3),
          dfm._walk_plain(oob, gg, gg * 0, live, 3))
    torch.cuda.synchronize()
    made = {k: fm_cuda.LAUNCHES[k] - n0[k] for k in FM_KERNELS}
    if made != calls:
        raise SystemExit(f"FM kernel launches counted {made}, expected one "
                         f"per kernel call: {calls}")
    return errs


class FmCapture:
    """Records the first call of each kind of the FM wrappers (inputs
    cloned) while a run goes through them, and counts the calls of each
    kind: the chain walk by direction, the inverse-Psi walk by step
    count, the extension by batch rank.  While it is active every seeding
    call runs eagerly (seeder2.EagerCalls) and chain_scan,
    walk_pool_chain and sa_batch_compact run their plain versions: in a
    loop's graph the walk's inputs exist on the card alone, and the plain
    version (its outputs equal) launches the same walk kernel on them
    from the host."""

    def __init__(self):
        from compseed_tpu_torch.ops import fm as dfm
        from compseed_tpu_torch.ops import fm_cuda, seeder2
        from compseed_tpu_torch.ops import seedscan as ss
        self.mod, self.ss, self.fm = fm_cuda, ss, dfm
        self.eager = seeder2.EagerCalls()
        self.orig = dict(chain_walk=fm_cuda.chain_walk,
                         inv_psi_walk=fm_cuda.inv_psi_walk,
                         extend_sel_batch=fm_cuda.extend_sel_batch)
        self.rounds = dict(_chain_round=ss._chain_round,
                           _walk_round=ss._walk_round)
        self.sa_compact = dfm._sa_compact
        self.calls = {}
        self.counts = {}            # calls by key

    def _clone(self, x):
        import torch
        return x.clone() if isinstance(x, torch.Tensor) else x

    def __enter__(self):
        def wrap(name, key):
            fn = self.orig[name]

            def w(*a, **kw):
                k = (name,) + key(*a, **kw)
                self.counts[k] = self.counts.get(k, 0) + 1
                if k not in self.calls:
                    self.calls[k] = (tuple(self._clone(x) for x in a),
                                     {n: self._clone(v)
                                      for n, v in kw.items()})
                return fn(*a, **kw)
            setattr(self.mod, name, w)

        wrap("chain_walk", lambda *a, **kw: (kw.get("is_back", False),))
        wrap("inv_psi_walk", lambda *a, **kw: (a[4],))
        wrap("extend_sel_batch", lambda *a, **kw: (a[1].dim(),))
        self.ss._chain_round = lambda dev: self.ss._chain_round_plain
        self.ss._walk_round = lambda dev: self.ss._walk_round_plain
        self.fm._sa_compact = lambda dev: self.fm._sa_batch_compact_plain
        self.eager.__enter__()
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)
        for name, fn in self.rounds.items():
            setattr(self.ss, name, fn)
        self.fm._sa_compact = self.sa_compact
        self.eager.__exit__()


def fm_rank_need(dfi, x, bases):
    """What ranks at the ($-adjusted) positions x (int64, one per rank)
    need of the occ table: (distinct occ words, words ranked).  bases
    (len(x), 4) bool: the checkpoint counts each rank reports.  A row is
    the block x >> 7 (a negative block wraps); a block beyond the table
    is fill_oob's all-ones row and reads nothing."""
    import torch
    n = dfi.n_rows
    nw = ((x & 127) >> 5) + 1           # hi / lo words up to x's own
    blk = x >> 7
    inr = (blk >= -n) & (blk < n)
    blk, nw_in, bases = torch.remainder(blk[inr], n), nw[inr], bases[inr]
    top = torch.zeros(n, dtype=torch.int64, device=x.device).scatter_reduce(
        0, blk, nw_in, "amax")
    cnt = torch.unique((blk[:, None] * 4 + torch.arange(
        4, device=x.device)[None, :])[bases]).numel()
    return int(2 * top.sum()) + cnt, int(nw.sum())


def fm_extend_need(dfi, x, s, c):
    """fm_rank_need for one-child extensions of bi-intervals with searched
    coordinate x and size s (index dtype) by child c: the two occ4
    queries at x - 1 and x - 1 + s, each a rank unless at -1, reporting
    the counts of bases c..3 (the child's and the sizes above it).
    Returns (distinct occ words, words ranked, ranks)."""
    import torch
    xm1 = x - 1
    k = torch.cat([xm1, xm1 + s]).to(torch.int64)
    c = torch.cat([c, c]).to(torch.int64)
    made = k != -1
    k, c = k[made], c[made]
    k = k - (k >= dfi.primary).to(torch.int64)
    bases = torch.arange(4, device=k.device)[None, :] >= c[:, None]
    nwords, ranked = fm_rank_need(dfi, k, bases)
    return nwords, ranked, int(k.shape[0])


def launch_ms(run, reps: int, flush=None) -> float:
    """ms per launch of ``run``'s kernel on the card alone: ``reps`` calls
    captured in a CUDA graph and replayed (graph_time_ms; a replayed
    launch costs about 1 us of its own).  With ``flush``, every call comes
    after flush() (an eviction of L2), and the flushes alone are taken
    off: the time a caller whose rows are not in L2 sees."""
    if flush is None:
        return graph_time_ms(run, reps, 5)
    return graph_time_ms(lambda: (flush(), run()), reps, 5) - \
        graph_time_ms(flush, reps, 5)


def l2_flush(dev):
    """A function that evicts L2 (writes 128 MB, 2.5 x its 50 MB)."""
    import torch
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    return buf.zero_


def fm_measure(key, call, reps: int = 20, flush=None) -> dict:
    """A captured FM call through its kernel and its plain version:
    max_abs_err, CUDA-event ms per call of each in a loop of calls (the
    kernel's bound by the host's launch rate), the kernel's ms per launch
    on the card alone (launch_ms, with ``flush`` from cold L2), and the
    bound from the occ words and the operations this call's data needs.
    (Not the profiler: late in this long process its sessions dropped
    kernel records, 2 and 0 of 20 seen on the H100, while one session
    over a chunk, profile_chunk, keeps its own.)"""
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as ss
    a, kw = call
    dfi = a[0]
    es = torch.empty(0, dtype=dfi.dtype).element_size()
    name = key[0]
    if name == "chain_walk":
        kernel, plain = fm_cuda.chain_walk, ss._chain_walk_plain
    elif name == "inv_psi_walk":
        kernel, plain = fm_cuda.inv_psi_walk, dfm._walk_plain
    else:
        kernel, plain = fm_cuda.extend_sel_batch, dfm._extend_sel_plain
    got, want = kernel(*a, **kw), plain(*a, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    e = max(err(g, w) for g, w in zip(got, want))
    k_ms = cuda_time_ms(lambda: kernel(*a, **kw), reps)
    g_ms = launch_ms(lambda: kernel(*a, **kw), reps, flush)
    p_ms = cuda_time_ms(lambda: plain(*a, **kw), max(reps // 4, 2))
    i64 = torch.int64
    if name == "chain_walk":
        _, wv, W, k, l, s, valid = a[:7]
        is_back = kw.get("is_back", False)
        ck, cl, cs, ln = want
        # the state before column j, and the columns each lane stepped
        prev = [torch.cat([x[:, None], c[:, :-1]], 1) for x, c in
                ((k.to(dfi.dtype), ck), (l.to(dfi.dtype), cl),
                 (s.to(dfi.dtype), cs))]
        stepped = torch.arange(W, device=k.device)[None, :] < ln[:, None]
        base = ((wv.to(i64)[:, None] >> (3 * torch.arange(
            W, device=k.device))) & 7).clamp(0, 3)
        c = (base if is_back else 3 - base)[stepped]
        x, sz = prev[0 if is_back else 1][stepped], prev[2][stepped]
        nwords, ranked, ranks = fm_extend_need(dfi, x, sz, c)
        ops = ranked * FM_OPS_WORD + ranks * FM_OPS_RANK + \
            int(ln.sum()) * FM_OPS_EXTEND
        U = k.shape[0]
        nbytes = nwords * FM_WORD_BYTES + U * (8 + 3 * es + 1) + \
            (U * es if kw.get("stop_s") is not None else 0) + \
            U * (3 * W * es + 4)
        shape = f"U={U} W={W} is_back={is_back}"
    elif name == "inv_psi_walk":
        _, kk, steps, alive, n = a
        # replay the walk a step at a time: the rows each live lane ranks
        # in, at x = k - (k > primary) (k == primary needs none)
        xs, k_, st_, al_ = [], kk, steps, alive
        for _ in range(n):
            live = al_ & (k_ != dfi.primary)
            x = k_[live]
            xs.append(x - (x > dfi.primary).to(x.dtype))
            k_, st_, al_ = dfm._walk_plain(dfi, k_, st_, al_, 1)
        x = torch.cat(xs)
        c = dfm.bwt_b0_batch(dfi, x).to(i64)
        lanes4 = torch.arange(4, device=x.device)[None, :]
        nwords, ranked = fm_rank_need(dfi, x.to(i64), lanes4 == c[:, None])
        ranks = x.shape[0]
        ops = ranked * FM_OPS_WORD + ranks * (FM_OPS_RANK + FM_OPS_LF)
        N = kk.shape[0]
        nbytes = nwords * FM_WORD_BYTES + 2 * N * (2 * es + 1)
        shape = f"N={N} n_steps={n}"
    else:
        ik = a[1].reshape(-1, 3).to(dfi.dtype)
        fwd = 0 if a[3] else 1
        c = a[2].reshape(-1).to(i64)
        nwords, ranked, ranks = fm_extend_need(dfi, ik[:, fwd], ik[:, 2], c)
        n = ik.shape[0]
        ops = ranked * FM_OPS_WORD + ranks * FM_OPS_RANK + n * FM_OPS_EXTEND
        nbytes = nwords * FM_WORD_BYTES + n * (3 * es + 4) + n * 3 * es
        shape = f"ik {tuple(a[1].shape)} is_back={a[3]}"
    bound_ms, bound_by = bound_of(nbytes, ops)
    return dict(shape=shape, max_abs_err=e, ms=k_ms, graph_ms=g_ms,
                plain_ms=p_ms, words=nwords, bytes=nbytes, ops=ops,
                bound_ms=bound_ms, bound_by=bound_by)


def fm_main_path(dev, seeder, queries, l32):
    """Phase 4's FM numbers: each FM kernel's launches per chunk in the
    int32 window (``l32``), the main path's own calls (the first of each
    kind in one run of the first chunk, and the calls of each kind that
    run makes) through each kernel and its plain version, the profiler's
    counts over that chunk, and round 1's live lanes before each round
    (chain_scan's ``report_rounds``).  The run must build no occ table
    (it is built once per index).  Returns (record, the captured
    calls)."""
    import torch
    from compseed_tpu_torch.ops import device_index
    from compseed_tpu_torch.ops import seedscan as ss
    per_chunk = {k: l32[k] / ((RUNS + 1) * N_CHUNKS) for k in FM_KERNELS}
    log(f"[4] FM kernel launches per {CHUNK}-read chunk (int32 window): "
        f"{json.dumps(per_chunk)}")
    pack, packs = device_index.pack_occ_rows, []
    device_index.pack_occ_rows = lambda rows: packs.append(1) or pack(rows)
    try:
        with FmCapture() as cap:
            seeder.run_flat(queries)
        torch.cuda.synchronize()
    finally:
        device_index.pack_occ_rows = pack
    if packs:
        raise SystemExit(f"a chunk built the occ table {len(packs)} "
                         f"time(s): it is built once per index")
    by_kind = {"/".join(map(str, k)): v for k, v in cap.counts.items()}
    log(f"[4] FM calls in one run of the first chunk, by kind: "
        f"{json.dumps(by_kind)}")
    calls = {}
    for key, call in cap.calls.items():
        r = fm_measure(key, call)
        calls["/".join(map(str, key))] = r
        log(f"[4] main path's {key[0]} {r['shape']}: kernel max_abs_err "
            f"{r['max_abs_err']}, {r['ms']:.4f} ms in a loop, "
            f"{r['graph_ms']:.5f} ms replayed from a graph (plain "
            f"{r['plain_ms']:.3f} ms); {r['words']} occ words, {r['ops']} "
            f"ops, bound {r['bound_ms']:.6f} ms by {r['bound_by']}")
        if r["max_abs_err"]:
            raise SystemExit(f"{key[0]}: the kernel disagrees with its plain "
                             f"version on the main path's lanes")
    seeder.run_flat(queries)        # the shape's call graph kept first
    prof = profile_chunk(lambda: seeder.run_flat(queries),
                         torch.cuda.synchronize)
    log(f"[4] torch.profiler over one {CHUNK}-read chunk: "
        f"{json.dumps(prof)}")
    R, L, qd, rd = seeder._upload(queries)
    dfi, CW = seeder.dfi, seeder.chain_w
    M = (256 // CW) * R
    memo = ss.make_chain_memo(1 << (4 * M - 1).bit_length(), M, CW,
                              dfi.dtype, dev)
    res = ss.chain_scan(dfi, qd, rd, seeder.GP_F * R, memo, W=CW,
                        u_cap=max(R // 2, 64), report_rounds=True)
    rnd = int(res[6])
    hist = res[7][:rnd].tolist()
    log(f"[4] round 1 of the first chunk: {rnd} chain_scan rounds, live "
        f"lanes before each: {hist}")
    return dict(launches_per_chunk=per_chunk, calls_first_chunk=by_kind,
                main_path_calls=calls, profile=prof,
                round1=dict(rounds=rnd, alive_hist=hist)), cap.calls


def fm_rows(fm_rec, row) -> list:
    """The FM kernels' rows of the kernel table.  launches: the int32
    window of the main path (chain walk, inverse-Psi walk) and
    fwd_staged's first chunk with its staged walk's plain version patched
    in (extension: no path of the seeder launches it, since the exact
    rerun's calls, the lockstep scan and walks and fwd_staged's forward
    stages are kernels of their own; ``rerun_launches``, the forced
    overflow's rerun's, 0, beside it); times and bounds: the first such
    call of the main path (forward chain walk; the inverse-Psi walk's
    first stage) and of that run (its extension); the walks' latency floor:
    their steps times one dependent step's latency on the bench table
    (fm_latency); max_abs_err: over every comparison of the kernel (phase
    2, the captured calls and the 2^30-base table); the inverse-Psi
    walk's ``loop_tail``: its folded loop test (sa_tail)."""
    calls = fm_rec["main_path_calls"]
    ext = fm_rec["extend_sel"]
    errs = {k: 0 for k in FM_KERNELS}
    for e in fm_rec["phase2_max_abs_err"].values():
        for tag, v in e.items():
            k = {"extend": "fm_extend_sel_kernel",
                 "chain": "fm_chain_walk_kernel",
                 "inv_psi": "fm_inv_psi_walk_kernel"}[tag.split()[0]]
            errs[k] = max(errs[k], v)
    large = fm_rec["redesign"]["large"]["calls"]
    for name, r in list(calls.items()) + list(ext.items()) + [
            ("chain_walk", large["forward"]), ("chain_walk", large["backward"]),
            ("inv_psi_walk", large["inv_psi"]),
            ("extend_sel_batch", large["extend"])]:
        k = ("fm_chain_walk_kernel" if name.startswith("chain_walk") else
             "fm_inv_psi_walk_kernel" if name.startswith("inv_psi_walk")
             else "fm_extend_sel_kernel")
        errs[k] = max(errs[k], r["max_abs_err"])
    fwd = calls["chain_walk/False"]
    first = min((n for n in calls if n.startswith("inv_psi_walk")),
                key=lambda n: int(n.split("/")[1]))
    walk, walk_n = calls[first], int(first.split("/")[1])
    fwd_w = int(re.search(r"W=(\d+)", fwd["shape"]).group(1))
    flat = ext["rank2"]
    prof = fm_rec["profile"]["kernels"]
    lat = fm_rec["redesign"]["bench_latency"]["new"]

    def more(name, r, **kw):
        return dict(shape=r["shape"], per_chunk=fm_rec["launches_per_chunk"]
                    [name], graph_ms=r["graph_ms"],
                    device_ms_profiled=prof.get(name, {}).get(
                        "device_ms_per_launch"), source=FM_SOURCE, **kw)

    return [
        row("fm_extend_sel_kernel",
            "compseed_tpu/ops/fm.py:128 (XLA fusion, no Pallas)",
            fm_rec["ext_launches"], errs["fm_extend_sel_kernel"],
            flat["ms"], flat["plain_ms"], flat,
            **more("fm_extend_sel_kernel", flat,
                   launches_path="fwd_staged's first chunk, its staged "
                                 "walk's plain version patched in "
                                 "(seedscan._fwd_route)",
                   rerun_launches=fm_rec["rerun_launches"],
                   large_graph_ms=large["extend"]["graph_ms"])),
        row("fm_chain_walk_kernel",
            "compseed_tpu/ops/seedscan.py:1341 (XLA fusion, no Pallas)",
            fm_rec["main_launches"]["fm_chain_walk_kernel"],
            errs["fm_chain_walk_kernel"], fwd["ms"], fwd["plain_ms"], fwd,
            **more("fm_chain_walk_kernel", fwd,
                   backward=calls.get("chain_walk/True"),
                   latency_floor_ms=fwd_w * lat["chain_step_ms"])),
        row("fm_inv_psi_walk_kernel",
            "compseed_tpu/ops/fm.py:166 (XLA fusion, no Pallas)",
            fm_rec["main_launches"]["fm_inv_psi_walk_kernel"],
            errs["fm_inv_psi_walk_kernel"], walk["ms"], walk["plain_ms"],
            walk, **more("fm_inv_psi_walk_kernel", walk,
                         latency_floor_ms=walk_n * lat["psi_step_ms"],
                         loop_tail=fm_rec.get("sa_loop_tail")))]


class OldFmBuild:
    """The kernels of an earlier csrc/fm_walk.cu (--fm-old-source), whose
    extension reads the (n_rows, 12) int64 occ rows and whose walks read
    ``occ_packed``: its C launchers take the arguments of the port's
    (ops/fm_cuda._bind).  The extension's int64 rows are unpacked from the
    index's packed table (``unpack_occ_rows``) at its first call on that
    table, for these comparisons only, and dropped by ``free()``.  Called
    on tensors that ``prep_call`` prepared, as the port's own wrappers are
    in the turns beside it."""

    def __init__(self, lib):
        from compseed_tpu_torch.ops import fm_cuda
        fm_cuda._bind(lib)
        self.lib = lib
        self.rows64 = {}            # occ_packed's address -> int64 rows

    def _index(self, fm, rows):
        return (rows.data_ptr(), fm.n_rows, fm.L2.data_ptr(),
                int(fm.primary), int(bool(fm.fill_oob)))

    def _rows64(self, fm):
        import numpy as np
        import torch
        from compseed_tpu_torch.ops.device_index import unpack_occ_rows
        key = fm.occ_packed.data_ptr()
        if key not in self.rows64:
            self.rows64[key] = torch.from_numpy(unpack_occ_rows(
                fm.occ_packed.cpu().numpy()).astype(np.int64)).to(fm.device)
        return self.rows64[key]

    def free(self):
        """Drop the int64 rows made for the extension."""
        self.rows64.clear()

    @staticmethod
    def _done(name, rc):
        if rc:
            raise SystemExit(f"{name}: CUDA error {rc}")

    def extend_sel_batch(self, fm, ik, c, is_back):
        import torch
        out = torch.empty_like(ik)
        self._done("fm_extend_sel_launch", self.lib.fm_extend_sel_launch(
            *self._index(fm, self._rows64(fm)), ik.data_ptr(), c.data_ptr(),
            int(bool(is_back)), out.data_ptr(), ik.shape[0],
            int(fm.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream))
        return out

    def chain_walk(self, fm, wv, W, k, l, s, valid, is_back=False,
                   stop_s=None):
        import torch
        U, dt = k.shape[0], fm.dtype
        ck, cl, cs = (torch.empty((U, W), dtype=dt, device=k.device)
                      for _ in range(3))
        ln = torch.empty(U, dtype=torch.int32, device=k.device)
        self._done("fm_chain_walk_launch", self.lib.fm_chain_walk_launch(
            *self._index(fm, fm.occ_packed), wv.data_ptr(), k.data_ptr(),
            l.data_ptr(), s.data_ptr(), valid.data_ptr(),
            None if stop_s is None else stop_s.data_ptr(), int(bool(is_back)),
            W, ck.data_ptr(), cl.data_ptr(), cs.data_ptr(), ln.data_ptr(), U,
            int(dt == torch.int64), torch.cuda.current_stream().cuda_stream))
        return ck, cl, cs, ln

    def inv_psi_walk(self, fm, kk, steps, alive, n_steps):
        import torch
        out = (torch.empty_like(kk), torch.empty_like(steps),
               torch.empty_like(alive))
        self._done("fm_inv_psi_walk_launch", self.lib.fm_inv_psi_walk_launch(
            *self._index(fm, fm.occ_packed), kk.data_ptr(), steps.data_ptr(),
            alive.data_ptr(), n_steps, fm.sa_intv - 1,
            *(x.data_ptr() for x in out), kk.shape[0],
            int(fm.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream))
        return out


def fm_walk_builds(old_source) -> dict:
    """name -> the FM kernels of one build, in the order of a turn: with
    ``old_source`` (an earlier fm_walk.cu) "old", built from that file,
    then "new", the port's own wrappers and library."""
    import ctypes as ct
    from compseed_tpu_torch.ops import cuda_lib, fm_cuda
    fm_cuda.LIB.load()
    if not old_source:
        return {"new": fm_cuda}
    so = os.path.join(cuda_lib.BUILD, "libfm_walk_old.so")
    cuda_lib.compile_source(os.path.abspath(old_source), so)
    return {"old": OldFmBuild(ct.CDLL(so)), "new": fm_cuda}


def free_builds(builds: dict) -> None:
    """Drop what the builds made for one table (the old extension's int64
    rows)."""
    for b in builds.values():
        if isinstance(b, OldFmBuild):
            b.free()


def prep_call(key, call):
    """A captured FM call's arguments as the wrapper hands them to the
    launcher (index dtype, int32 children, int64 window words, bool masks,
    flat and contiguous): (function name, args, kwargs)."""
    import torch
    a, kw = call
    fm, dt = a[0], a[0].dtype
    if key[0] == "extend_sel_batch":
        fm, ik, c, is_back = a
        return key[0], (fm, ik.to(dt).reshape(-1, 3).contiguous(),
                        c.to(torch.int32).reshape(-1).contiguous(),
                        is_back), {}
    if key[0] == "inv_psi_walk":
        fm, kk, steps, alive, n = a
        return key[0], (fm, kk.to(dt).contiguous(), steps.to(dt).contiguous(),
                        alive.to(torch.bool).contiguous(), n), {}
    fm, wv, W, k, l, s, valid = a
    stop = kw.get("stop_s")
    return key[0], (fm, wv.to(torch.int64).contiguous(), W,
                    *(x.to(dt).contiguous() for x in (k, l, s)),
                    valid.to(torch.bool).contiguous()), dict(
        is_back=kw.get("is_back", False),
        stop_s=None if stop is None else stop.to(dt).contiguous())


def fm_turns(builds: dict, cases: dict, reps: int = 20,
             flush=None) -> dict:
    """Each case (name -> (key, call) of an FM call) through each build:
    held to the plain version exactly (max_abs_err per build; all must be
    0), then timed in turns (the builds in order, then in reverse): ms per
    call in a loop of calls and ms per launch on the card alone
    (launch_ms, with ``flush`` from cold L2).  name -> {build:
    {max_abs_err, loop_ms, graph_ms}}."""
    import functools

    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import seedscan as ss
    plains = {"chain_walk": ss._chain_walk_plain,
              "inv_psi_walk": dfm._walk_plain,
              "extend_sel_batch": dfm._extend_sel_plain}
    order = list(builds) + list(builds)[::-1]
    out = {}
    for name, (key, call) in cases.items():
        fn, a, kw = prep_call(key, call)
        want = plains[fn](*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        rec = {}
        for b, build in builds.items():
            got = getattr(build, fn)(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            rec[b] = dict(max_abs_err=max(err(g, w) for g, w in
                                          zip(got, want)),
                          loop_ms=[], graph_ms=[])
            if rec[b]["max_abs_err"]:
                raise SystemExit(f"{name}: build {b} disagrees with the plain "
                                 f"version")
        for b in order:
            run = functools.partial(getattr(builds[b], fn), *a, **kw)
            rec[b]["loop_ms"].append(cuda_time_ms(run, reps))
            rec[b]["graph_ms"].append(launch_ms(run, reps, flush))
        out[name] = rec
    return out


def fm_latency(builds: dict, dfi, flush=None) -> dict:
    """The dependent-step latency of each build's walks on ``dfi``: the
    chain walk at 32 lanes with W = 1 and W = 10 (every lane valid, no
    ambiguous code, so every lane takes W steps) and the inverse-Psi walk
    at 32 lanes with 1 and 10 steps (sa_intv raised so that no sampled
    row ends a walk), ms per launch on the card alone in turns
    (launch_ms, with ``flush`` from cold L2).  (t10 - t1) / 9 is one
    step's latency (the replay's own cost per launch cancels): build ->
    {chain_step_ms, psi_step_ms, turns}."""
    import dataclasses

    import torch
    from compseed_tpu_torch.ops.fm_cases import (random_chain_lanes,
                                                 random_sa_lanes)
    gen = torch.Generator(device=dfi.device).manual_seed(29)
    long = dataclasses.replace(dfi, sa_intv=1 << 30)
    cases = {f"chain W={W}": (("chain_walk", False), random_chain_lanes(
        dfi, gen, 32, W, False, clean=True)) for W in (1, 10)}
    cases.update({f"psi n={n}": (("inv_psi_walk", n), random_sa_lanes(
        long, gen, 32, n)) for n in (1, 10)})
    turns = fm_turns(builds, cases, reps=50, flush=flush)

    def mean(case, b):
        return statistics.mean(turns[case][b]["graph_ms"])
    return {b: dict(chain_step_ms=(mean("chain W=10", b)
                                   - mean("chain W=1", b)) / 9,
                    psi_step_ms=(mean("psi n=10", b) - mean("psi n=1", b))
                    / 9,
                    turns={c: turns[c][b]["graph_ms"] for c in turns})
            for b in builds}


LARGE_BASES = 1 << 30      # the random table larger than L2: 8,388,609 rows
LARGE_SEED = 808
LARGE_EXTEND_LANES = 131072


def index_bytes(make) -> tuple:
    """(index, record) for ``make()``, an index built on the card: its bytes
    there (torch.cuda.memory_allocated around the call), its occ table's
    bytes and rows, and the peak above what it keeps while it was built.
    Fails unless the index holds one occ table of 64 bytes a row and its
    build never held as much again as half an int64 copy of the rows
    would add (32 B a row)."""
    import dataclasses

    import torch
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d = make()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - m0
    extra = torch.cuda.max_memory_allocated() - m0 - grown
    occ = [f.name for f in dataclasses.fields(d) if f.name.startswith("occ")]
    rec = dict(rows=d.n_rows, occ_bytes=d.occ_packed.untyped_storage()
               .nbytes(), index_bytes=grown, load_peak_extra=extra)
    if occ != ["occ_packed"] or rec["occ_bytes"] != 64 * d.n_rows:
        raise SystemExit(f"the index holds {occ}, {rec['occ_bytes']} B: "
                         f"expected one occ table of 64 B a row")
    if extra >= 32 * d.n_rows:
        raise SystemExit(f"building the index held {extra} B more than it "
                         f"keeps: as much as an int64 copy of its rows")
    return d, rec


def fm_redesign(dev, builds: dict, calls: dict, dfi, fm_host) -> dict:
    """The FM kernels' builds against each other and the bound.  (a) The
    bench index's bytes (index_bytes around to_device of ``fm_host``).
    (b) The main path's captured forward and backward chain walk and every
    inverse-Psi stage through every build in turns, L2 warm as in a chunk
    (the bench table is 2 MB).  (c) A random BWT of 2^30 bases built on
    the card (fm_cases.random_index, through index_bytes; its first 2^16
    bases held to build_occ_rows): the forward and backward shapes, the
    first inverse-Psi stage and a LARGE_EXTEND_LANES-lane backward
    extension, uniform positions, log-uniform sizes, 1 % ambiguous codes,
    stop_s on the backward shape, through the port's kernels and their
    plain versions (fm_measure: exact, timed, bound by fm_rank_need) and
    every build in turns, each launch from cold L2 (l2_flush), as on an
    index that L2 cannot hold.  (d) The latency of one dependent step on
    both tables (fm_latency; cold on the large one)."""
    import torch
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.fm_cases import (random_chain_lanes,
                                                 random_extend_lanes,
                                                 random_index,
                                                 random_index_rows_match_build,
                                                 random_sa_lanes)
    bench_copy, bench_bytes = index_bytes(lambda: to_device(fm_host, dev))
    if not torch.equal(bench_copy.occ_packed, dfi.occ_packed):
        raise SystemExit("to_device made another occ table than the seeder's")
    del bench_copy
    main = {"forward": (("chain_walk", False), calls[("chain_walk", False)]),
            "backward": (("chain_walk", True), calls[("chain_walk", True)])}
    main.update({f"inv_psi n={k[1]}": (k, calls[k])
                 for k in sorted(k for k in calls if k[0] == "inv_psi_walk")})
    rec = dict(builds=list(builds), index_bytes=dict(bench=bench_bytes))
    rec["bench_turns"] = fm_turns(builds, main)
    rec["bench_latency"] = fm_latency(builds, dfi)
    log(f"[4] FM kernels, main path's calls by build in turns: "
        f"{json.dumps(rec['bench_turns'])}; one dependent step: "
        f"{json.dumps(rec['bench_latency'])}; bench index on the card: "
        f"{json.dumps(bench_bytes)}")

    t0 = time.time()
    big, rec["index_bytes"]["large"] = index_bytes(
        lambda: random_index(LARGE_BASES, LARGE_SEED, dev))
    built_s = time.time() - t0
    if not random_index_rows_match_build(big, 1 << 16):
        raise SystemExit("the random table's rows differ from "
                         "build_occ_rows' on its first 2^16 bases")
    gen = torch.Generator(device=dev).manual_seed(LARGE_SEED + 1)
    (_, wv, W, *_), _ = main["forward"][1]
    fwd = random_chain_lanes(big, gen, wv.shape[0], W, False)
    (_, wv, W, *_), _ = main["backward"][1]
    bwd = random_chain_lanes(big, gen, wv.shape[0], W, True, stop=True)
    first = min(k for k in calls if k[0] == "inv_psi_walk")
    kk = calls[first][0][1]
    psi = random_sa_lanes(big, gen, kk.shape[0], first[1])
    ext = random_extend_lanes(big, gen, LARGE_EXTEND_LANES, True)
    cases = {"forward": (main["forward"][0], fwd),
             "backward": (main["backward"][0], bwd),
             "inv_psi": (first, psi),
             "extend": (("extend_sel_batch", 2), ext)}
    flush = l2_flush(dev)
    large = {}
    for name, (key, call) in cases.items():
        large[name] = fm_measure(key, call, flush=flush)
        if large[name]["max_abs_err"]:
            raise SystemExit(f"{name} on the 2^30-base table: the kernel "
                             f"disagrees with its plain version")
    rec["large"] = dict(bases=LARGE_BASES, rows=big.n_rows,
                        built_s=built_s, calls=large,
                        flush_ms=graph_time_ms(flush, 20, 5),
                        turns=fm_turns(builds, cases, flush=flush),
                        latency=fm_latency(builds, big, flush=flush))
    free_builds(builds)
    del big, fwd, bwd, psi, ext, cases, flush
    torch.cuda.empty_cache()
    rec["large"]["phase_s"] = time.time() - t0
    log(f"[4] FM kernels on a random 2^30-base table "
        f"({rec['large']['rows']} rows, built in {built_s:.1f} s: "
        f"{json.dumps(rec['index_bytes']['large'])}), each launch from "
        f"cold L2: {json.dumps(rec['large'])}")
    return rec


# ---------------------------------------------------------------------------
# the exact rerun's per-read programs: csrc/smem_seed.cu

def smem_check(tag, calls, fm64) -> dict:
    """Every captured rerun call (``calls``: smem_cases.Call, int32 index)
    by its kernel, its output poisoned first (smem_cases.vs_plain),
    against its plain version on the card, and again on the same lanes
    over ``fm64``, the same genome with int64 positions: max abs err over
    the outputs of each kind (0: bit-equal), or exit 1."""
    import dataclasses

    from compseed_tpu_torch.ops import smem_cases
    errs = {}
    for call in calls:
        for dt, c in (("int32", call), ("int64", dataclasses.replace(
                call, fm=fm64))):
            key = f"{c.kind} {dt}"
            errs[key] = max(errs.get(key, 0), smem_cases.vs_plain(c))
    log(f"[smem] {tag}: {len(calls)} captured rerun calls, kernel vs plain "
        f"max_abs_err {json.dumps(errs)}")
    if any(errs.values()):
        raise SystemExit(f"{tag}: an smem kernel disagrees with its plain "
                         f"version: {errs}")
    return dict(calls=len(calls), max_abs_err=errs)


def old_build(module, source):
    """Another build of ``module``'s source (``source``: such as the
    parent's, --smem-old-source / --lockstep-old-source / --entry-old-csrc;
    its C launchers the port's), compiled with the port's csrc/ on the
    include path (after the file's own directory) into a library of its
    own and bound by ``module._bind``: {"lib", "log" (nvcc's output)};
    None without a source."""
    if not source:
        return None
    import ctypes as ct
    from compseed_tpu_torch.ops import cuda_lib
    name = os.path.splitext(os.path.basename(module.LIB.src))[0]
    so = os.path.join(cuda_lib.BUILD, f"lib{name}_old.so")
    out = cuda_lib.compile_source(os.path.abspath(source), so, includes=(
        os.path.dirname(module.LIB.src),))
    lib = ct.CDLL(so)
    module._bind(lib)
    err_name = getattr(lib, module.LIB._error_name)
    err_name.restype, err_name.argtypes = ct.c_char_p, [ct.c_int]
    return dict(lib=lib, log=out)


@contextlib.contextmanager
def launching(module, build):
    """``module``'s wrappers launch ``build``'s kernels (old_build's) for
    the block, in place of the port's library (counted as the port's);
    with ``build`` None, the port's own."""
    if build is None:
        yield
        return
    saved = module.LIB._lib
    module.LIB._lib = build["lib"]
    try:
        yield
    finally:
        module.LIB._lib = saved


def load_latency(dev, tables: dict, steps=(1000, 11000), turns: int = 3):
    """The card's latency of one dependent 16-byte load
    (csrc/load_chase.cu: one thread, each load's address the load
    before's result, the entries 64 bytes apart linked into one cycle in
    random order; each launch goes on from where the last one stopped),
    on each of ``tables`` (name -> its bytes: cell A's occ table, which L2
    holds, and a 2^30-base genome's, which it does not: its timed loads
    reach entries no load read before, all but ~10 % outside L2): the
    chase's ms over ``steps`` loads by CUDA events, in turns,
    (t[1] - t[0]) / (steps[1] - steps[0]) the ms a load: name -> {ms,
    bytes, turns}.  A measurement only: no path of the port runs it."""
    import ctypes as ct

    import torch
    from compseed_tpu_torch.ops import cuda_lib
    so = os.path.join(cuda_lib.BUILD, "libload_chase.so")
    cuda_lib.compile_source(os.path.join(ROOT, LOAD_CHASE_SOURCE), so)
    lib = ct.CDLL(so)
    lib.load_chase_launch.argtypes = [ct.c_void_p, ct.c_int, ct.c_longlong,
                                      ct.c_void_p, ct.c_void_p]
    lib.load_chase_launch.restype = ct.c_int
    out = {}
    gen = torch.Generator(device=dev).manual_seed(31)
    at = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, nbytes in tables.items():
        at.zero_()
        n = max(2, nbytes // 64)
        table = torch.zeros((n, 16), dtype=torch.int32, device=dev)
        perm = torch.randperm(n, generator=gen, device=dev)
        nxt = torch.empty_like(perm)
        nxt[perm] = perm.roll(-1)
        table[:, 0] = nxt.to(torch.int32)
        del perm, nxt

        def chase(k):
            e = lib.load_chase_launch(table.data_ptr(), 4, k, at.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            if e:
                raise SystemExit(f"load_chase_kernel failed: CUDA error {e}")

        chase(min(n, 1 << 20))                   # the table into L2, if it fits
        torch.cuda.synchronize()
        ms = {k: [] for k in steps}
        for turn in range(2 * turns):
            for k in (steps if turn % 2 == 0 else steps[::-1]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                chase(k)
                b.record()
                torch.cuda.synchronize()
                ms[k].append(a.elapsed_time(b))
        med = {k: statistics.median(v) for k, v in ms.items()}
        out[name] = dict(ms=(med[steps[1]] - med[steps[0]])
                         / (steps[1] - steps[0]), bytes=n * 64,
                         turns={str(k): v for k, v in ms.items()})
        del table
    log(f"[smem] the card's dependent 16-byte load (load_chase_kernel, one "
        f"thread): " + json.dumps({k: dict(us=v["ms"] * 1e3,
                                           bytes=v["bytes"])
                                   for k, v in out.items()}))
    return out


def strategy_step(call, builds: dict, reps: int = 20) -> dict:
    """One dependent step of each build's round-3 kernel (``builds``: name
    -> a context manager's maker, launching's): one lane, a read of the
    captured round-3 call ``call`` with no N, cut to 101 and to 11 bases,
    max_intv 0 (no hit, so every column past the first extends), each on
    the card alone (launch_ms) in turns; (t101 - t11) / 90 is one step,
    the replay's own cost per launch cancelling (fm_latency's method):
    name -> {step_ms, turns}."""
    import torch
    from compseed_tpu_torch.ops import smem_cases
    min_len, _, q, _ = call.args
    i = int(torch.nonzero((q[:, :101] < 4).all(1))[0])
    one = torch.ones(1, dtype=torch.bool, device=q.device)
    runs = {n: smem_cases.Call("strategy", call.fm, n, (
        min_len, 0, q[i:i + 1, :n].contiguous(), one), call.caps)
        for n in (11, 101)}
    ms = {b: {n: [] for n in runs} for b in builds}
    for b in list(builds) + list(builds)[::-1]:
        with builds[b]():
            for n, c in runs.items():
                ms[b][n].append(launch_ms(
                    lambda c=c: smem_cases.run(c, "kernel"), reps))
    return {b: dict(step_ms=(statistics.mean(v[101]) -
                             statistics.mean(v[11])) / 90, turns=v)
            for b, v in ms.items()}


def ptxas_usage(log: str) -> dict:
    """Each kernel's line of ptxas' report in ``log`` (cuda_lib.
    compile_source's output, which KernelLibrary.build keeps in ``log``):
    mangled name -> registers, spill stores and loads (bytes), stack frame
    and shared memory (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        rec = out.setdefault(name, {})
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            hit = re.search(pat, line)
            if hit:
                rec[key] = int(hit.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def kernel_usage(log: str, kernel: str) -> dict:
    """ptxas' registers, spills, stack and shared bytes of ``kernel``'s
    int32_t and int64_t instantiations in nvcc's output ``log`` (keyed
    "int32", or "int32/G" where a second template argument G, the
    collect kernel's threads a lane, follows)."""
    out = {}
    for name, rec in ptxas_usage(log or "").items():
        m = re.search(kernel + r"I([il])(?:Li(\d+)E)?E", name)
        if m:
            key = "int32" if m.group(1) == "i" else "int64"
            out[key + (f"/{m.group(2)}" if m.group(2) else "")] = rec
    return out


def occupancy_line(kernel: str, occ: dict, usage: dict) -> str:
    """One line of a kernel's residency on the card (the occupancy query,
    by index type and the call's lanes) and ptxas' registers and
    spills."""
    return f"[occupancy] {kernel}: " + "; ".join(
        f"{key}: {o['threads_per_lane']} threads a lane, "
        f"{o['blocks_per_sm']} blocks x {o['lanes_per_block']} lanes x "
        f"{o['sms']} SMs = {o['resident_lanes']} lanes resident, "
        f"{o['registers']} registers, {o['local_bytes']} local bytes, "
        f"{o['shared_bytes']} shared bytes a block" for key, o in occ.items()
    ) + f"; ptxas {json.dumps(usage)}"


def turns_ms(run, builds: dict, reps: int) -> dict:
    """``run()``'s ms on the card alone (launch_ms) with each of ``builds``
    (name -> a context manager's maker: launching's) in turns, the builds
    in order and then in reverse: name -> [ms, ms]."""
    out = {b: [] for b in builds}
    for b in list(builds) + list(builds)[::-1]:
        with builds[b]():
            out[b].append(launch_ms(run, reps))
    return out


def smem_time(calls, twin, step_ms: float, reps: int = 20, old=None,
              load_ms: float = 0.0) -> list:
    """Each captured rerun call (int32) by its kernel: ms in a loop of
    calls (CUDA events: the host's rate with the output's allocation) and
    on the card alone (launch_ms: a CUDA graph of ``reps`` launches,
    replayed); with ``old`` (old_build's: the parent's source) each call
    alone by both builds in turns (old, new, new, old: ``turns``), each
    build held to the plain version first, and one dependent step of
    each build's round-3 kernel (strategy_step); the plain version's
    ms (one call) for the first and second collect calls, the last (a
    round 2) and each round-3 call; the bound from smem_cases.work (the
    distinct occ rows' bytes and the lanes' against the ranks' operations)
    and the latency floors, the longest lane's dependent steps times
    ``step_ms`` (one dependent step of the chain walk on the same table,
    fm_latency: ``floor_ms``) and times ``load_ms`` (the card's dependent
    16-byte load from L2, load_latency: ``floor_load_ms``)."""
    from compseed_tpu_torch.ops import smem_cases, smem_cuda
    collects = [c for c in calls if c.kind == "collect"]
    timed_plain = {id(c) for c in collects[:2] + collects[-1:]} | {
        id(c) for c in calls if c.kind == "strategy"}
    builds = {"new": lambda: launching(smem_cuda, None)}
    if old is not None:
        builds = {"old": lambda: launching(smem_cuda, old), **builds}
    out = []
    for call in calls:
        w = smem_cases.work(call, twin)
        ops = w["words_ranked"] * FM_OPS_WORD + w["ranks"] * FM_OPS_RANK + \
            w["extensions"] * FM_OPS_EXTEND
        bound_ms, bound_by = bound_of(w["bytes"], ops)
        r = dict(kind=call.kind, lanes=call.lanes, L=call.L,
                 ms=cuda_time_ms(lambda: smem_cases.run(call, "kernel"), reps),
                 graph_ms=launch_ms(lambda: smem_cases.run(call, "kernel"),
                                    reps),
                 plain_ms=cuda_time_ms(lambda: smem_cases.run(call, "plain"),
                                       1) if id(call) in timed_plain else None,
                 bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                 floor_ms=w["max_steps"] * step_ms,
                 floor_load_ms=w["max_steps"] * load_ms, work=w)
        r["threads_per_lane"] = smem_cuda.occupancy(
            call.fm.dtype, call.args[2 if call.kind == "strategy" else 0]
            .device, call.lanes, f"smem_{call.kind}_kernel")[
                "threads_per_lane"]
        if old is not None:
            for name, b in builds.items():
                with b():
                    e = smem_cases.vs_plain(call)
                if e:
                    raise SystemExit(f"the {name} {call.kind} build disagrees "
                                     f"with the plain version at "
                                     f"{call.lanes} lanes: {e}")
            r["turns"] = turns_ms(lambda: smem_cases.run(call, "kernel"),
                                  builds, reps)
        out.append(r)
        log(f"[smem] {call.kind} P={call.lanes} L={call.L} "
            f"({r.get('threads_per_lane', 2)} threads a lane): "
            f"{r['ms']:.4f} ms in a loop, {r['graph_ms']:.5f} ms alone (plain "
            f"{r['plain_ms']}); in turns {json.dumps(r.get('turns'))}; "
            f"{w['rows']} occ rows, {w['bytes']} B, "
            f"{w['extensions']} extensions, steps max {w['max_steps']} mean "
            f"{w['mean_steps']:.1f}; bound {bound_ms:.6f} ms by {bound_by}, "
            f"floor {r['floor_ms']:.5f} ms (by the card's load latency "
            f"{r['floor_load_ms']:.5f})")
    for kind in ("collect", "strategy"):
        log(f"[smem] {kind}: the run's calls summed "
            f"{json.dumps(call_sums([r for r in out if r['kind'] == kind]))}")
    step = strategy_step(next(c for c in calls if c.kind == "strategy"),
                         builds, reps)
    log(f"[smem] round 3's dependent step (one lane, (t101 - t11) / 90) by "
        f"build: " + json.dumps({b: v["step_ms"] for b, v in step.items()})
        + f"; turns {json.dumps(step)}")
    for r in out:
        if r["kind"] == "strategy":
            r["step"] = step
    return out


def call_sums(recs) -> dict:
    """A kernel's calls of a run summed (smem_time's or lockstep_time's
    records): launches, ms alone, bound, floor, time less bound, and with
    turns each build's mean of its turns."""
    out = dict(calls=len(recs), graph_ms=sum(r["graph_ms"] for r in recs),
               bound_ms=sum(r["bound_ms"] for r in recs),
               floor_ms=sum(r["floor_ms"] for r in recs),
               floor_load_ms=sum(r["floor_load_ms"] for r in recs))
    out["gap_ms"] = out["graph_ms"] - out["bound_ms"]
    if recs and all("turns" in r for r in recs):
        out["turns_ms"] = {b: sum(statistics.mean(r["turns"][b])
                                  for r in recs) for b in recs[0]["turns"]}
    return out


def smem_rows(smem_rec, row) -> list:
    """The two rows of the exact rerun's kernels in the kernel table:
    launches in the forced overflow's run (phase 4 (b), counts set to 0
    just before it); ms (in a loop), graph_ms (alone), plain_ms, bound and
    floor at its first call of each kind (the first round-1 collect,
    16,384 lanes; round 3), every captured call's figures beside them;
    max_abs_err over every captured call of the forced overflow and the
    goldens, int32 and int64."""
    rows = []
    for kind, name in zip(("collect", "strategy"), SMEM_KERNELS):
        calls = [r for r in smem_rec["time"] if r["kind"] == kind]
        first = calls[0]
        errs = [v for rec in smem_rec["check"].values()
                for k, v in rec["max_abs_err"].items()
                if k.startswith(kind)]
        rows.append(row(
            name, SMEM_REPLACES[kind], smem_rec["launches"][name], max(errs),
            first["ms"], first["plain_ms"], first, source=SMEM_SOURCE,
            at=f"{first['lanes']} lanes, L = {first['L']}",
            graph_ms=first["graph_ms"], latency_floor_ms=first["floor_ms"],
            latency_floor_load_ms=first["floor_load_ms"],
            step=first.get("step"),
            calls=[{k: r.get(k) for k in ("lanes", "threads_per_lane", "ms",
                                          "graph_ms", "plain_ms", "bound_ms",
                                          "floor_ms", "floor_load_ms",
                                          "turns")}
                   for r in calls], summed=call_sums(calls),
            occupancy=smem_rec["occupancy" if kind == "collect"
                               else "strategy_occupancy"]))
    return rows


# ---------------------------------------------------------------------------
# the lockstep engines' loops: csrc/lockstep.cu

def lockstep_capture(dev, opt, fm, queries, force=None) -> list:
    """Every lockstep scan and walk-stage call (ops/lockstep_cases.Capture:
    each stage's loop of walk_stage and walk_pool) of one eager run of the
    first chunk through all_off and bwd_win, and every stage of
    fwd_staged's staged forward walk (FWD_STAGES) through fwd_staged (its
    run up to the merge, lockstep_cases.run_forward: the chunk overflows
    fwd_staged's rep caps, and at int64 its merged suffix-array lookup
    never ends, in the JAX package as here), with int32 (``force`` None)
    or int64 positions."""
    from compseed_tpu_torch.ops import lockstep_cases, seeder2
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    dfi = to_device(fm, dev, force_dtype=force)
    calls = []
    for name in ("all_off", "bwd_win", "fwd_staged"):
        dedup, knobs = ENGINES[name]
        with engine_env(knobs):
            sd = DeviceSeeder(opt, fm, dev, dfi=dfi, dedup=dedup)
            R, L, qd, rd = sd._upload(queries)
            fns = sd._build(R, L)
        with seeder2.EagerCalls(), lockstep_cases.Capture() as cap:
            if name == "fwd_staged":
                lockstep_cases.run_forward(sd, fns, qd, rd)
            else:
                sd._run(fns, qd, rd)
        calls += [(name, c) for c in cap.calls]
        del sd
    return calls


def lockstep_check(cases: dict) -> dict:
    """Every captured call (``cases``: tag -> lockstep_capture's) by the
    kernels against the plain version on the card: a scan's cnt, ovf,
    rows < cnt and the pools built from both (lockstep_cases.scan_vs); a
    stage's lanes, t and live (the entry, then the segments of its
    loop); a forward stage's state and records (lockstep_cases.fwd_vs: pf
    everywhere, the other records where j < steps), every kernel's outputs
    poisoned before its launch (lockstep_cases.vs_plain); max abs err by
    kernel and tag (0: bit-equal), or exit 1; fwd_staged's stages must
    number FWD_STAGES a tag."""
    from compseed_tpu_torch.ops import lockstep_cases
    errs, n = {}, {}
    kernels_of = dict(scan=("scan_lanes_kernel",),
                      walk=("walk_stage_kernel", "walk_stage_entry_kernel"),
                      fwd=("fwd_stage_kernel",))
    for tag, calls in cases.items():
        for engine, call in calls:
            e = lockstep_cases.vs_plain(call)
            for k in kernels_of[call.kind]:
                errs[f"{k} {tag}"] = max(errs.get(f"{k} {tag}", 0), e)
            n[f"{engine} {call.kind} {tag}"] = \
                n.get(f"{engine} {call.kind} {tag}", 0) + 1
    log(f"[2] the lockstep kernels against their plain versions on every "
        f"captured call of all_off's, bwd_win's and fwd_staged's first "
        f"chunk: calls {json.dumps(n)}, max_abs_err {json.dumps(errs)}")
    if any(errs.values()):
        raise SystemExit(f"a lockstep kernel disagrees with its plain "
                         f"version: {errs}")
    for tag in cases:
        if n.get(f"fwd_staged fwd {tag}") != FWD_STAGES:
            raise SystemExit(f"fwd_staged's first chunk ({tag}) ran "
                             f"{n.get(f'fwd_staged fwd {tag}')} forward "
                             f"stages, expected {FWD_STAGES}")
    return dict(calls=n, max_abs_err=errs)


def lockstep_entry_args(call):
    """A stage call's WalkLoop and its words, pointed at the stage with
    its entry's source, outside any loop: for the entry kernel alone."""
    from compseed_tpu_torch.ops import lockstep_cuda
    lp = lockstep_cuda.WalkLoop(call.fm, call.L, call.max_steps, call.qflat,
                                call.rwflat, call.t0, call.width)
    st = lp.lanes(call.st) if call.src is None else lp.empty_lanes(call.w)
    if call.src is not None:
        lp.live.fill_(call.live_in)
    lp._point(st, call.fit, call.src)
    return lp


def segment_ms(lp, reps: int) -> float:
    """The stage's first segment (walk_stage_kernel launched on its own,
    its loop word 0, so t stays) on the card alone: the entry run once to
    fill the lanes, which are then kept; each timed launch follows a copy
    of the kept lanes back, and the copies alone are taken off (the
    flush pattern of launch_ms)."""
    import ctypes as ct

    from compseed_tpu_torch.ops import lockstep_cuda
    lockstep_cuda._launch("walk_stage_entry_kernel", lp.dev, lp.args)
    st = {n: x for n, x in lp._keep[0].items()}
    snap = {n: x.clone() for n, x in st.items()}
    args = (ct.c_longlong * len(lp.args))(*lp.args)
    args[lp.AT["loop"]] = 0

    def restore():
        for n, x in st.items():
            x.copy_(snap[n])

    return launch_ms(lambda: (restore(), lockstep_cuda._launch(
        "walk_stage_kernel", lp.dev, args)), reps) - launch_ms(restore, reps)


@contextlib.contextmanager
def zeroing_parent(build):
    """lockstep_cuda.fwd_stage as the parent's tree ran it for the block:
    ``build``'s kernels (old_build's) on records zeroed before the launch,
    as its wrapper allocated them (torch.zeros)."""
    from compseed_tpu_torch.ops import lockstep_cuda
    records = lockstep_cuda._records
    lockstep_cuda._records = lambda *a: {n: x.zero_() for n, x in
                                         records(*a).items()}
    try:
        with launching(lockstep_cuda, build):
            yield
    finally:
        lockstep_cuda._records = records


def lockstep_time(calls, twin, step_ms: float, reps: int = 10,
                  old=None, load_ms: float = 0.0) -> list:
    """Each captured call (int32) on the card: a scan's or a forward
    stage's launch in a loop (CUDA events: the host's rate and its
    outputs' allocation with it) and alone (launch_ms: a CUDA graph of
    ``reps`` calls, replayed); with ``old`` (old_build's: the parent's
    source) each scan and forward stage alone by the parent's kernel and
    by the port's in turns (old, new, new, old: ``turns``), a forward
    stage's parent on zeroed records (zeroing_parent: what a stage cost
    there), each held to the plain version first; a stage's
    whole loop the same two ways (its entry, then its segments: in a loop
    each call captures, launches and frees its loop graph; alone the loop
    joins the replayed graph) and its entry kernel alone, the segment
    the plain version's ms (one call; a compacting entry's plain
    compaction, lockstep_cases.walk_entry_plain, alone); the bound from
    lockstep_cases.work (the distinct occ rows' and the lanes' bytes
    against the ranks' operations) and the latency floor, the longest
    lane's dependent extensions times ``step_ms`` (one dependent step of
    the chain walk on the same table, fm_latency) and times ``load_ms``
    (the card's dependent 16-byte load from L2, load_latency); a stage's
    first segment alone (segment_ms).  With ``old`` a stage's loop alone,
    its entry alone and its first segment alone by the parent's build and
    the port's in turns (``turns``, ``entry_turns``, ``segment_turns``),
    the parent's build held to the plain version first."""
    from compseed_tpu_torch.ops import lockstep_cases, lockstep_cuda
    turn_builds = {"old": lambda: launching(lockstep_cuda, old),
                   "new": lambda: launching(lockstep_cuda, None)}
    for engine, call in calls if old is not None else ():
        if call.kind in ("scan", "walk"):
            with launching(lockstep_cuda, old):
                e = lockstep_cases.vs_plain(call)
            if e:
                raise SystemExit(f"the parent's {call.kind} kernel disagrees "
                                 f"with the plain version on {engine}'s "
                                 f"call of {call.lanes} lanes: {e}")
    out = []
    for engine, call in calls:
        w = lockstep_cases.work(call, twin)
        ops = w["words_ranked"] * FM_OPS_WORD + w["ranks"] * FM_OPS_RANK + \
            w["extensions"] * FM_OPS_EXTEND
        bound_ms, bound_by = bound_of(w["bytes"], ops)
        r = dict(engine=engine, kind=call.kind, lanes=call.lanes,
                 ms=cuda_time_ms(lambda: lockstep_cases.run(call, "kernel"),
                                 reps),
                 graph_ms=launch_ms(lambda: lockstep_cases.run(
                     call, "kernel"), reps),
                 plain_ms=cuda_time_ms(lambda: lockstep_cases.run(
                     call, "plain"), 1),
                 bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                 floor_ms=w["max_steps"] * step_ms,
                 floor_load_ms=w["max_steps"] * load_ms, work=w)
        if call.kind == "walk":
            lp = lockstep_entry_args(call)
            r["entry_ms"] = launch_ms(lambda: lockstep_cuda._launch(
                "walk_stage_entry_kernel", lp.dev, lp.args), reps)
            if old is not None:
                r["entry_turns"] = {b: [] for b in turn_builds}
                for b in list(turn_builds) + list(turn_builds)[::-1]:
                    with turn_builds[b]():
                        r["entry_turns"][b].append(launch_ms(
                            lambda: lockstep_cuda._launch(
                                "walk_stage_entry_kernel", lp.dev, lp.args),
                            reps))
            _, t1, _ = lockstep_cases.run(call, "kernel")
            segs = -(-(int(t1) - call.t0) // max(1, min(8, call.max_steps)))
            if call.src is not None:
                r["entry_plain_ms"] = cuda_time_ms(
                    lambda: lockstep_cases.walk_entry_plain(call.src,
                                                            call.w), 3)
            r.update(segments=segs, fit=call.fit, t0=call.t0,
                     src=call.src is not None,
                     segment_ms=segment_ms(lp, reps) if segs else None)
            if old is not None:
                r["turns"] = turns_ms(
                    lambda: lockstep_cases.run(call, "kernel"), turn_builds,
                    reps)
                if segs:
                    r["segment_turns"] = {b: [] for b in turn_builds}
                    for b in list(turn_builds) + list(turn_builds)[::-1]:
                        with turn_builds[b]():
                            r["segment_turns"][b].append(segment_ms(
                                lockstep_entry_args(call), reps))
        if call.kind == "scan" and old is not None:
            r["turns"] = turns_ms(
                lambda: lockstep_cases.run(call, "kernel"), turn_builds, reps)
        if call.kind == "fwd":
            r.update(B=call.B, mode=call.kw.get("mode", "lep"),
                     advance=call.advance,
                     live=int(call.state["alive"].sum()))
            if old is not None:
                with zeroing_parent(old):
                    e = lockstep_cases.vs_plain(call)
                if e:
                    raise SystemExit(f"the parent's forward stage disagrees "
                                     f"with the plain version: {e}")
                r["turns"] = turns_ms(
                    lambda: lockstep_cases.run(call, "kernel"),
                    {"old": lambda: zeroing_parent(old),
                     "new": lambda: launching(lockstep_cuda, None)}, reps)
        out.append(r)
        log(f"[lockstep] {engine} {call.kind} {call.lanes} lanes: "
            f"{r['ms']:.4f} ms in a loop, {r['graph_ms']:.5f} ms alone "
            f"(plain {r['plain_ms']:.3f}); entry {r.get('entry_ms')}, "
            f"segments {r.get('segments')}, segment {r.get('segment_ms')}; "
            f"in turns {json.dumps(r.get('turns'))}; segment in turns "
            f"{json.dumps(r.get('segment_turns'))}; "
            f"{w['rows']} occ rows, {w['bytes']} B, {w['extensions']} "
            f"extensions, steps max {w['max_steps']} mean "
            f"{w['mean_steps']:.1f}; bound {bound_ms:.6f} ms by {bound_by}, "
            f"floor {r['floor_ms']:.5f} ms (by the card's load latency "
            f"{r['floor_load_ms']:.5f}); entry in turns "
            f"{json.dumps(r.get('entry_turns'))}")
    for kind in ("scan", "walk", "fwd"):
        log(f"[lockstep] {kind}: the calls summed "
            f"{json.dumps(call_sums([r for r in out if r['kind'] == kind]))}")
    walks = [r for r in out if r["kind"] == "walk"]
    if walks and walks[0].get("entry_turns"):
        log("[lockstep] walk_stage_entry_kernel summed over the stages in "
            "turns " + json.dumps({b: sum(statistics.mean(
                r["entry_turns"][b]) for r in walks)
                for b in walks[0]["entry_turns"]}))
    segs = [r for r in out if r.get("segment_turns")]
    if segs:
        log("[lockstep] walk segments summed in turns " + json.dumps({
            b: sum(statistics.mean(r["segment_turns"][b]) for r in segs)
            for b in segs[0]["segment_turns"]}))
    return out


def lockstep_rows(rec, row) -> list:
    """The lockstep kernels' rows of the kernel table: launches in all_off's
    first chunk (phase 6, its first run; the forward stage's in
    fwd_staged's, ``fwd_launches``); max_abs_err over every captured call
    of all_off's, bwd_win's and fwd_staged's first chunk, int32 and int64;
    the scan at its first call (round 1, 16,384 lanes), the segment kernel
    at the widest stage that walks (its first segment alone, segment_ms;
    the plain version's stage over its segments), the entry at the widest
    stage with a source, the forward stage at its first call (round 1's
    first stage, 16,384 lanes, B = 8), each with its bound and floor,
    every call's figures beside them (the forward stages' summed too)."""
    t = rec["time"]
    scans = [r for r in t if r["kind"] == "scan"]
    walks = [r for r in t if r["kind"] == "walk"]
    fwds = [r for r in t if r["kind"] == "fwd"]
    seg = max((r for r in walks if r["segments"]), key=lambda r: r["lanes"])
    entry = max((r for r in walks if r["src"]), key=lambda r: r["lanes"])

    def err(k):
        return max(v for key, v in rec["check"]["max_abs_err"].items()
                   if key.startswith(k + " "))

    def calls(rs, keys):
        return [{k: r.get(k) for k in keys} for r in rs]
    keys = ("engine", "lanes", "ms", "graph_ms", "plain_ms", "bound_ms",
            "floor_ms", "floor_load_ms", "turns")
    wkeys = keys + ("entry_ms", "segments", "segment_ms", "segment_turns",
                    "fit", "t0", "src", "entry_turns")
    count = max((r for r in walks if not r["src"]), key=lambda r: r["lanes"])
    first = scans[0]
    n = rec["launches"]
    occ = rec["occupancy"]
    return [
        row("scan_lanes_kernel", LOCKSTEP_REPLACES["scan_lanes_kernel"],
            n["scan_lanes_kernel"], err("scan_lanes_kernel"), first["ms"],
            first["plain_ms"], first, source=LOCKSTEP_SOURCE,
            at=f"{first['lanes']} lanes (round 1)",
            graph_ms=first["graph_ms"], latency_floor_ms=first["floor_ms"],
            latency_floor_load_ms=first["floor_load_ms"],
            occupancy=occ["scan_lanes_kernel"],
            calls=calls(scans, keys)),
        row("walk_stage_kernel", LOCKSTEP_REPLACES["walk_stage_kernel"],
            n["walk_stage_kernel"], err("walk_stage_kernel"),
            seg["segment_ms"], seg["plain_ms"] / seg["segments"], seg,
            source=LOCKSTEP_SOURCE,
            at=f"{seg['lanes']} lanes, {seg['segments']} segments "
               f"({seg['engine']}); ms and plain_ms a segment, bound and "
               f"floor the stage's loop",
            stage_ms=seg["graph_ms"], latency_floor_ms=seg["floor_ms"],
            latency_floor_load_ms=seg["floor_load_ms"],
            occupancy=occ["walk_stage_kernel"],
            calls=calls(walks, wkeys)),
        row("walk_stage_entry_kernel",
            LOCKSTEP_REPLACES["walk_stage_entry_kernel"],
            n["walk_stage_entry_kernel"], err("walk_stage_entry_kernel"),
            entry["entry_ms"], entry["entry_plain_ms"],
            lockstep_entry_bound(entry),
            source=LOCKSTEP_SOURCE,
            at=f"{entry['lanes']} lanes from a wider stage "
               f"({entry['engine']})",
            entry_turns=entry.get("entry_turns"),
            count_only=dict(lanes=count["lanes"], ms=count["entry_ms"],
                            entry_turns=count.get("entry_turns")),
            occupancy=occ.get("walk_stage_entry_kernel")),
        row("fwd_stage_kernel", LOCKSTEP_REPLACES["fwd_stage_kernel"],
            rec["fwd_launches"], err("fwd_stage_kernel"), fwds[0]["ms"],
            fwds[0]["plain_ms"], fwds[0], source=LOCKSTEP_SOURCE,
            at=f"{fwds[0]['lanes']} lanes, B = {fwds[0]['B']} (round 1's "
               f"first stage); the chunk's {len(fwds)} stages in calls",
            graph_ms=fwds[0]["graph_ms"],
            latency_floor_ms=fwds[0]["floor_ms"],
            latency_floor_load_ms=fwds[0]["floor_load_ms"],
            chunk=dict(call_sums(fwds),
                       plain_ms=sum(r["plain_ms"] for r in fwds)),
            occupancy=occ["fwd_stage_kernel"],
            calls=calls(fwds, keys + ("B", "mode", "live")))]


def fwd_stream(opt, fm, dfi, dev, engine, tail, chunks, main_sams) -> dict:
    """Cell A's stream (``chunks``, phase 4's) through align_stream on a
    seeder built under COMPSEED_FWD_MEMO=0 (fwd_staged, its chunks by the
    call graph), the DP engine and tail of phase 4: SAM byte-equal to
    phase 4's stream; fwd_stage_kernel and bsw_meta_dual_kernel launched,
    fm_extend_sel_kernel not (counts set to 0 just before).  The bench
    chunks overflow fwd_staged's rep caps, as the JAX package's heads
    show: each such chunk is rerun exactly and the caps respond as the
    seeder's adaptive response says (a raise, then the forward dedup
    switched off), which the record gives per chunk."""
    import torch
    from compseed_tpu_torch.ops.engine import device_seeder
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    with engine_env({"COMPSEED_FWD_MEMO": "0"}):
        sd = device_seeder(opt, fm, dedup=True, dfi=dfi, device=dev)
    seen = watch_overflow(sd)
    engines, call = [], sd._call

    def watched_call(fns, qd, rd):
        engines.append((fns["engine"], sd._graphed(fns)))
        return call(fns, qd, rd)

    sd._call = watched_call
    done = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    align_stream(opt, fm, iter(chunks), engine, sd, tail,
                 on_done=done.extend, stats=SeedingStats())
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = launch_counts()
    rec = dict(reads=len(done), wall_s=wall,
               chunks=[dict(engine=e[0], call_graph=e[1], overflow=s[0],
                            gp_f=s[1], rerun_s=s[2], device_s=s[3],
                            fwd_disabled=s[4])
                       for e, s in zip(engines, seen)],
               launches={k: n[k] for k in ("fwd_stage_kernel",
                                           "bsw_meta_dual_kernel",
                                           "fm_extend_sel_kernel")},
               sam_equals_stream=[r.sam for r in done] == main_sams)
    log(f"[4] cell A's stream under COMPSEED_FWD_MEMO=0: "
        f"{json.dumps(rec)}")
    if not rec["sam_equals_stream"]:
        raise SystemExit("COMPSEED_FWD_MEMO=0: SAM differs from phase 4's "
                         "stream")
    if n["fwd_stage_kernel"] <= 0 or n["bsw_meta_dual_kernel"] <= 0 or \
            n["fm_extend_sel_kernel"] or engines[0] != ("fwd_staged", True):
        raise SystemExit(f"COMPSEED_FWD_MEMO=0: the forward stage or the "
                         f"fused DP kernel was not launched, or the "
                         f"extension kernel was, or the first chunk did "
                         f"not run fwd_staged by its call graph: "
                         f"{rec['launches']}, {engines}")
    return rec


def lockstep_entry_bound(r) -> dict:
    """The entry's bound at a compacting stage (lockstep_cases.work's
    entry_bytes: the source's alive bytes, its kept lanes' words read
    once, the stage's words written once)."""
    ms, by = bound_of(r["work"]["entry_bytes"], 0)
    return dict(bound_ms=ms, bound_by=by)


@contextlib.contextmanager
def sa_loop_watch(counts: dict, keys: list, keep: int = 8):
    """sa_batch's loops counted for the block: ``counts["plain"]`` the
    host-tested loop's calls (fm._sa_loop_plain), ``counts["loop"]`` the
    loop graph's (fm._sa_loop_kernels); the first ``keep`` positions the
    loop graph took go to ``keys`` as (index, positions)."""
    from compseed_tpu_torch.ops import fm as dfm
    plain, loop = dfm._sa_loop_plain, dfm._sa_loop_kernels

    def counted_plain(*a):
        counts["plain"] += 1
        return plain(*a)

    def counted_loop(fm, kk, steps, alive):
        counts["loop"] += 1
        if len(keys) < keep:
            keys.append((fm, kk.clone()))
        return loop(fm, kk, steps, alive)

    dfm._sa_loop_plain, dfm._sa_loop_kernels = counted_plain, counted_loop
    try:
        yield counts
    finally:
        dfm._sa_loop_plain, dfm._sa_loop_kernels = plain, loop


def sa_batch_turns(keys, reps: int = 3) -> dict:
    """sa_batch on the card by its loop graph (kept per lane count,
    fm._SaKept: a shape's first call captures it, every later call copies
    its lanes in and launches it) and by the plain loop (a host test
    every round, fm._sa_loop_plain over the walk kernel) in turns (loop,
    plain, plain, loop), host wall ms a call with a sync after it, on each
    of ``keys`` (the rerun's merged-SAL positions); the capture and
    instantiation ms of each loop graph captured (the first call of a
    shape)."""
    import torch
    from compseed_tpu_torch.ops import cuda_lib
    from compseed_tpu_torch.ops import fm as dfm
    out, graphs = [], []
    end = cuda_lib.LoopGraph.end

    def timed_end(g):
        end(g)
        graphs.append((g.capture_s * 1e3, g.instantiate_s * 1e3))

    cuda_lib.LoopGraph.end = timed_end
    try:
        for fm, k in keys:
            turns = {"loop": [], "plain": []}
            for route in ("loop", "plain", "plain", "loop"):
                orig = dfm._sa_loop
                if route == "plain":
                    dfm._sa_loop = lambda dev: dfm._sa_loop_plain
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        dfm.sa_batch(fm, k)
                    torch.cuda.synchronize()
                    turns[route].append((time.perf_counter() - t0) * 1e3 /
                                        reps)
                finally:
                    dfm._sa_loop = orig
            out.append(dict(lanes=int(k.shape[0]), wall_ms=turns))
    finally:
        cuda_lib.LoopGraph.end = end
    rec = dict(calls=out, captures=len(graphs),
               capture_ms=[c for c, _ in graphs],
               instantiate_ms=[i for _, i in graphs])
    log(f"[3] sa_batch by its kept loop graph against the host-tested loop, "
        f"in turns: {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# chain_scan's round: csrc/chain_scan.cu

def chain_capture(dev, opt, fm, queries, force=None) -> tuple:
    """The first bench chunk's seeding on the default engine with every
    chain_scan and walk_pool_chain round through the plain round; the
    state before the first round of each width of each call
    (chain_cases.RoundCapture: (call, w) -> case; walk_cases.RoundCapture:
    (call, lanes) -> case) and every boundary between two segments
    (entry_cases.BoundaryCapture's cases)."""
    import torch
    from compseed_tpu_torch.ops import chain_cases, entry_cases, walk_cases
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.engine import device_seeder
    sd = device_seeder(opt, fm, dedup=True, device=dev,
                       dfi=to_device(fm, dev, force_dtype=force))
    with entry_cases.BoundaryCapture() as bounds, \
            chain_cases.RoundCapture(limit=16) as cap, \
            walk_cases.RoundCapture(limit=16) as walk_cap:
        sd.run_flat(queries)
    torch.cuda.synchronize()
    return cap.states, walk_cap.states, bounds.cases


def chain_phase2(dev, opt, fm, queries) -> tuple:
    """Phase 2 for the chain and the walk kernels, from one seeding run of
    the first bench chunk per index type: every captured chain_scan round,
    int32 and int64 positions, and each in its lossy form (1,024 table
    slots: collisions; 200 free store rows: a full store), through each
    kernel and its plain step; then the walk_pool_chain rounds
    (walk_check).  Returns ({dtype: {case: {kernel: max_abs_err}}}, the
    int32 cases, kept for phase 4) for the chain and then for the walk,
    and {dtype: the boundaries between segments} (entry_check)."""
    import numpy as np
    from compseed_tpu_torch.ops import chain_cases
    out, keep, walk_out, walk_keep, bounds = {}, None, {}, None, {}
    for tag, force in (("int32", None), ("int64", np.int64)):
        t0 = time.time()
        states, walk_states, bounds[tag] = chain_capture(dev, opt, fm,
                                                         queries, force)
        widths = sorted({w for _, w in states})
        if not {CHUNK, 4 * CHUNK} <= set(widths):
            raise SystemExit(f"chain_scan rounds captured at widths {widths}: "
                             f"expected {CHUNK} and {4 * CHUNK}")
        rec = {}
        for (call, w), case in sorted(states.items()):
            for form, c in (("", case), (" lossy", chain_cases.lossy(case))):
                errs = chain_cases.steps_vs_plain(c)
                stats = errs.pop("stats")
                rec[f"call {call} w={w}{form}"] = dict(errs, stats=stats)
                if any(errs.values()):
                    raise SystemExit(f"a chain kernel disagrees with its "
                                     f"plain step ({tag}, call {call}, w={w}"
                                     f"{form}): {errs} {stats}")
        if not any(r["stats"]["stored"] < r["stats"]["n_w"]
                   for r in rec.values()):
            raise SystemExit("no lossy round filled the chain store")
        out[tag] = rec
        log(f"[2] chain kernels vs plain steps over the first bench "
            f"chunk's rounds ({tag} positions, {len(rec)} rounds, "
            f"{time.time() - t0:.1f} s): max_abs_err "
            f"{ {k: max(r[k] for r in rec.values()) for k in CHAIN_KERNELS} }"
            f"; rounds {json.dumps({n: r['stats'] for n, r in rec.items()})}")
        walk_out[tag] = walk_check(tag, walk_states)
        if tag == "int32":
            keep, walk_keep = states, walk_states
    return out, keep, walk_out, walk_keep, bounds


def loop_check(dev, opt, fm, queries, force=None) -> dict:
    """The round loops as graphs against the plain loop: every chain_scan
    and walk_pool_chain call of one seeding run of the first bench chunk
    (chain_cases.CallCapture: each segment one graph launch, chain_scan
    with report_rounds on), run again from its arguments through the
    plain loop (call_vs_plain): the largest difference of every output
    over the calls, all 0: pool, cursor, ovf, fq, fc, the memo, rnd and
    alive_hist; death, fk, fl, fs, ovf, calls and ngrp.  On every round
    of those plain runs the round's sort (CUB's, over the key's bits)
    against torch.sort(stable=True) (sort_vs_torch)."""
    import torch
    from compseed_tpu_torch.ops import chain_cases, walk_cases
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.engine import device_seeder
    sd = device_seeder(opt, fm, dedup=True, device=dev,
                       dfi=to_device(fm, dev, force_dtype=force))
    with chain_cases.CallCapture("chain_scan") as cc, \
            chain_cases.CallCapture("walk_pool_chain") as wc:
        sd.run_flat(queries)
    torch.cuda.synchronize()
    rec = {}
    for entry, cap, check in (
            ("chain_scan", cc, chain_cases.sort_vs_torch()),
            ("walk_pool_chain", wc, walk_cases.sort_vs_torch())):
        by_output = {}
        for call in cap.calls:
            for k, v in chain_cases.call_vs_plain(entry, call,
                                                  check).items():
                by_output[k] = max(by_output.get(k, 0), v)
        rec[entry] = dict(calls=len(cap.calls), max_abs_err=by_output,
                          sort_rounds=len(check.errs),
                          sort_max_abs_err=max(check.errs))
        if not cap.calls or any(by_output.values()) or any(check.errs):
            raise SystemExit(f"{entry} by the graph loop differs from the "
                             f"plain loop, or a sort from torch.sort: "
                             f"{rec[entry]}")
    rec["chain_scan"]["rounds"] = [int(c[2][6]) for c in cc.calls]
    del cc, wc
    return rec


def loop_kernels(module, case) -> dict:
    """A round source's loop (``module``: chain_cuda or walk_cuda) on a
    round of the main path (``case``: a captured chain or walk round,
    whose Args it takes).  Its segment entry kernel with no source (a
    call's first segment: the round's live lanes counted), launched alone
    outside a graph (the condition handle 0), against its plain version,
    seedscan.loop_step_plain, on the same words: a running round, the
    RCAP cap, a segment exit and no live lane, with the histogram (the
    chain's) and without; go, rnd, the live count and the histogram held
    equal.  Then the apply kernel's folded tail (loop_tail_check).  The
    entry's compaction between segments: entry_check, entry_time."""
    import torch
    from compseed_tpu_torch.ops import chain_cases, walk_cases
    from compseed_tpu_torch.ops import seedscan as ss
    what = module.__name__.rsplit(".", 1)[-1].split("_")[0]
    if what == "chain":
        fm, const, st, w, Uw = case
        rd = module.ChainRound(fm, const, chain_cases.clone_state(st), w, Uw)
    else:
        fm, const, st, Uw = case
        rd = module.WalkRound(fm, const, walk_cases.clone_state(st), Uw)
    dev, i32 = rd.dev, torch.int32
    rcap, nxtw = 40, 100
    kernel, = module.LOOP_KERNELS
    e = 0
    for rnd0, live, hist_on in ((3, 500, True), (40, 500, True),
                                (39, 500, True), (3, nxtw, True),
                                (0, 0, True), (3, 500, False)):
        got = []
        for run in (rd.entry, lambda: ss.loop_step_plain(rd, True)):
            rnd = torch.tensor(rnd0, dtype=i32, device=dev)
            hist = torch.full((rcap,), -1, dtype=i32, device=dev) \
                if hist_on else None
            rd.set_loop(rnd, None, nxtw, rcap, hist)
            rd._held["alive"].zero_()[:live] = True
            rd.live.fill_(-5)
            run()
            got.append([rnd.clone(), rd.live.clone(), rd.go.clone()] +
                       ([hist] if hist_on else []))
        e = max([e] + [err(a, b) for a, b in zip(*got)])
    if e:
        raise SystemExit(f"{kernel} (no source) disagrees with its plain "
                         f"version: {e}")
    tail = loop_tail_check(module, case)
    torch.cuda.synchronize()
    return {f"{kernel} no source": dict(max_abs_err=e),
            f"{what}_apply_kernel tail": tail}


def entry_check(boundaries: dict, builds: dict) -> dict:
    """The segment entry kernels on every boundary of the first chunk's
    seeding (``boundaries``: dtype tag -> entry_cases.BoundaryCapture's
    cases, chain and walk), in every form (as captured; no live lane;
    exactly w live; w + 37 live at the RCAP cap, the lanes past w
    dropped), by the port's build and every other build of the source
    with a segment entry (``builds``: loop -> round_builds' builds, a
    variant's segment_entry): against the plain version (seedscan.
    segment_entry_plain), every lane of the new width and the loop words
    (live count, go, round counter, histogram), max_abs_err 0.
    {kernel: {max_abs_err, boundaries, by case}}."""
    from compseed_tpu_torch.ops import entry_cases
    out = {}
    for tag, cases in boundaries.items():
        for i, case in enumerate(cases):
            kernel = f"{case[0]}_segment_entry_kernel"
            rec = out.setdefault(kernel, dict(max_abs_err=0, boundaries=0,
                                              cases={}))
            rec["boundaries"] += 1
            paths = {"port": None} | {
                n: b.segment_entry for n, b in builds[case[0]].items()
                if getattr(b, "segment_entry", None)}
            for form in entry_cases.FORMS:
                for path, launch in paths.items():
                    r = entry_cases.entry_vs_plain(case, form, launch)
                    rec["max_abs_err"] = max(rec["max_abs_err"],
                                             r["max_abs_err"])
                    rec["cases"][f"{tag} {i} {case[3]['alive'].shape[0]}->"
                                 f"{case[4]} {form} {path}"] = r
    if set(out) != set(LOOP_KERNELS) or any(r["max_abs_err"]
                                            for r in out.values()):
        raise SystemExit(f"a segment entry kernel disagrees with its plain "
                         f"version, or a loop had no boundary: "
                         f"{ {k: r['max_abs_err'] for k, r in out.items()} }")
    return out


def torch_compaction(src: dict, out: dict, keys, w: int, pads: dict):
    """The compaction between segments as the port ran it before the
    segment entry kernels (PyTorch operations on the card, kept lanes of
    w + 1 elements, the last the dump row): the targets once (cumsum,
    where, clamp), then each lane array zeroed (a pad's copied in) and
    written by index_put_."""
    import torch
    lalive = src["alive"]
    tgt = torch.where(lalive, torch.cumsum(lalive, 0) - 1, w).clamp(max=w)
    for kk in keys:
        buf = out[kk].copy_(pads[kk].expand(w + 1)) if kk in pads else \
            out[kk].zero_()
        buf[tgt] = src[kk]


def entry_time(boundaries: list, builds: dict, parents=None) -> dict:
    """Each boundary of the first chunk (int32; entry_cases.BoundaryCapture's
    cases) on the card alone (launch_ms: 20 launches in a CUDA graph,
    replayed): the segment entry kernel of the port's build and of every
    other build of the source that has one (a variant's); the PyTorch
    compaction it replaced
    (torch_compaction) and, with an earlier build of the round source
    that has the one-thread loop entry kernel (--chain-old-source,
    --walk-old-source: the parent's), that kernel alone and both in one
    graph, the sequence the port ran; with ``parents`` (loop -> an
    old_build of the parent's round source, --entry-old-csrc) the
    parent's segment entry kernel ("parent"); ENTRY_TURNS turns each
    order.  The plain version in a loop (events), and the bound:
    entry_work's bytes over the HBM rate against its operations.
    ``builds``: loop -> round_builds' builds.  Per boundary: medians."""
    from compseed_tpu_torch.ops import chain_cuda, walk_cuda
    modules = dict(chain=chain_cuda, walk=walk_cuda)
    import torch
    from compseed_tpu_torch.ops import entry_cases
    from compseed_tpu_torch.ops import seedscan as ss
    out = {}
    for i, case in enumerate(boundaries):
        what, w = case[0], case[4]
        src, rnd0 = entry_cases.source(case, "captured")
        rd = entry_cases.entry_round(case)
        entry_cases.set_entry(rd, case, src, rnd0)
        runs = {"kernel": rd.entry}
        parent = (parents or {}).get(what)
        if parent is not None:
            rp = entry_cases.entry_round(case)
            entry_cases.set_entry(rp, case, src, rnd0)

            def parent_entry(rp=rp, parent=parent):
                with launching(modules[what], parent):
                    rp.entry()
            runs["parent"] = parent_entry
        for name, b in builds[what].items():
            if getattr(b, "segment_entry", None):
                r = entry_cases.entry_round(case)
                entry_cases.set_entry(r, case, src, rnd0)
                runs[name] = lambda r=r, b=b: b.segment_entry(r)
        keys = rd.LANE_KEYS
        kept = {n: torch.empty(w + 1, dtype=src[n].dtype,
                               device=src[n].device) for n in keys}
        runs["torch compaction"] = lambda: torch_compaction(
            src, kept, keys, w, rd.pads)
        old = next((b for b in builds[what].values()
                    if getattr(b, "loop_entry", None)), None)
        if old is not None:
            runs["old entry"] = lambda: old.loop_entry(rd)
            runs["torch compaction + old entry"] = lambda: (
                runs["torch compaction"](), old.loop_entry(rd))
        ms = {n: [] for n in runs}
        for turn in range(2 * ENTRY_TURNS):
            for n in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
                ms[n].append(launch_ms(runs[n], 20))
        nbytes, ops = entry_cases.entry_work(case, src)
        bound_ms, bound_by = bound_of(nbytes, ops)
        plain = entry_cases.entry_round(case)
        entry_cases.set_entry(plain, case, src, rnd0)
        out[f"{what} {i} {src['alive'].shape[0]}->{w}"] = dict(
            kernel=f"{what}_segment_entry_kernel", src_w=int(
                src["alive"].shape[0]), w=w, live=int(src["live"]),
            median_ms={n: statistics.median(v) for n, v in ms.items()},
            ms=ms, plain_ms=cuda_time_ms(
                lambda: ss.segment_entry_plain(plain), 20),
            bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.synchronize()
    log(f"[2] the segment entry kernels on the card alone, in turns: "
        f"{json.dumps({k: r['median_ms'] for k, r in out.items()})}")
    return out


def round_before_apply(module, case, dead: bool = False) -> tuple:
    """A captured round (``module``: chain_cuda or walk_cuda; ``case`` a
    chain or walk round) through the port's kernels up to its apply (the
    first kernel, the sort, the group, the representatives' walk into
    the round's held buffers), on a copy of its state, all lanes dead
    with ``dead``: (its round, that state)."""
    from compseed_tpu_torch.ops import chain_cases, walk_cases
    from compseed_tpu_torch.ops import seedscan as ss
    if module.__name__.endswith("chain_cuda"):
        fm, const, st, w, Uw = case
        ks = chain_cases.clone_state(st)
        if dead:
            ks["alive"].zero_()
        rd = module.ChainRound(fm, const, ks, w, Uw)
        module.probe(rd)
        module.sort(rd)
        module.group(rd)
        s = rd.scratch
        ss._chain_walk(fm, s["rep_wv"], const["W"], s["rep_k"], s["rep_l"],
                       s["rep_s"], s["rep_valid"], out=rd.walk)
    else:
        fm, const, st, Uw = case
        ks = walk_cases.clone_state(st)
        if dead:
            ks["alive"].zero_()
        rd = module.WalkRound(fm, const, ks, Uw)
        module.key(rd)
        module.sort(rd)
        module.group(rd)
        s = rd.scratch
        ss._chain_walk(fm, s["rep_rw"], const["W"], s["rep_k"], s["rep_l"],
                       s["rep_s"], s["rep_valid"], is_back=True,
                       stop_s=s["gmin"], out=rd.walk)
    return rd, ks


def loop_tail_check(module, case, rcap: int = 40) -> dict:
    """The apply kernel's folded loop test (``module``: chain_cuda or
    walk_cuda) on a round of the main path: the round up to its apply
    (round_before_apply), then the apply launched alone (the condition
    handle 0) with set_loop's loop word, against the same apply without
    the word followed by its plain version, seedscan.loop_step_plain:
    round counter, live count, go, the histogram (with it and without),
    the retire count (0 after) and every tensor of the round's state held
    equal.  At a running round, the RCAP cap, a segment exit (the next
    width equal to the live count the apply leaves) and no live lane;
    go must be set at the running rounds alone.  {max_abs_err, live: the
    live count the round leaves, cases: {case: go}}."""
    import torch
    from compseed_tpu_torch.ops import chain_cases
    from compseed_tpu_torch.ops import seedscan as ss
    i32 = torch.int32
    rd, _ = round_before_apply(module, case)
    module.apply(rd)
    live = int(rd.live)
    if live < 1:
        raise SystemExit(f"loop_tail_check: the round leaves {live} live "
                         f"lanes")
    e, cases = 0, {}
    for tag, dead, rnd0, nxtw, hist_on in (
            ("running", False, 3, live - 1, True),
            ("cap", False, rcap - 1, live - 1, True),
            ("exit", False, 3, live, True),
            ("no live lane", True, 3, 0, True),
            ("running, no histogram", False, 3, live - 1, False)):
        got = []
        for folded in (True, False):
            rd, ks = round_before_apply(module, case, dead)
            rnd = torch.tensor(rnd0, dtype=i32, device=rd.dev)
            hist = torch.full((rcap,), -1, dtype=i32, device=rd.dev) \
                if hist_on else None
            rd.set_loop(rnd, torch.tensor(live, dtype=i32, device=rd.dev),
                        nxtw, rcap, hist)
            rd.go.fill_(-5)
            if not folded:
                rd.args[rd.AT["loop"]] = 0
            module.apply(rd)
            if not folded:
                ss.loop_step_plain(rd, False)
            got.append([rnd, rd.live, rd.go, rd.scratch["sc"][
                module.SC_RETIRE:module.SC_RETIRE + 2]] +
                       ([hist] if hist_on else []) +
                       [ks[n] for n in sorted(ks)
                        if isinstance(ks[n], torch.Tensor)])
        e = max([e] + [chain_cases.max_err(a, b) for a, b in zip(*got)])
        go, retire = int(got[0][2]), int(got[0][3].abs().sum())
        cases[tag] = go
        if go != int(tag.startswith("running")) or retire:
            raise SystemExit(f"the {module.__name__} apply's loop test at "
                             f"{tag}: go {go}, retire count {retire}")
    if e:
        raise SystemExit(f"the {module.__name__} apply's folded loop test "
                         f"disagrees with its plain version: {e}")
    return dict(max_abs_err=e, live=live, cases=cases)


class LoopTail:
    """A round source's kernels (``module``: chain_cuda or walk_cuda) as a
    loop's body launches its apply: with the loop word set, so that its
    last block to retire counts the round and runs the loop's test (the
    words its own: a round counter and a live count set at its first
    apply on a round, no histogram, no graph), for timing the folded tail
    against the apply alone (loop_tail_turns)."""

    def __init__(self, module):
        self.module = module
        for op in ("probe", "key", "group"):
            if hasattr(module, op):
                setattr(self, op, getattr(module, op))

    def apply(self, rd):
        import torch
        if not rd.args[rd.AT["loop"]]:
            z = torch.zeros((), dtype=torch.int32, device=rd.dev)
            rd.set_loop(z, None, 0, 1 << 30)
        self.module.apply(rd)


def loop_tail_turns(what: str, cases: dict) -> dict:
    """The apply kernel of a round source (``what``: "chain" or "walk")
    on each of ``cases`` (tag -> a captured round) without its loop word
    and with it (LoopTail), on the card alone in turns, TAIL_TURNS times
    each order (build_turns, each held to the plain steps first); per
    case the medians and their difference, what the folded loop test
    adds to a round's apply."""
    from compseed_tpu_torch.ops import (chain_cases, chain_cuda, walk_cases,
                                        walk_cuda)
    module, check, runs = dict(
        chain=(chain_cuda, chain_cases.steps_vs_plain, chain_runs),
        walk=(walk_cuda, walk_cases.steps_vs_plain, walk_runs))[what]
    kernel = f"{what}_apply_kernel"
    rec = build_turns(what, {"apply": module, "apply+loop":
                             LoopTail(module)}, cases, (kernel,), check,
                      runs, turns=TAIL_TURNS)
    for r in rec.values():
        a, b = (statistics.median(r[n][kernel]) for n in ("apply",
                                                            "apply+loop"))
        r["median_ms"] = dict(apply=a, loop=b, added=b - a)
    log(f"[4] {what} apply with and without the loop word, in turns: "
        f"{json.dumps({t: r['median_ms'] for t, r in rec.items()})}")
    return rec


def kept_bytes(run) -> dict:
    """What ``run()`` (a shape's first call, which captures its call
    graph) leaves held on the card: torch.cuda.memory_allocated and
    memory_reserved before and after, the allocator's cache emptied both
    times, so that ``reserved_bytes`` is the graph's private pool with its
    inputs, ``allocated_bytes`` its inputs and outputs, and
    ``peak_bytes`` the most allocated above the start while it ran."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(allocated_bytes=torch.cuda.memory_allocated() - a0,
                reserved_bytes=torch.cuda.memory_reserved() - r0,
                peak_bytes=torch.cuda.max_memory_allocated() - a0)


def call_graph_check(dev, opt, fm, reads_arr) -> dict:
    """The call graph (DeviceSeeder._call: the default engine's whole call
    as one CUDA graph a thread and call shape) against the eager _run on
    every chunk of cell A (the stream's N_CHUNKS chunks), with int32 and
    with int64 positions: head and seed matrix equal.  Per index type:
    the first chunk's capture and instantiation ms (CallGraph), the
    kernels captured, what the kept shape holds on the card (kept_bytes
    around that capture) and what dropping it frees; the same bytes for
    the sharded path's shape (ShardedSeeder at S = MESH_SHARDS[-1] on
    [dev] * S, whose shards replay one graph)."""
    import threading

    import numpy as np
    import torch
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.engine import device_seeder
    from compseed_tpu_torch.parallel.sharded import ShardedSeeder
    chunks = []
    for c in range(N_CHUNKS):
        s0 = (c * CHUNK) % len(reads_arr)
        chunks.append(list(np.concatenate(
            [reads_arr[s0:], reads_arr[:s0]])[:CHUNK]))
    out = {}
    for tag, force in (("int32", None), ("int64", np.int64)):
        t0 = time.time()
        sd = device_seeder(opt, fm, dedup=True, device=dev,
                           dfi=to_device(fm, dev, force_dtype=force))
        rec = dict(chunks=[])
        for c, q in enumerate(chunks):
            R, L, qd, rd = sd._upload(q)
            fns = sd._build(R, L)
            if not sd._graphed(fns):
                raise SystemExit(f"{tag}: the default engine did not take "
                                 f"the call graph")
            if c == 0:
                rec["kept"] = kept_bytes(lambda: sd._call(fns, qd, rd))
                (cg,) = sd._calls.by_thread[threading.get_ident()].values()
                rec.update(capture_ms=cg.capture_s * 1e3,
                           instantiate_ms=cg.instantiate_s * 1e3,
                           kernels_captured=len(cg.launched))
            graph = [x.cpu() for x in sd._call(fns, qd, rd)]
            eager = [x.cpu() for x in sd._run(fns, qd, rd)[2:]]
            equal = all(torch.equal(a, b) for a, b in zip(graph, eager))
            rec["chunks"].append(dict(equal=equal, overflow=bool(
                graph[0][3:14].any())))
            if not equal:
                raise SystemExit(f"{tag} chunk {c}: the call graph's head or "
                                 f"seed matrix differs from the eager _run")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        sd._calls.drop_thread()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rec["dropped_frees_bytes"] = r0 - torch.cuda.memory_reserved()
        rec["s"] = time.time() - t0
        out[tag] = rec
        del sd
    out["engines"] = engine_graph_check(dev, opt, fm, chunks)
    S = MESH_SHARDS[-1]
    sh = ShardedSeeder(opt, fm, mesh=[dev] * S, dedup=True)
    sh.run_flat(chunks[0][:256])                 # the index on the card
    out[f"sharded S={S}"] = kept_bytes(lambda: sh.run_flat(chunks[0]))
    del sh
    torch.cuda.empty_cache()
    log(f"[2] the call graph against the eager _run on every chunk, int32 "
        f"and int64; bytes a kept shape holds: {json.dumps(out)}")
    return out


def engine_graph_check(dev, opt, fm, chunks) -> dict:
    """Each engine of seeder2.ENGINES but the default (call_graph_check
    holds that one) by its call graph against its eager _run: every chunk
    of cell A with int32 positions and the first with int64, head and
    seed matrix equal; the first chunk's capture and
    instantiation ms and kernels captured.  fwd_staged's int64 run takes
    the first chunk's first FWD_INT64_READS reads: on the whole chunk its
    overflowed rep caps leave garbage seeds whose suffix-array walks
    never end at int64 (the JAX package's sa_batch_compact loops on the
    same positions), so neither route can finish it."""
    import threading

    import numpy as np
    import torch
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    out = {}
    for name, (dedup, knobs) in ENGINES.items():
        if name == "default":
            continue
        first = chunks[:1] if name != "fwd_staged" else \
            [chunks[0][:FWD_INT64_READS]]
        for tag, force, chs in (("int32", None, chunks),
                                ("int64", np.int64, first)):
            with engine_env(knobs):
                sd = DeviceSeeder(opt, fm, dev, dedup=dedup,
                                  dfi=to_device(fm, dev, force_dtype=force))
                fns = [sd._build(*sd._upload(q)[:2]) for q in chs]
            rec = dict(equal=[])
            for c, q in enumerate(chs):
                R, L, qd, rd = sd._upload(q)
                if not sd._graphed(fns[c]) or fns[c]["engine"] != name:
                    raise SystemExit(f"{name}: the engine did not take the "
                                     f"call graph")
                graph = [x.cpu() for x in sd._call(fns[c], qd, rd)]
                if c == 0:
                    (cg,) = sd._calls.by_thread[
                        threading.get_ident()].values()
                    rec.update(capture_ms=cg.capture_s * 1e3,
                               instantiate_ms=cg.instantiate_s * 1e3,
                               kernels_captured=len(cg.launched))
                eager = [x.cpu() for x in sd._run(fns[c], qd, rd)[2:]]
                rec["equal"].append(all(torch.equal(a, b)
                                        for a, b in zip(graph, eager)))
                if not rec["equal"][-1]:
                    raise SystemExit(f"{name} {tag} chunk {c}: the call "
                                     f"graph's head or seed matrix differs "
                                     f"from the eager _run")
            sd._calls.drop_thread()
            del sd
            torch.cuda.empty_cache()
            out[f"{name} {tag}"] = rec
    log(f"[2] the graphed engines' call graphs against their eager _run: "
        f"{json.dumps(out)}")
    return out


def sa_capture(dev, opt, fm, queries) -> dict:
    """Every boundary of sa_batch_compact's suffix-array walk in one
    eager seeding run of the first chunk and in one call over 40 random
    positions (a last stage of one lane), as the plain version runs them
    (sa_cases.BoundaryCapture), int32 and int64: dtype tag -> cases."""
    import numpy as np
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import sa_cases
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.engine import device_seeder
    out = {}
    for tag, force in (("int32", None), ("int64", np.int64)):
        dfi = to_device(fm, dev, force_dtype=force)
        sd = device_seeder(opt, fm, dedup=True, device=dev, dfi=dfi)
        gen = torch.Generator().manual_seed(40)
        small = torch.randint(0, dfi.seq_len, (40,), generator=gen)
        with sa_cases.BoundaryCapture() as cap:
            sd.run_flat(queries)
            dfm.sa_batch_compact(dfi, small.to(dfi.dtype).to(dev))
        torch.cuda.synchronize()
        if [c[2] for c in cap.cases] != [0, 1, 2, 3] * 2:
            raise SystemExit(f"sa_capture ({tag}): boundaries of stages "
                             f"{[c[2] for c in cap.cases]}, expected two "
                             f"calls' four")
        out[tag] = cap.cases
    return out


def sa_check(cases: dict) -> dict:
    """sa_stage_entry_kernel on every boundary (``cases``: sa_capture's)
    in every form (sa_cases.forms: as captured, no live lane, cap // 2,
    cap and cap + 37 live lanes) against its plain version
    (sa_cases.stage_vs_plain: the outputs, ovf, the next stage's alive
    bytes, slots and live lanes, go before the last stage); then each
    call whole (the positions the first boundary holds) by the kernels
    against the plain version: SA values and ovf; then sa_rounds, the
    loop over three rounds and more.  max_abs_err 0, or the run fails."""
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import sa_cases
    from compseed_tpu_torch.ops.chain_cases import max_err
    rec = dict(max_abs_err=0, boundaries=0, cases={}, calls={})
    for tag, cs in cases.items():
        for i, case in enumerate(cs):
            rec["boundaries"] += 1
            for form in sa_cases.forms(case):
                r = sa_cases.stage_vs_plain(case, form)
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         r["max_abs_err"])
                rec["cases"][f"{tag} {i} N={case[1]} s={case[2]} "
                             f"{form}"] = r
            if case[2] == 0:
                k = case[3]["out_k"][:case[1]].clone()
                got = dfm.sa_batch_compact(case[0], k)
                want = dfm._sa_batch_compact_plain(case[0], k)
                e = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
                rec["calls"][f"{tag} N={case[1]}"] = dict(
                    max_abs_err=e, ovf=bool(want[1]))
                rec["max_abs_err"] = max(rec["max_abs_err"], e)
        r = sa_rounds(cs[0][0])
        rec["calls"].update({f"{tag} {k}": v for k, v in r.items()})
        rec["max_abs_err"] = max([rec["max_abs_err"]] +
                                 [v["max_abs_err"] for v in r.values()])
    torch.cuda.synchronize()
    if rec["max_abs_err"]:
        bad = {k: r for k, r in rec["cases"].items() if r["max_abs_err"]}
        raise SystemExit(f"sa_stage_entry_kernel or the suffix-array walk "
                         f"on the kernels disagrees with its plain version: "
                         f"{bad} {rec['calls']}")
    return rec


def sa_rounds(fm) -> dict:
    """The suffix-array loop over three rounds and more on the card, each
    against its plain version: the last stage's loop alone (sa_cases.
    last_loop / run_last_loop: one graph, its WHILE node continued by the
    walk's folded test) from the index's 64 longest walks (sa_cases.
    long_rows), its lanes against fm._sa_loop_plain's; and whole calls on
    4,096 positions, those rows first, then sampled rows (ovf clear) or
    random ones (ovf set), eagerly and inside a CUDA graph capture (the
    loop joining it), SA values and ovf against the plain version.
    {name: {max_abs_err, rounds: the plain loop's}}; fewer than three
    rounds fails the run."""
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import sa_cases
    from compseed_tpu_torch.ops.chain_cases import max_err
    rows, steps = sa_cases.long_rows(fm, 64)
    i, dev = fm.sa_intv, rows.device
    out = {}
    want = dfm._sa_loop_plain(fm, rows, torch.zeros_like(rows),
                              (rows & (i - 1)) != 0)
    lp = sa_cases.last_loop(fm, rows)
    sa_cases.run_last_loop(lp)
    lp.close()
    out["last loop alone"] = dict(
        max_abs_err=max(max_err(g, w) for g, w in zip(lp.lanes[3], want)),
        rounds=-(-int(want[1].max()) // (2 * i)))
    gen = torch.Generator().manual_seed(41)
    rand = torch.randint(0, fm.seq_len, (4096,), generator=gen).to(
        fm.dtype).to(dev)
    rounds = -(-(int(steps[0]) - 7 * i) // (2 * i))
    for name, k in (("sampled", rand - (rand & (i - 1))), ("random", rand)):
        k = k.clone()
        k[:64] = rows
        want = dfm._sa_batch_compact_plain(fm, k)
        got = dfm.sa_batch_compact(fm, k)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            cap = dfm.sa_batch_compact(fm, k)
        graph.replay()
        torch.cuda.synchronize()
        out[f"4096 lanes, long walks + {name}"] = dict(
            max_abs_err=max(max_err(x[j], want[j])
                            for x in (got, cap) for j in (0, 1)),
            rounds=rounds, ovf=bool(want[1]))
        del graph
    if min(r["rounds"] for r in out.values()) < 3:
        raise SystemExit(f"sa_rounds: the plain loop took fewer than 3 "
                         f"rounds: {out}")
    return out


def torch_sa_boundary(case, src: dict):
    """The PyTorch sequence sa_stage_entry_kernel replaced at a boundary
    (the port's before it, on the card): fm._sa_boundary_plain (the done
    lanes' index_put_s, the stable argsort, ovf, the gathers) on the
    state ``src``, and before the last stage the loop's first test
    (alive.any() into an int32, what the one-block loop entry kernel
    computed).  A function of no argument, each call from ``src``."""
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import sa_cases
    N, s, cap = case[1], case[2], sa_cases.next_width(case)
    go = torch.empty((), dtype=torch.int32, device=src["alive"].device)

    def run():
        st = dict(src)
        dfm._sa_boundary_plain(st, N, cap)
        if s == 2:
            go.copy_(st["alive"].any())
    return run


def sa_time(cases: list, parent=None) -> dict:
    """Each boundary of the first chunk's call (int32; ``cases``:
    sa_capture's first four) on the card alone (launch_ms: 20 launches in
    a CUDA graph, replayed), sa_stage_entry_kernel in turns with the
    PyTorch sequence it replaced (torch_sa_boundary) and, with ``parent``
    (an old_build of the parent's fm_walk.cu, --entry-old-csrc), the
    parent's kernel, SA_TURNS turns each
    order; that sequence in a loop (events: the plain version's time); the
    bound: stage_work's bytes over the HBM rate against its operations.
    Per boundary: medians."""
    import torch
    from compseed_tpu_torch.ops import fm_cuda, sa_cases
    out = {}
    for case in cases:
        _, N, s, _ = case
        src = sa_cases.source(case, "captured")
        lp = sa_cases.stage_loop(case, src)
        runs = {"kernel": lambda lp=lp, s=s: fm_cuda.SaLoop.boundary(lp, s),
                "torch sequence": torch_sa_boundary(case, src)}
        if parent is not None:
            lpp = sa_cases.stage_loop(case, src)

            def parent_boundary(lpp=lpp, s=s):
                with launching(fm_cuda, parent):
                    fm_cuda.SaLoop.boundary(lpp, s)
            runs["parent"] = parent_boundary
        ms = {n: [] for n in runs}
        for turn in range(2 * SA_TURNS):
            for n in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
                ms[n].append(launch_ms(runs[n], 20))
        nbytes, ops = sa_cases.stage_work(case, src)
        bound_ms, bound_by = bound_of(nbytes, ops)
        w = sa_cases.next_width(case)
        out[f"s={s} {src['alive'].shape[0]}->{w or 0}"] = dict(
            stage=s, src_n=int(src["alive"].shape[0]), w=w or 0,
            live=int(src["alive"].sum()),
            median_ms={n: statistics.median(v) for n, v in ms.items()},
            ms=ms, plain_ms=cuda_time_ms(runs["torch sequence"], 20),
            bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.synchronize()
    log(f"[2] sa_stage_entry_kernel on the card alone, in turns with the "
        f"PyTorch sequence it replaced: "
        f"{json.dumps({k: r['median_ms'] for k, r in out.items()})}")
    return out


def sa_tail(case) -> dict:
    """The walk's folded loop test on the last stage's lanes of the first
    chunk (``case``: sa_capture's boundary before the last stage; its
    plain version gives the lanes as the loop starts): the walk of 2
    sa_intv steps with its tail (fm_cuda.inv_psi_walk, SaLoop.tail), out
    of place from each state the plain loop passes before a round, from
    all dead, from only the last alive, and from the index's longest
    walks (sa_cases.long_rows, alive after the round: the test must
    continue the loop there): go against alive.any() of what it wrote,
    and go = 1 at least once.  Then the walk with the tail and without,
    on the card alone in turns (out of place from the loop's first state,
    so every launch walks the same), the plain version's time
    (alive.any() into go, events), torch.any's (the library call, on the
    card alone) and the bound of the test's work (the alive bytes read,
    go written)."""
    import torch
    from compseed_tpu_torch.ops import fm as dfm
    from compseed_tpu_torch.ops import fm_cuda, sa_cases
    from compseed_tpu_torch.ops.chain_cases import max_err
    fm_ = case[0]
    st = sa_cases.plain(case, sa_cases.source(case, "captured"))
    lanes = [st["kk"].contiguous(), st["steps"].contiguous(),
             st["alive"].contiguous()]
    n = lanes[0].shape[0]
    states = []
    kk, steps, alive = (x.clone() for x in lanes)
    while True:
        states.append((kk.clone(), steps.clone(), alive.clone()))
        if not bool(alive.any()):
            break
        kk, steps, alive = dfm._walk(fm_, kk, steps, alive,
                                     2 * fm_.sa_intv)
    rounds = len(states) - 1
    last = torch.zeros_like(lanes[2])
    last[-1] = True
    rows, _ = sa_cases.long_rows(fm_, n)
    states += [(lanes[0], lanes[1], torch.zeros_like(last)),
               (lanes[0], lanes[1], last),
               (rows, torch.zeros_like(rows),
                (rows & (fm_.sa_intv - 1)) != 0)]
    k0 = case[3]["out_k"][:case[1]].clone()
    lp = fm_cuda.SaLoop(fm_, k0, torch.zeros_like(k0), torch.zeros(
        case[1], dtype=torch.bool, device=k0.device))
    out3 = lp.lanes[3][:3]

    def walk(src, tail: bool):
        return lambda: fm_cuda.inv_psi_walk(
            fm_, *src, lp.n_steps[3], out=out3,
            tail=lp.tail() if tail else None)

    err, gos = 0, []
    for src in states:
        lp.go.fill_(-1)
        walk(src, True)()
        gos.append(int(lp.go))
        err = max(err, max_err(lp.go, out3[2].any().to(torch.int32)))
    if err or 1 not in gos:
        raise SystemExit(f"the walk's folded loop test disagrees with "
                         f"alive.any() (max_abs_err {err}) or never "
                         f"continued the loop: go {gos}")
    runs = {"walk with the loop word": walk(states[0], True),
            "walk alone": walk(states[0], False)}
    ms = {k: [] for k in runs}
    for turn in range(2 * SA_TURNS):
        for k in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            ms[k].append(launch_ms(runs[k], 20))
    med = {k: statistics.median(v) for k, v in ms.items()}
    alive0 = states[0][2]
    go = torch.empty((), dtype=torch.int32, device=alive0.device)
    any_out = torch.empty((), dtype=torch.bool, device=alive0.device)
    bound_ms, bound_by = bound_of(n + 4, n)
    out = dict(lanes=n, rounds=rounds, states=len(states), go=gos,
               max_abs_err=err, median_ms=med, ms=ms,
               tail_ms=med["walk with the loop word"] - med["walk alone"],
               plain_ms=cuda_time_ms(lambda: go.copy_(alive0.any()), 50),
               library_ms=launch_ms(lambda: torch.any(alive0, out=any_out),
                                    20),
               bound_ms=bound_ms, bound_by=bound_by, bytes=n + 4, ops=n)
    torch.cuda.synchronize()
    log(f"[2] the walk's folded loop test on the first chunk's last-stage "
        f"lanes: {json.dumps(out)}")
    return out


def sa_rows(sa_rec, l32, row, prof) -> list:
    """The suffix-array stage entry kernel's row of the kernel table:
    launches (eager, or captured once a graph launch) in the main path's
    int32 window; ms, plain_ms and the bound at the first chunk's widest
    boundary (sa_time), every boundary's medians beside them
    (``boundaries``: the kernel and the PyTorch sequence it replaced);
    max_abs_err over sa_check's boundaries, forms and calls;
    device_ms_profiled: the profiler's mean over one chunk's runs."""
    k, = SA_KERNELS
    r = max(sa_rec["time"].values(), key=lambda x: x["src_n"])
    return [row(k, SA_REPLACES[k], l32[k], sa_rec["check"]["max_abs_err"],
                r["median_ms"]["kernel"], r["plain_ms"], r, source=FM_SOURCE,
                at=f"{r['src_n']} -> {r['w']} lanes",
                boundaries={t: x["median_ms"]
                            for t, x in sa_rec["time"].items()},
                device_ms_profiled=prof.get(k, {}).get(
                    "device_ms_per_launch"))]


def segment_costs(seeder, queries, runs: int = 3) -> dict:
    """What a segment's graph costs the host on the eager route (the
    engines that run a call eagerly; seeder2.EagerCalls): the first
    chunk's seeding with every graph captured anew (seedscan.drop_held
    first), then
    ``runs`` runs on the kept graphs, without the profiler.  For
    chain_scan's segments and walk_pool_chain's widths: the capture (the
    outer graph and the body, from begin to end) and the instantiation
    (ending the captures and cudaGraphInstantiate) in ms, and the whole
    segment call (seedscan._chain_segment / _walk_segment: the round's
    arguments and scratch, a capture, its instantiation, the launch) in
    the first run and on kept graphs (the launch alone); the segments a
    chunk; each run's run_flat seconds and device_s."""
    import torch
    from compseed_tpu_torch.ops import cuda_lib
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops.seeder2 import EagerCalls
    seen = {"chain": [], "walk": []}
    kind = []
    end = cuda_lib.LoopGraph.end

    def timed_end(self):
        end(self)
        if kind:            # a segment's (not the suffix-array loop's)
            seen[kind[-1]][-1].update(
                capture_ms=self.capture_s * 1e3,
                instantiate_ms=self.instantiate_s * 1e3)

    def timed(what, fn):
        def run(*a, **kw):
            kind.append(what)
            seen[what].append({})
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            seen[what][-1]["segment_ms"] = (time.perf_counter() - t0) * 1e3
            kind.pop()
            return out
        return run

    orig = (ss._chain_segment, ss._walk_segment)
    cuda_lib.LoopGraph.end = timed_end
    ss._chain_segment = timed("chain", orig[0])
    ss._walk_segment = timed("walk", orig[1])
    walls, dev_s, first = [], [], {}
    ss.drop_held()
    eager = EagerCalls().__enter__()
    try:
        for run in range(runs + 1):
            for v in seen.values():
                v.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seeder.run_flat(queries)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            dev_s.append(seeder.prof["device_s"])
            if run == 0:
                first = {w: list(v) for w, v in seen.items()}
    finally:
        cuda_lib.LoopGraph.end = end
        ss._chain_segment, ss._walk_segment = orig
        eager.__exit__()
    out = dict(run_flat_s=walls, device_s=dev_s,
               note="the eager route; run 0 captures every graph; runs 1- "
                    "run kept ones")
    for what in seen:
        segs, kept = first[what], seen[what]
        out[what] = {k: dict(median=statistics.median(x[k] for x in segs),
                             total=sum(x[k] for x in segs))
                     for k in ("capture_ms", "instantiate_ms", "segment_ms")}
        out[what]["kept_segment_ms"] = dict(
            median=statistics.median(x["segment_ms"] for x in kept),
            total=sum(x["segment_ms"] for x in kept))
        out[what]["segments_per_chunk"] = len(segs)
        if any("capture_ms" in x for x in kept):
            raise SystemExit(f"a run on kept {what} graphs captured anew")
    return out


def segment_rounds(seeder, queries, runs: int = 3) -> dict:
    """What a kept segment graph costs the card a round, on the eager
    route (seeder2.EagerCalls, whose segments keep their graphs): one run
    of the chunk's seeding that captures every segment's graph, then
    ``runs`` runs on the kept graphs, each segment's call
    (seedscan._chain_segment / _walk_segment: on a kept graph its launch
    alone) between two CUDA events on the current stream, its rounds the
    call's round counter after it less before it (copies on the card, read
    after the run).  Per loop: each run's event ms over its segments, its
    rounds and their quotient, the ms per round; the kernel nodes of the
    segments' body graphs (what the card runs a round)."""
    import torch
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops.seeder2 import EagerCalls
    seen = {"chain": [], "walk": []}

    def timed(what, fn):
        def run(*a, **kw):
            # the loop's words: the one dict of the arguments with "rnd"
            rnd = next(x for x in a if isinstance(x, dict) and "rnd" in x)[
                "rnd"]
            r0 = rnd.clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            rd = fn(*a, **kw)
            ev[1].record()
            seen[what].append((ev, r0, rnd.clone(), rd))
            return rd
        return run

    orig = (ss._chain_segment, ss._walk_segment)
    out = {w: dict(ms=[], rounds=[], ms_per_round=[]) for w in seen}
    ss.drop_held()
    eager = EagerCalls().__enter__()
    ss._chain_segment = timed("chain", orig[0])
    ss._walk_segment = timed("walk", orig[1])
    try:
        for run in range(runs + 1):
            for v in seen.values():
                v.clear()
            seeder.run_flat(queries)
            torch.cuda.synchronize()
            if run == 0:
                continue
            for what, segs in seen.items():
                ms = sum(ev[0].elapsed_time(ev[1]) for ev, *_ in segs)
                rounds = sum(int(r1) - int(r0) for _, r0, r1, _ in segs)
                out[what]["ms"].append(ms)
                out[what]["rounds"].append(rounds)
                out[what]["ms_per_round"].append(ms / rounds)
        for what, segs in seen.items():
            nodes = [rd.graph.nodes() for *_, rd in segs]
            out[what].update(
                segments=len(segs),
                kernels_per_round=sorted({n["kernels"] for n in nodes}),
                memsets_per_round=sorted({n["memsets"] for n in nodes}),
                median_ms_per_round=statistics.median(
                    out[what]["ms_per_round"]))
    finally:
        ss._chain_segment, ss._walk_segment = orig
        eager.__exit__()
        ss.drop_held()
    return out


def chain_runs(case, build) -> tuple:
    """A captured round through one build of the chain kernels (``build``:
    chain_cuda, or an OldChainBuild), once whole (so every scratch array
    holds this round's data), and name -> (call, restore or None) of each
    kernel, the sort and the walk beside them, for timing.  A kernel that
    reads what it writes (group: the store cursor; apply: the lane state)
    has it restored, as the round left it, before every call.  Returns
    (runs, the round's arguments, its state)."""
    import torch
    from compseed_tpu_torch.ops import chain_cases, chain_cuda
    from compseed_tpu_torch.ops import seedscan as ss
    fm, const, st, w, Uw = case
    ks = chain_cases.clone_state(st)
    rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
    s = rd.scratch

    def walk():
        return ss._chain_walk(fm, s["rep_wv"], const["W"], s["rep_k"],
                              s["rep_l"], s["rep_s"], s["rep_valid"])

    build.probe(rd)
    chain_cuda.sort(rd)
    build.group(rd)
    rd.set_walk(*walk())
    build.apply(rd)
    torch.cuda.synchronize()
    restore_group = restorer(ks, ("cur",), s["sc"][4:5])
    restore_apply = restorer(ks, ("pivot", "pos", "alive", "k", "l", "s"),
                             s["sc"][4:5])
    runs = {"chain_probe_kernel": (lambda: build.probe(rd), None),
            "sort": (lambda: chain_cuda.sort(rd), None),
            "chain_group_kernel": (lambda: build.group(rd), restore_group),
            "walk": (walk, None),
            "chain_apply_kernel": (lambda: build.apply(rd), restore_apply)}
    return runs, rd, ks


def chain_time(case, reps: int = 20) -> dict:
    """One captured round's kernels timed at its shape (round_time, on
    chain_runs): each kernel, the sort and the walk beside them; the
    bounds on this round's data (chain_cases.round_work)."""
    import torch
    from compseed_tpu_torch.ops import chain_cases, chain_cuda
    from compseed_tpu_torch.ops import seedscan as ss
    fm, const, st, w, Uw = case
    errs = chain_cases.steps_vs_plain(case)
    stats = errs.pop("stats")
    ps = chain_cases.clone_state(st)
    pr = ss._chain_probe_plain(fm, const, ps)
    order = torch.argsort(pr["key"], stable=True)
    gr = ss._chain_group_plain(ps, pr, order, Uw)
    walk = ss._chain_walk(fm, gr["rep_wv"], const["W"], gr["rep_k"],
                          gr["rep_l"], gr["rep_s"], gr["rep_valid"])
    plain = {
        "chain_probe_kernel": lambda: ss._chain_probe_plain(fm, const, ps),
        "chain_group_kernel": lambda: ss._chain_group_plain(ps, pr, order,
                                                            Uw),
        "chain_apply_kernel": lambda: ss._chain_apply_plain(
            fm, const, ps, pr, gr, walk, w, Uw)}
    runs, rd, ks = chain_runs(case, chain_cuda)
    es = torch.empty(0, dtype=fm.dtype).element_size()
    out = dict(stats=stats, max_abs_err=errs)
    out.update(round_time(runs, plain, chain_cases.round_work(
        stats, es, const["W"]), reps))
    out["sort"].update(sort_time(rd, reps))
    del ks, rd, ps
    return out


def sort_time(rd, reps: int) -> dict:
    """The round's sort (CUB's radix sort over its key's bits, what the
    round's graph runs) beside torch.sort(key, stable=True), the library
    call it replaced: that call's ms per call in a loop and on the card
    alone, the two held equal, and the sort's bound: the keys read once,
    the sorted keys and the order written once (16 B a lane), against
    four integer operations a lane a pass of 8 bits."""
    import torch
    key = rd.scratch["key"]
    w = key.shape[0]

    def lib():
        return torch.sort(key, stable=True)

    want = lib()
    e = max(err(rd.scratch["sorted_key"], want[0]),
            err(rd.scratch["order"], want[1]))
    if e:
        raise SystemExit(f"the round's sort differs from torch.sort on "
                         f"{w} lanes")
    nbytes, ops = 16 * w, 4 * w * -(-rd.key_bits // 8)
    bound_ms, bound_by = bound_of(nbytes, ops)
    return dict(max_abs_err=e, key_bits=rd.key_bits, library=
                "torch.sort(stable=True)", library_loop_ms=cuda_time_ms(
                    lib, reps), library_ms=launch_ms(lib, reps),
                bytes=nbytes, ops=ops, bound_ms=bound_ms, bound_by=bound_by)


class OldChainBuild:
    """The kernels of another csrc/chain_scan.cu (--chain-old-source: the
    parent's, or a variant), launched on a ChainRound's Args words: its
    struct Args must be the port's or a prefix of it (chain_cuda._bind
    checks its size; the parent's lacks the last word, the lanes' read
    ids, and its launchers read only their own words).  Its look-back
    status words are the round's own, a word a block of
    chain_cuda.APPLY_BLOCK lanes: enough for blocks of that many lanes or
    more."""

    def __init__(self, lib):
        from compseed_tpu_torch.ops import chain_cuda
        chain_cuda._bind(lib, prefix=True)
        self.lib = lib
        # whether its apply runs the loop's test (its Args has the loop
        # word): a build without it cannot end a loop's body
        self.folds = lib.chain_args_words() > chain_cuda.ARGS.index("loop")
        # the one-thread loop entry kernel of a build from before the
        # segment entry kernels (the parent's), for entry_time
        self.loop_entry = None
        if hasattr(lib, "chain_loop_entry_launch"):
            import ctypes as ct
            fn = lib.chain_loop_entry_launch
            fn.argtypes, fn.restype = [ct.c_void_p, ct.c_void_p], ct.c_int
            self.loop_entry = lambda rd: self._run("chain_loop_entry_launch",
                                                   rd)
        # a variant's segment entry kernel (its Args the port's), for
        # entry_check and entry_time
        self.segment_entry = None
        if hasattr(lib, "chain_segment_entry_launch"):
            import ctypes as ct
            fn = lib.chain_segment_entry_launch
            fn.argtypes, fn.restype = [ct.c_void_p, ct.c_void_p], ct.c_int
            self.segment_entry = lambda rd: self._run(
                "chain_segment_entry_launch", rd)

    def _run(self, launcher, rd):
        import ctypes as ct

        import torch
        with torch.cuda.device(rd.dev):
            rc = getattr(self.lib, launcher)(
                ct.addressof(rd.args),
                torch.cuda.current_stream(rd.dev).cuda_stream)
        if rc:
            raise SystemExit(f"{launcher} (another chain build): CUDA error "
                             f"{rc}")

    def probe(self, rd):
        self._run("chain_probe_launch", rd)

    def group(self, rd):
        self._run("chain_group_launch", rd)

    def apply(self, rd):
        self._run("chain_apply_launch", rd)


def round_builds(sources, module, wrap) -> dict:
    """name -> a build of a round source's kernels, in the order of a turn:
    each of ``sources`` (other copies of ``module``'s source, such as the
    parent's: --chain-old-source, --walk-old-source), named by its
    directory and file name, built with the port's csrc/ on the include
    path (for lookback.cuh, unless a copy sits beside the file) and
    launched through ``wrap`` (OldChainBuild, OldWalkBuild), then "new",
    ``module`` itself (chain_cuda, walk_cuda): the port's own launchers
    and library."""
    import ctypes as ct
    from compseed_tpu_torch.ops import cuda_lib
    module.LIB.load()
    lib_name = os.path.splitext(os.path.basename(module.LIB.src))[0]
    builds = {}
    for src in sources:
        name = "_".join(os.path.normpath(os.path.splitext(src)[0])
                        .split(os.sep)[-2:])
        if name in builds or name == "new":
            name = f"{name}_{len(builds)}"
        so = os.path.join(cuda_lib.BUILD, f"lib{lib_name}_{name}.so")
        cuda_lib.compile_source(os.path.abspath(src), so, includes=(
            os.path.dirname(module.LIB.src),))
        builds[name] = wrap(ct.CDLL(so))
    builds["new"] = module
    return builds


def build_turns(what: str, builds: dict, cases: dict, kernels, check,
                runs_of, reps: int = 20, cold=(), flush=None,
                turns: int = 1) -> dict:
    """Every case (tag -> a captured round, or a form of one) through every
    build of a round source's kernels (``what``: "chain" or "walk"): held
    to the plain steps (``check(case, build)``: chain_cases or walk_cases
    ``steps_vs_plain``; max_abs_err per build and kernel, all must be 0),
    then each of ``kernels``' ms per launch on the card alone (launch_ms
    on ``runs_of(case, build)``, restores taken off) in turns, the builds
    in order and then in reverse, ``turns`` times; each of ``cold`` also
    after ``flush``
    (an eviction of L2) every launch, as "<kernel> cold".  tag -> {stats:
    the round's data, build: {max_abs_err, kernel: [ms, ...]}}."""
    order = (list(builds) + list(builds)[::-1]) * turns
    timed = [(k, None) for k in kernels] + [(k, flush) for k in cold]
    out = {}
    for tag, case in cases.items():
        rec = {}
        for b, build in builds.items():
            errs = check(case, build)
            rec["stats"] = errs.pop("stats")
            rec[b] = dict(max_abs_err=errs, **{
                k if f is None else f"{k} cold": [] for k, f in timed})
            if any(errs.values()):
                raise SystemExit(f"{what} build {b} disagrees with the plain "
                                 f"steps at {tag}: {errs} {rec['stats']}")
        for b in order:
            runs, rd, ks = runs_of(case, builds[b])
            for k, f in timed:
                run, restore = runs[k]
                rec[b][k if f is None else f"{k} cold"].append(
                    launch_ms(run, reps, f) if restore is None else
                    launch_ms(lambda: (restore(), run()), reps, f)
                    - launch_ms(restore, reps, f))
            del runs, rd, ks
        out[tag] = rec
        log(f"[4] {what} builds in turns at {tag} (ms per launch on the card "
            f"alone): {json.dumps(rec)}")
    return out


def restorer(st: dict, names, epoch):
    """A function that puts back ``st[name]`` for ``names`` as they are
    now and moves the round's epoch (a one-word tensor) on, so that a
    look-back finds no word of the call before."""
    saved = [(st[n], st[n].clone()) for n in names]

    def restore():
        for dst, src in saved:
            dst.copy_(src)
        epoch.add_(1)
    return restore


def round_time(runs: dict, plain: dict, work: dict, reps: int) -> dict:
    """The timing of a round's kernels (chain_time, walk_time).  ``runs``:
    name -> (call, restore or None), a kernel's launch or the sort or the
    walk beside them; ``plain``: kernel -> its plain step; ``work``:
    kernel -> (bytes, operations).  Each: ms per call in a loop
    (``loop_ms``: the host's launch rate) and per launch on the card
    alone (``ms``: launch_ms); a call that reads what it writes has its
    restore before every call, whose own time, measured alone, is taken
    off on the card alone and given beside in a loop
    (``restore_loop_ms``).  For a kernel also its own device time from
    torch.profiler over the same calls, its records alone
    (``profiled_ms``; ``profiled_records`` of ``reps`` seen), the plain
    step's ms per call in a loop and the bound of its work."""
    out = {}
    for name, (run, restore) in runs.items():
        timed = run if restore is None else \
            (lambda run=run, restore=restore: (restore(), run()))
        r = dict(loop_ms=cuda_time_ms(timed, reps),
                 graph_ms=launch_ms(timed, reps))
        if restore is not None:
            r["restore_loop_ms"] = cuda_time_ms(restore, reps)
            r["restore_graph_ms"] = launch_ms(restore, reps)
            r["graph_ms"] -= r["restore_graph_ms"]
        r["ms"] = r["graph_ms"]
        if name in plain:
            r.update(profiled_kernel_ms(timed, name, reps))
            r["plain_ms"] = cuda_time_ms(plain[name], max(reps // 4, 2))
            r["bytes"], r["ops"] = work[name]
            r["bound_ms"], r["bound_by"] = bound_of(*work[name])
        out[name] = r
    return out


def profiled_kernel_ms(run, kernel: str, reps: int) -> dict:
    """torch.profiler over ``reps`` calls of ``run`` (after one): the mean
    device time of the records of ``kernel`` alone, the other kernels and
    copies of ``run`` left out, and how many records it saw (the
    profiler has dropped records in a long process: fm_measure)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if kernel in e.name and
          str(getattr(e, "device_type", "")).endswith("CUDA")]
    return dict(profiled_ms=sum(us) / len(us) / 1e3 if us else None,
                profiled_records=len(us))


def chain_turns(seeder, queries) -> dict:
    """Round 1 of the first bench chunk, chain_scan with the kernels and
    with the plain round (seedscan._chain_round patched), in turns
    (kernels, plain, plain, kernels): wall ms per call and per round, the
    outputs compared."""
    import torch
    from compseed_tpu_torch.ops import seedscan as ss
    R, L, qd, rd = seeder._upload(queries)
    dfi, CW = seeder.dfi, seeder.chain_w
    M = (256 // CW) * R
    H = 1 << (4 * M - 1).bit_length()
    orig = ss._chain_round
    out, res = {"kernels": [], "plain": []}, {}
    for name in ("kernels", "plain", "plain", "kernels"):
        memo = ss.make_chain_memo(H, M, CW, dfi.dtype, dfi.device)
        if name == "plain":
            ss._chain_round = lambda dev: ss._chain_round_plain
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = ss.chain_scan(dfi, qd, rd, seeder.GP_F * R, memo, W=CW,
                              u_cap=max(R // 2, 64), report_rounds=True)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            ss._chain_round = orig
        rounds = int(r[6])
        out[name].append(dict(ms=dt * 1e3, ms_per_round=dt * 1e3 / rounds,
                              rounds=rounds))
        res[name] = r
    a, b = res["kernels"], res["plain"]
    e = max([err(x, y) for x, y in zip(a[:5], b[:5])] +
            [err(a[5][k], b[5][k]) for k in ss.MEMO_KEYS] + [err(a[7], b[7])])
    if e:
        raise SystemExit("chain_scan with the kernels differs from the plain "
                         "round on round 1 of the first chunk")
    out["max_abs_err"] = e
    return out


def launch_split(seeder, queries) -> dict:
    """torch.profiler over one run of the first chunk's seeding, on the
    graphs a run just before it captured (as every chunk of a shape
    after the first runs).  The CUDA runtime calls that cost host time
    (kernel and graph launches, syncs, copies, memsets, captures,
    instantiations) by stage, each given to the innermost stage among its
    callers in the profiler's tree: on the call graph's route (the
    default engine on a card) the call graph (``CallGraph.run``: the
    copies into its inputs and its one launch) and the rest (the
    uploads, the two fetches); on the eager route (under
    seeder2.EagerCalls) chain_scan's own set-up and tail, its segments
    (seedscan._chain_segment: a round's arguments and scratch, the
    capture of its loop graph, the graph's launch), walk_pool_chain's
    set-up and compactions, its widths (seedscan._walk_segment), the
    rest.  What the card ran over the chunk (kernels by name: the round
    and loop kernels, the FM kernels, CUB's, the rest; memsets; copies).
    Per round: the kernels and memsets of each segment's body graph
    (LoopGraph.nodes, what the card runs every round; the largest over
    the segments is gated), the rounds (the apply's runs; the
    suffix-array loop's: the walk's runs past three a call) and the
    loops' share of the kernels the card ran (each segment's entry
    kernel and its rounds' bodies).  Stages are marked with
    record_function for this run only (outside any capture); a run in
    which a round kernel did not run, or a graph was captured anew,
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from compseed_tpu_torch.ops import cuda_lib
    from compseed_tpu_torch.ops import seedscan as ss
    R, L, _, _ = seeder._upload(queries)
    graphed = seeder._graphed(seeder._build(R, L))
    names = dict(chain_scan="chain_scan", chain_segment="_chain_segment",
                 walk_pool_chain="walk_pool_chain",
                 walk_segment="_walk_segment")
    orig = {st: getattr(ss, fn) for st, fn in names.items()}
    n = dict.fromkeys(names, 0)
    bodies = {"chain": [], "walk": [], "fm": []}
    end = cuda_lib.LoopGraph.end
    run_graph = cuda_lib.CallGraph.run

    def counted_end(self):
        end(self)
        bodies[self._p].append(self.nodes())

    def marked(name, fn):
        def run(*a, **kw):
            n[name] = n.get(name, 0) + 1
            with record_function(f"stage.{name}"):
                return fn(*a, **kw)
        return run

    # the graphs captured anew (their bodies counted), then a run on them
    # as every later chunk of the shape runs, profiled
    ss.drop_held()
    seeder._calls.drop_thread()
    cuda_lib.LoopGraph.end = counted_end
    try:
        seeder.run_flat(queries)
    finally:
        cuda_lib.LoopGraph.end = end
    for st, fn in names.items():
        setattr(ss, fn, marked(st, orig[st]))
    cuda_lib.CallGraph.run = marked("call_graph", run_graph)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            seeder.run_flat(queries)
            torch.cuda.synchronize()
    finally:
        for st, fn in names.items():
            setattr(ss, fn, orig[st])
        cuda_lib.CallGraph.run = run_graph
    calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
             "cudaStreamSynchronize", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cudaStreamBeginCapture", "cudaGraphInstantiate")

    def stage_of(e):
        # the innermost stage among the event's callers in the profiler's
        # tree (not the stage whose time span it falls in, which takes in
        # calls of other threads and is wrong when a span's end is)
        while e is not None and not e.name.startswith("stage."):
            e = e.cpu_parent
        return "rest" if e is None else e.name[6:]

    split = {st: dict.fromkeys(calls, 0)
             for st in tuple(names) + ("call_graph", "rest")}
    ran = dict(memsets=0, copies=0, kernels={})
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kind = device_kind(e.name)
            if kind != "kernels":
                ran[kind] += 1
                continue
            m = re.search(r"\b((?:chain|walk|fm|sa)_[a-z_]+_kernel)", e.name)
            key = m.group(1) if m else ("cub" if "Radix" in e.name else
                                        "other")
            ran["kernels"][key] = ran["kernels"].get(key, 0) + 1
            continue
        name = next((c for c in calls if e.name.startswith(c)), None)
        if name:
            split[stage_of(e)][name] += 1
    for st in split.values():
        st["launches"] = st["cudaLaunchKernel"] + \
            st["cudaLaunchKernelExC"] + st["cudaGraphLaunch"]
    # no graph captured anew: on the eager route no segment's (its
    # suffix-array loop is captured at every call)
    anew = sum(v["cudaStreamBeginCapture"] + v["cudaGraphInstantiate"]
               for st, v in split.items()
               if graphed or st.endswith("_segment"))
    if graphed != bool(n.get("call_graph")) or anew:
        raise SystemExit(f"launch_split: the run took the "
                         f"{'eager' if n.get('call_graph') else 'graph'} "
                         f"route, or captured anew: {n} {split}")
    per, loops = {}, 0
    for what, round_kernels in (("chain", CHAIN_KERNELS),
                                ("walk", WALK_KERNELS)):
        # a round is one run of its apply, which ends it
        rounds = ran["kernels"].get(f"{what}_apply_kernel", 0)
        segs = bodies[what]
        # the profiler may drop a few records in a long process
        # (fm_measure): each round kernel must have run, and the counts are
        # reported as seen; on the eager route each segment is one call
        if not segs or (not graphed and len(segs) != n[f"{what}_segment"]) \
                or not all(ran["kernels"].get(k, 0) for k in round_kernels) \
                or not rounds:
            raise SystemExit(f"launch_split: the {what} loop's graphs ran "
                             f"no round kernel: {ran} {segs}")
        kmax = max(b["kernels"] for b in segs)
        loops += len(segs) + rounds * kmax if \
            min(b["kernels"] for b in segs) == kmax else 0
        per[f"{what}_round"] = dict(
            rounds=rounds, segments=len(segs), kernels=kmax,
            kernels_min=min(b["kernels"] for b in segs),
            memsets=max(b["memsets"] for b in segs),
            other_nodes=max(b["other"] for b in segs),
            host_launches_per_segment=split[f"{what}_segment"]["launches"]
            / len(segs))
    # the suffix-array walk: its stage entries, four a call (its rounds
    # are not counted here: the profiler's walk launches mix them with
    # every other inverse-Psi walk of the chunk)
    per["sa_round"] = dict(
        stage_entries=ran["kernels"].get("sa_stage_entry_kernel", 0),
        loops=len(bodies["fm"]),
        kernels=max((b["kernels"] for b in bodies["fm"]), default=0),
        memsets=max((b["memsets"] for b in bodies["fm"]), default=0))
    total = sum(ran["kernels"].values())
    return dict(route="call graph" if graphed else "eager", split=split,
                calls=n, per_round=per, ran=ran, ran_kernels=total,
                loop_kernels=loops,
                launches=sum(v["launches"] for v in split.values()),
                syncs=sum(v["cudaStreamSynchronize"] for v in split.values()),
                copies=sum(v["cudaMemcpyAsync"] for v in split.values()))


def chain_main_path(seeder, queries, l32, cases, builds) -> dict:
    """Phase 4's chain numbers: each kernel's launches per chunk in the
    int32 window; each kernel timed at the main path's shapes (round 1 at
    16,384 lanes and its narrower segments, round 2 at 65,536:
    chain_time) and at one block; every captured round shape and the
    block through every build in turns (build_turns: ``builds``, the
    port's and any --chain-old-source); round 1's chain_scan with the
    kernels and the plain round in turns (chain_turns); the launches by
    stage over one chunk (launch_split); with builds to compare, every
    round of a chunk through each (probe_rounds)."""
    from compseed_tpu_torch.ops import chain_cases
    per_chunk = {k: l32[k] / ((RUNS + 1) * N_CHUNKS) for k in CHAIN_KERNELS}
    log(f"[4] chain kernel launches per {CHUNK}-read chunk (int32 window): "
        f"{json.dumps(per_chunk)}")
    for k in CHAIN_KERNELS:
        if l32[k] <= 0:
            raise SystemExit(f"int32 main path: {k} was not launched: {l32}")
    shapes = {}
    for (call, w), case in sorted(cases.items()):
        tag = f"round {call} w={w}"
        if tag in ("round 1 w=16384", "round 1 w=4096", "round 1 w=1024",
                   "round 2 w=65536"):
            shapes[tag] = r = chain_time(case)
            log(f"[4] chain kernels at {tag} (Uw={case[4]}): "
                f"{json.dumps(r)}")
            if any(r["max_abs_err"].values()):
                raise SystemExit(f"a chain kernel disagrees with its plain "
                                 f"step at {tag}")
    if "round 1 w=16384" not in shapes or "round 2 w=65536" not in shapes:
        raise SystemExit(f"the chain rounds to time were not captured: "
                         f"{sorted(shapes)}")
    floor = chain_cases.narrow(cases[(1, CHUNK)], FLOOR_LANES)
    shapes[f"floor w={FLOOR_LANES}"] = r = chain_time(floor)
    log(f"[4] chain kernels' latency floor (round 1's first {FLOOR_LANES} "
        f"lanes): {json.dumps(r)}")
    flush = l2_flush(seeder.dfi.device)
    redesign = build_turns("chain", builds, dict(
        [(f"round {call} w={w}", c) for (call, w), c in sorted(cases.items())]
        + [(f"floor w={FLOOR_LANES}", floor),
           (f"padded w={CHUNK}", chain_cases.padded(cases[(1, CHUNK)]))]),
        CHAIN_KERNELS, chain_cases.steps_vs_plain, chain_runs,
        cold=("chain_probe_kernel",), flush=flush)
    # the apply with its folded loop test and without, at the timed widths
    tail = loop_tail_turns("chain", {
        f"round {call} w={w}": c for (call, w), c in sorted(cases.items())
        if (call, w) in ((1, CHUNK), (1, CHUNK // 4), (1, CHUNK // 16),
                         (2, 4 * CHUNK))})
    # every round of a chunk, for the builds to compare (--chain-old-source)
    rounds = probe_rounds(builds, seeder, queries, flush) \
        if len(builds) > 1 else {}
    del flush
    turns = chain_turns(seeder, queries)
    log(f"[4] round 1's chain_scan, kernels and plain round in turns: "
        f"{json.dumps(turns)}")
    from compseed_tpu_torch.ops.seeder2 import EagerCalls
    split = launch_split(seeder, queries)
    log(f"[4] host calls and the card's kernels by stage over one {CHUNK}-"
        f"read chunk, the call graph's route: {json.dumps(split)}")
    if split["launches"] > MAX_CHUNK_LAUNCHES or \
            split["syncs"] > MAX_CHUNK_SYNCS or \
            split["copies"] > MAX_CHUNK_COPIES:
        raise SystemExit(f"launch_split: a chunk's launches / syncs / copies "
                         f"exceed {MAX_CHUNK_LAUNCHES} / {MAX_CHUNK_SYNCS} / "
                         f"{MAX_CHUNK_COPIES}")
    with EagerCalls():
        eager = launch_split(seeder, queries)
    log(f"[4] the same on the eager route (the engines that run a call "
        f"eagerly): {json.dumps(eager)}")
    split["eager"] = eager
    per_round = split["per_round"]["chain_round"]["kernels"]
    if per_round > MAX_CHAIN_ROUND_KERNELS:
        raise SystemExit(f"the card runs {per_round:.2f} kernels a "
                         f"chain_scan round, more than "
                         f"{MAX_CHAIN_ROUND_KERNELS}")
    return dict(launches_per_chunk=per_chunk, shapes=shapes, turns=turns,
                split=split, redesign=redesign, loop_tail=tail, **rounds)


def probe_rounds(builds: dict, seeder, queries, flush) -> dict:
    """Every chain_scan round of one run of the first chunk's seeding
    (chain_cases.EveryRound: the three calls' rounds), held to the plain
    steps on every build, and the probe's ms per launch there three ways
    a build: on the card alone, warm and with L2 evicted before every
    launch (build_turns, in turns), and by the profiler inside the chunk
    (chain_chunk_means' records, its k-th launch the k-th round; a mean
    over the turns).  {"rounds": [{call, round, w, Uw, live, first (the
    segment's first round), build: {warm, cold, chunk}}, ...],
    "chunk_means": chain_chunk_means'}."""
    import torch
    from compseed_tpu_torch.ops import chain_cases
    with chain_cases.EveryRound() as cap:
        seeder.run_flat(queries)
    torch.cuda.synchronize()
    keys = sorted(cap.states)
    if len(keys) >= cap.limit:
        raise SystemExit(f"more than {cap.limit} chain_scan rounds in a "
                         f"chunk: raise EveryRound's limit")
    probe = ("chain_probe_kernel",)
    turns = build_turns("chain", builds, {
        f"call {c} round {r}": cap.states[(c, r)] for c, r in keys}, probe,
        chain_cases.steps_vs_plain, chain_runs, cold=probe, flush=flush)
    del cap
    means = chain_chunk_means(builds, seeder, queries)
    rows, seg = [], None
    for n, (call, r) in enumerate(keys):
        t = turns[f"call {call} round {r}"]
        w = t["stats"]["w"]
        first, seg = seg != (call, w), (call, w)
        row = dict(call=call, round=r, w=w, Uw=t["stats"]["Uw"],
                   live=t["stats"]["live"], first=first)
        for b in builds:
            chunk = [x["chain_probe_kernel"][n] for x in means[b]["records"]
                     if len(x["chain_probe_kernel"]) == len(keys)]
            row[b] = dict(warm=statistics.mean(t[b][probe[0]]),
                          cold=statistics.mean(t[b][f"{probe[0]} cold"]),
                          chunk=statistics.mean(chunk) if chunk else None)
        rows.append(row)
    log(f"[4] the chain probe at every round of one {CHUNK}-read chunk "
        f"({len(keys)} rounds; ms per launch, warm and cold on the card "
        f"alone, and inside the chunk): {json.dumps(rows)}")
    return dict(rounds=rows, chunk_means=means)


def chain_rows(chain_rec, l32, row, prof) -> list:
    """The chain kernels' rows of the kernel table (round_rows): ms,
    plain_ms, the profiler's device time and the bound of round 1 of the
    first chunk at 16,384 lanes; max_abs_err over every captured round,
    int32 and int64, and its lossy form (phase 2)."""
    return round_rows(chain_rec, "round 1 w=16384",
                      f"floor w={FLOOR_LANES}", CHAIN_KERNELS,
                      CHAIN_REPLACES, CHAIN_SOURCE, l32, row, prof)


def round_rows(rec, at_tag, floor_tag, kernels, replaces, source, l32,
               row, prof) -> list:
    """The rows of a round's kernels in the kernel table.  launches: the
    int32 window of the main path; ms (on the card alone), plain_ms, the
    profiler's device time and the bound: the shape ``at_tag`` of
    ``rec["shapes"]``; latency_floor_ms: the shape ``floor_tag``;
    device_ms_profiled: the profiler's mean over one chunk's launches
    (``prof``: profile_chunk's kernels); max_abs_err: the largest over
    every round of phase 2 (the apply's also over its folded loop test,
    ``rec["tail_check"]``, loop_tail_check); the apply's loop_tail_ms: its
    median ms per launch without the loop word and with it, in turns
    (loop_tail_turns), by shape."""
    at, floor = rec["shapes"][at_tag], rec["shapes"][floor_tag]
    rows = []
    for k in kernels:
        e = max(r[k] for recs in rec["phase2"].values()
                for r in recs.values())
        more = {}
        if k.endswith("_apply_kernel"):
            e = max(e, rec["tail_check"]["max_abs_err"])
            more["loop_tail_ms"] = {t: v["median_ms"]
                                    for t, v in rec["loop_tail"].items()}
        r = at[k]
        rows.append(row(
            k, replaces[k], l32[k], e, r["ms"], r["plain_ms"], r,
            source=source, loop_ms=r["loop_ms"],
            latency_floor_ms=floor[k]["ms"],
            per_chunk=rec["launches_per_chunk"][k],
            profiled_ms=r["profiled_ms"],
            device_ms_profiled=prof.get(k, {}).get("device_ms_per_launch"),
            shapes={t: {n: v[k][n] for n in ("ms", "profiled_ms", "loop_ms",
                                                "plain_ms", "bound_ms")}
                    for t, v in rec["shapes"].items()}, **more))
    return rows


# ---------------------------------------------------------------------------
# walk_pool_chain's round: csrc/walk_chain.cu

def walk_check(tag, states) -> dict:
    """Phase 2 for the walk kernels: every captured walk_pool_chain round
    of the first bench chunk (``states``: walk_cases.RoundCapture's), in
    its own form, with 64 representatives (groups wait) and in the forced
    forms (walk_cases.forced: colliding keys, a live lane keyed INT32_MAX
    and one after a dead lane of its (window, k, s)), through each kernel
    and its plain step.  Returns {case: {kernel: max_abs_err, stats}}."""
    from compseed_tpu_torch.ops import walk_cases
    t0 = time.time()
    lanes = sorted({n for _, n in states})
    if not {24 * CHUNK, 16 * CHUNK} <= set(lanes):
        raise SystemExit(f"walk_pool_chain rounds captured at {lanes} lanes: "
                         f"expected {24 * CHUNK} and {16 * CHUNK}")
    rec = {}
    for (call, n), case in sorted(states.items()):
        forms = [("", case), (" capped", walk_cases.capped(case))]
        if int(case[2]["alive"][:5].sum()) == 5:
            forms.append((" forced", walk_cases.forced(case)))
        for form, c in forms:
            errs = walk_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            rec[f"call {call} lanes={n}{form}"] = dict(errs, stats=stats)
            if any(errs.values()):
                raise SystemExit(f"a walk kernel disagrees with its plain "
                                 f"step ({tag}, call {call}, {n} lanes"
                                 f"{form}): {errs} {stats}")
    if not any(r["stats"]["n_u"] > r["stats"]["n_w"] for r in rec.values()):
        raise SystemExit("no walk round had more groups than representatives")
    if not any(name.endswith("forced") for name in rec):
        raise SystemExit("no walk round took the forced forms")
    log(f"[2] walk kernels vs plain steps over the first bench chunk's "
        f"rounds ({tag} positions, {len(rec)} rounds, "
        f"{time.time() - t0:.1f} s): max_abs_err "
        f"{ {k: max(r[k] for r in rec.values()) for k in WALK_KERNELS} }; "
        f"rounds {json.dumps({n: r['stats'] for n, r in rec.items()})}")
    return rec


def walk_time(case, reps: int = 20) -> dict:
    """One captured round's kernels timed at its shape (round_time), each
    from the round's own state: before every call the lane state and the
    counters are restored to what they were before the round; the sort
    and the walk beside them; the bounds on this round's data
    (walk_cases.round_work)."""
    import torch
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops import walk_cases, walk_cuda
    fm, const, st, Uw = case
    W = const["W"]
    errs = walk_cases.steps_vs_plain(case)
    stats = errs.pop("stats")
    ps = walk_cases.clone_state(st)
    kr = ss._walk_key_plain(const, ps)
    order = torch.argsort(kr["key"], stable=True)
    gr = ss._walk_group_plain(ps, kr, order, Uw)
    walk = ss._chain_walk(fm, gr["rep_rw"], W, gr["rep_k"], gr["rep_l"],
                          gr["rep_s"], gr["rep_valid"], is_back=True,
                          stop_s=gr["gmin"])
    plain = {
        "walk_key_kernel": lambda: ss._walk_key_plain(const, ps),
        "walk_group_kernel": lambda: ss._walk_group_plain(ps, kr, order, Uw),
        "walk_apply_kernel": lambda: ss._walk_apply_plain(const, ps, gr,
                                                          walk, Uw)}
    ks = walk_cases.clone_state(st)
    rd = walk_cuda.WalkRound(fm, const, ks, Uw)
    s = rd.scratch
    restore = restorer(ks, ("k", "l", "s", "i", "alive", "ctr"),
                       s["sc"][walk_cuda.SC_EPOCH:walk_cuda.SC_EPOCH + 1])

    def chain_walk():
        return ss._chain_walk(fm, s["rep_rw"], W, s["rep_k"], s["rep_l"],
                              s["rep_s"], s["rep_valid"], is_back=True,
                              stop_s=s["gmin"])

    walk_cuda.key(rd)
    walk_cuda.sort(rd)
    walk_cuda.group(rd)
    rd.set_walk(*chain_walk())
    walk_cuda.apply(rd)
    torch.cuda.synchronize()
    runs = {"walk_key_kernel": lambda: walk_cuda.key(rd),
            "sort": lambda: walk_cuda.sort(rd),
            "walk_group_kernel": lambda: walk_cuda.group(rd),
            "walk": chain_walk,
            "walk_apply_kernel": lambda: walk_cuda.apply(rd)}
    es = torch.empty(0, dtype=fm.dtype).element_size()
    out = dict(stats=stats, max_abs_err=errs, Uw=Uw)
    out.update(round_time({n: (run, restore) for n, run in runs.items()},
                          plain, walk_cases.round_work(stats, es, W), reps))
    restore()
    walk_cuda.key(rd)
    walk_cuda.sort(rd)
    out["sort"].update(sort_time(rd, reps))
    restore()
    del ks, rd, ps
    return out


def walk_main_path(l32, cases, split, seeder, queries, builds) -> dict:
    """Phase 4's walk numbers: each kernel's launches per chunk in the
    int32 window; each kernel timed at the first width of round 1's and of
    round 2's walk_pool_chain call, at one block of round 1, at a ragged
    width and padded (walk_time); the launches of a round (launch_split,
    run by chain_main_path), gated; every round of one run of the first
    chunk (walk_cases.EveryRound), those forms and the block through every
    build in turns (build_turns: ``builds``, the port's and any
    --walk-old-source); each build's profiler means over one chunk in
    turns (walk_chunk_means)."""
    import torch
    from compseed_tpu_torch.ops import walk_cases
    per_chunk = {k: l32[k] / ((RUNS + 1) * N_CHUNKS) for k in WALK_KERNELS}
    log(f"[4] walk kernel launches per {CHUNK}-read chunk (int32 window): "
        f"{json.dumps(per_chunk)}")
    for k in WALK_KERNELS:
        if l32[k] <= 0:
            raise SystemExit(f"int32 main path: {k} was not launched: {l32}")
    shapes = {}
    for (call, n), case in sorted(cases.items()):
        if n not in (24 * CHUNK, 16 * CHUNK):
            continue
        tag = f"round {1 if n == 24 * CHUNK else 2} lanes={n}"
        shapes[tag] = r = walk_time(case)
        log(f"[4] walk kernels at {tag} (Uw={case[3]}): {json.dumps(r)}")
        if any(r["max_abs_err"].values()):
            raise SystemExit(f"a walk kernel disagrees with its plain step "
                             f"at {tag}")
    if len(shapes) != 2:
        raise SystemExit(f"the walk rounds to time were not captured: "
                         f"{sorted(shapes)}")
    wide = cases[(1, 24 * CHUNK)]
    forms = {f"floor lanes={FLOOR_LANES}": walk_cases.narrow(wide,
                                                             FLOOR_LANES),
             f"ragged lanes={24 * CHUNK - 333}": walk_cases.narrow(
                 wide, 24 * CHUNK - 333),
             f"padded lanes={24 * CHUNK}": walk_cases.padded(wide)}
    for tag, case in forms.items():
        shapes[tag] = r = walk_time(case)
        log(f"[4] walk kernels at {tag} (Uw={case[3]}): {json.dumps(r)}")
        if any(r["max_abs_err"].values()):
            raise SystemExit(f"a walk kernel disagrees with its plain step "
                             f"at {tag}")
    per_round = split["per_round"]["walk_round"]["kernels"]
    if per_round > MAX_WALK_ROUND_KERNELS:
        raise SystemExit(f"the card runs {per_round:.2f} kernels a "
                         f"walk_pool_chain round, more than "
                         f"{MAX_WALK_ROUND_KERNELS}")
    with walk_cases.EveryRound() as cap:
        seeder.run_flat(queries)
    torch.cuda.synchronize()
    rounds = {f"call {call} round {r} lanes={c[2]['k'].shape[0]}": c
              for (call, r), c in sorted(cap.states.items())}
    del cap
    redesign = build_turns("walk", builds, dict(rounds, **forms),
                           WALK_KERNELS, walk_cases.steps_vs_plain, walk_runs)
    del rounds
    # the apply with its folded loop test and without, at the timed widths
    tail = loop_tail_turns("walk", {
        f"round {1 if n == 24 * CHUNK else 2} lanes={n}": c
        for (call, n), c in sorted(cases.items())
        if n in (24 * CHUNK, 16 * CHUNK)})
    means = walk_chunk_means(builds, seeder, queries)
    return dict(launches_per_chunk=per_chunk, shapes=shapes,
                kernels_per_round=per_round, redesign=redesign,
                loop_tail=tail, chunk_means=means)


class OldWalkBuild:
    """The kernels of another csrc/walk_chain.cu (--walk-old-source: the
    parent's, or a variant), launched on a WalkRound's Args words: its
    struct Args must be the port's or a prefix of it (walk_cuda._bind
    checks its size).  Its group's look-back status words are the
    round's own, a word a block of walk_cuda.GROUP_BLOCK lanes: enough for
    group blocks of that many lanes or more (so that its launches, like
    the port's, allocate nothing and can be captured in a round's
    graph)."""

    def __init__(self, lib):
        from compseed_tpu_torch.ops import walk_cuda
        walk_cuda._bind(lib, prefix=True)
        self.lib = lib
        # whether its apply runs the loop's test (its Args has the loop
        # word): a build without it cannot end a loop's body
        self.folds = lib.walk_args_words() > walk_cuda.ARGS.index("loop")
        # the one-thread loop entry kernel of a build from before the
        # segment entry kernels (the parent's), for entry_time
        self.loop_entry = None
        if hasattr(lib, "walk_loop_entry_launch"):
            import ctypes as ct
            fn = lib.walk_loop_entry_launch
            fn.argtypes, fn.restype = [ct.c_void_p, ct.c_void_p], ct.c_int
            self.loop_entry = lambda rd: self._run("walk_loop_entry_launch",
                                                   rd)
        # a variant's segment entry kernel (its Args the port's), for
        # entry_check and entry_time
        self.segment_entry = None
        if hasattr(lib, "walk_segment_entry_launch"):
            import ctypes as ct
            fn = lib.walk_segment_entry_launch
            fn.argtypes, fn.restype = [ct.c_void_p, ct.c_void_p], ct.c_int
            self.segment_entry = lambda rd: self._run(
                "walk_segment_entry_launch", rd)

    def _run(self, launcher, rd):
        import ctypes as ct

        import torch
        with torch.cuda.device(rd.dev):
            rc = getattr(self.lib, launcher)(
                ct.addressof(rd.args),
                torch.cuda.current_stream(rd.dev).cuda_stream)
        if rc:
            raise SystemExit(f"{launcher} (another walk build): CUDA error "
                             f"{rc}")

    def key(self, rd):
        self._run("walk_key_launch", rd)

    def group(self, rd):
        self._run("walk_group_launch", rd)

    def apply(self, rd):
        self._run("walk_apply_launch", rd)


def walk_runs(case, build) -> tuple:
    """A captured round through one build of the walk kernels (``build``:
    walk_cuda, or an OldWalkBuild), once whole (so every scratch array
    holds this round's data), and kernel -> (call, restore or None) for
    timing: before every group call the round's epoch moves on (its
    look-back must find no word of the call before), before every apply
    call the lane state and the counters are put back as the round found
    them.  Returns (runs, the round's arguments, its state)."""
    import torch
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops import walk_cases, walk_cuda
    fm, const, st, Uw = case
    ks = walk_cases.clone_state(st)
    rd = walk_cuda.WalkRound(fm, const, ks, Uw)
    s = rd.scratch
    epoch = s["sc"][walk_cuda.SC_EPOCH:walk_cuda.SC_EPOCH + 1]
    restore_apply = restorer(ks, ("k", "l", "s", "i", "alive", "ctr"),
                             epoch)
    build.key(rd)
    walk_cuda.sort(rd)
    build.group(rd)
    rd.set_walk(*ss._chain_walk(fm, s["rep_rw"], const["W"], s["rep_k"],
                                s["rep_l"], s["rep_s"], s["rep_valid"],
                                is_back=True, stop_s=s["gmin"]))
    build.apply(rd)
    torch.cuda.synchronize()
    runs = {"walk_key_kernel": (lambda: build.key(rd), None),
            "walk_group_kernel": (lambda: build.group(rd),
                                  restorer(ks, (), epoch)),
            "walk_apply_kernel": (lambda: build.apply(rd), restore_apply)}
    return runs, rd, ks


def chunk_means(what: str, module, ops, kernels, builds: dict, seeder,
                queries, records=(), turns: int = 1) -> dict:
    """torch.profiler's mean device ms per launch of each of a round
    source's kernels (``what``: "chain" or "walk") over one run of the
    first chunk's seeding (profile_chunk), the rounds on each build in
    turn (``module``'s wrappers ``ops``, such as chain_cuda.probe, group
    and apply, pointed at the build's for the run), the builds in order
    and then in reverse, ``turns`` times; every build's seeds must equal
    the port's.
    {build: {kernel: [ms, ...], busy_ms: [...], records: [{kernel: the
    device ms of each launch in order (``records``)}, ...]}}."""
    import contextlib

    import numpy as np
    import torch
    from compseed_tpu_torch.ops import seedscan as ss
    from compseed_tpu_torch.ops.seeder2 import EagerCalls
    # a build whose apply does not run the loop's test (a source from
    # before the loop word) would never end a segment's graph
    skip = [b for b, build in builds.items()
            if not getattr(build, "folds", True)]
    if skip:
        log(f"[4] {what} builds {skip} run no loop's test in their apply: "
            f"left out of the chunk's means")
        builds = {b: v for b, v in builds.items() if b not in skip}
    order = (list(builds) + list(builds)[::-1]) * turns
    out = {b: dict({k: [] for k in kernels}, busy_ms=[], records=[])
           for b in builds}
    want = seeder.run_flat(queries)
    # builds to compare run eagerly, each turn's loop graphs captured anew
    # on its build (a kept graph replays the kernels it was captured with)
    several = len(builds) > 1
    for b in order:
        build = builds[b]
        saved = [getattr(module, op) for op in ops]
        for op in ops:
            setattr(module, op, getattr(build, op))
        got = []
        if several:
            ss.drop_held()
        try:
            with EagerCalls() if several else contextlib.nullcontext():
                prof = profile_chunk(
                    lambda: got.append(seeder.run_flat(queries)),
                    torch.cuda.synchronize, records)
        finally:
            for op, fn in zip(ops, saved):
                setattr(module, op, fn)
        if not all(np.array_equal(x, y) for g in got
                   for x, y in zip(g, want)):
            raise SystemExit(f"{what} build {b}: the chunk's seeds differ "
                             f"from the port's")
        for k in kernels:
            out[b][k].append(prof["kernels"][k]["device_ms_per_launch"])
        out[b]["busy_ms"].append(prof["device_busy_s"] * 1e3)
        out[b]["records"].append(prof["records"])
    shown = {b: {k: v for k, v in r.items() if k != "records"}
             for b, r in out.items()}
    log(f"[4] {what} builds' profiler means per launch over one {CHUNK}-read "
        f"chunk, in turns: {json.dumps(shown)}")
    return out


def walk_chunk_means(builds: dict, seeder, queries) -> dict:
    """chunk_means of the walk kernels (walk_cuda.key, group, apply)."""
    from compseed_tpu_torch.ops import walk_cuda
    return chunk_means("walk", walk_cuda, ("key", "group", "apply"),
                       WALK_KERNELS, builds, seeder, queries)


def chain_chunk_means(builds: dict, seeder, queries,
                      turns: int = CHUNK_TURNS) -> dict:
    """chunk_means of the chain kernels (chain_cuda.probe, group, apply),
    with the probe's device ms at every round of the chunk, in ``turns``
    turns (a chunk's means differ by more from run to run than builds
    that differ in one level of L2 hits)."""
    from compseed_tpu_torch.ops import chain_cuda
    return chunk_means("chain", chain_cuda, ("probe", "group", "apply"),
                       CHAIN_KERNELS, builds, seeder, queries,
                       records=("chain_probe_kernel",), turns=turns)


def loop_rows(loop_rec, l32, row, prof) -> list:
    """The segment entry kernels' rows of the kernel table: launches
    (captured, a segment's once) in the main path's int32 window; ms,
    plain_ms and the bound at the loop's widest boundary of the first
    chunk (entry_time), every boundary's medians beside them
    (``boundaries``: the kernel, any variant build's, the PyTorch
    compaction it replaced and, with the parent's build, that and the
    one-thread loop entry kernel); max_abs_err over entry_check's
    boundaries and forms, the no-source check (loop_kernels) and
    loop_check's calls (the graph loop against the plain loop);
    device_ms_profiled: the profiler's mean over one chunk's runs of the
    kernel."""
    rows = []
    for k in LOOP_KERNELS:
        times = {t: r for t, r in loop_rec["entry_time"].items()
                 if r["kernel"] == k}
        r = max(times.values(), key=lambda x: x["src_w"])
        e = max([loop_rec["entry"][k]["max_abs_err"],
                 loop_rec["kernels"][f"{k} no source"]["max_abs_err"]] + [
            max(c["max_abs_err"].values()) for tag in ("int32", "int64")
            for c in (loop_rec[tag]["chain_scan"],
                      loop_rec[tag]["walk_pool_chain"])])
        rows.append(row(k, LOOP_REPLACES[k], l32[k], e,
                        r["median_ms"]["kernel"], r["plain_ms"], r,
                        source=LOOP_SOURCES[k.split("_")[0]],
                        at=f"{r['src_w']} -> {r['w']} lanes",
                        boundaries={t: x["median_ms"]
                                    for t, x in times.items()},
                        device_ms_profiled=prof.get(k, {}).get(
                            "device_ms_per_launch")))
    return rows


def walk_rows(walk_rec, l32, row, prof) -> list:
    """The walk kernels' rows of the kernel table (round_rows): ms,
    plain_ms, the profiler's device time and the bound of round 1's first
    width (393,216 lanes); max_abs_err over every captured round, int32
    and int64, in every form (phase 2)."""
    return round_rows(walk_rec, f"round 1 lanes={24 * CHUNK}",
                      f"floor lanes={FLOOR_LANES}", WALK_KERNELS,
                      WALK_REPLACES, WALK_SOURCE, l32, row, prof)


def compare(tiles, gap, state16: bool):
    """One set of DP tiles through the int32 kernel (rows in shared
    memory), the device-memory-scratch kernel and their plain version
    and, with state16, also the int16 kernel and its plain version.
    Returns a dict of max_abs_err and times per variant plus the band
    cells counted by the plain version's loop bounds."""
    import torch
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.bsw import _extend_core
    mat, q, ql, t, tl, h0, ws = tiles

    def kern(s16):
        return lambda: bsw_cuda.bsw_extend_tiles(mat, q, ql, t, tl, h0, ws,
                                                 **gap, state16=s16)

    def scratch(s16):
        return lambda: bsw_cuda._launch_extend(mat, q, ql, t, tl, h0, ws,
                                               **gap, state16=s16, threads=0)

    def plain(s16, count=False):
        return lambda: _extend_core(
            gap["o_del"], gap["e_del"], gap["o_ins"], gap["e_ins"],
            gap["zdrop"], mat, ws[:, 0], q, ql[:, 0], t, tl[:, 0], h0[:, 0],
            state16=s16, count_cells=count)

    p32, cells = plain(False, count=True)()
    k32 = kern(False)()[:, :6]
    g32 = scratch(False)()[:, :6]
    torch.cuda.synchronize()
    out = dict(cells=int(cells), err32=err(k32, p32.T),
               errg=err(g32, p32.T),
               k32_ms=cuda_time_ms(kern(False), 5),
               g32_ms=cuda_time_ms(scratch(False), 5),
               p32_ms=cuda_time_ms(plain(False), 2))
    if state16:
        k16 = kern(True)()[:, :6]
        g16 = scratch(True)()[:, :6]
        p16 = plain(True)().T
        torch.cuda.synchronize()
        out["errg"] = max(out["errg"], err(g16, p16))
        out.update(err16=max(err(k16, p16), err(k16, k32)),
                   k16_ms=cuda_time_ms(kern(True), 5),
                   p16_ms=cuda_time_ms(plain(True), 2))
    return out


def scratch_variants(old_source):
    """name -> fn(tiles, gap) launching the int32 device-memory-scratch
    kernel of a build of its own: the source with BSW_SCRATCH_HOIST=0 and
    =1 and, when given, ``old_source`` (launcher without the
    pairs-per-block argument).  The builds run side by side."""
    import ctypes as ct
    import torch
    from compseed_tpu_torch.ops import bsw_cuda, cuda_lib
    builds = {f"hoist{h}": (bsw_cuda.LIB.src, (f"BSW_SCRATCH_HOIST={h}",))
              for h in (0, 1)}
    if old_source:
        builds["old"] = (os.path.abspath(old_source), ())
    sos = {k: os.path.join(cuda_lib.BUILD, f"libbsw_scratch_{k}.so")
           for k in builds}
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    with cf.ThreadPoolExecutor(max_workers=len(builds)) as ex:
        for f in [ex.submit(cuda_lib.compile_source, src, sos[k], defs)
                  for k, (src, defs) in builds.items()]:
            f.result()

    def launcher(name):
        fn = ct.CDLL(sos[name]).bsw_extend_launch
        tail = () if name == "old" else (0,)
        fn.restype = ct.c_int
        fn.argtypes = [ct.c_void_p] * 10 + [ct.c_int] * (8 + len(tail)) \
            + [ct.c_void_p]

        def run(tiles, gap):
            mat, q, ql, t, tl, h0, ws = tiles
            P, Q = q.shape
            out = torch.empty((P, 8), dtype=torch.int32, device=q.device)
            hbuf = torch.empty(((Q + 1) * P,), dtype=torch.int32,
                               device=q.device)
            ebuf = torch.empty_like(hbuf)
            rc = fn(*(x.data_ptr() for x in (mat, q, ql, t, tl, h0, ws, out,
                                             hbuf, ebuf)),
                    P, Q, t.shape[1], *gap.values(), *tail,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"scratch build {name}: CUDA error {rc}")
            return out
        return run

    return {k: launcher(k) for k in builds}


def time_scratch(variants, tiles, gap):
    """Each build's scratch kernel on ``tiles``: held to the plain version,
    then timed in turns (forward, then backward).  name -> [ms, ms]."""
    import torch
    from compseed_tpu_torch.ops.bsw import _extend_tiles_plain
    want = _extend_tiles_plain(*tiles, **gap)
    times = {}
    for name, run in variants.items():
        if not torch.equal(run(tiles, gap), want):
            raise SystemExit(f"scratch build {name} disagrees with the plain "
                             f"version")
    for name in list(variants) + list(variants)[::-1]:
        times.setdefault(name, []).append(cuda_time_ms(
            lambda: variants[name](tiles, gap), 5))
    return times


def load_reads(reader, name):
    reads = []
    for chunk in reader(os.path.join(ROOT, "tests", "fixtures", name),
                        10_000_000):
        reads.extend(chunk)
    return reads


def golden(name):
    with open(os.path.join(ROOT, "tests", "fixtures", name)) as f:
        return [line for line in f if not line.startswith("@")]


def watch_overflow(seeder):
    """Record (last_overflow, GP_F, rerun seconds, device seconds,
    fwd_disabled, the rerun's split: BatchSeeder.split()) after every
    run_flat."""
    seen = []
    run_flat = seeder.run_flat

    def watched(queries, stats=None):
        out = run_flat(queries, stats)
        seen.append((bool(seeder.last_overflow), seeder.GP_F,
                     seeder.prof.get("rerun_s") if seeder.last_overflow
                     else None, seeder.prof["device_s"],
                     seeder.fwd_disabled,
                     seeder.prof.get("rerun_split") if seeder.last_overflow
                     else None))
        return out

    seeder.run_flat = watched
    return seen


def sam_lines(path):
    """A SAM file's lines without @PG (the one line that names the
    command)."""
    with open(path) as f:
        return [line for line in f if not line.startswith("@PG")]


def run_cli(argv, seed_s):
    """``cli.main(argv)`` with its stderr captured.  Returns a record:
    wall seconds, the kernels' launch counts of this run alone (set to 0
    just before it), the seconds of every ``DeviceSeeder.run_flat`` call
    (``seed_s``, filled by the caller's patch), the cap-overflow lines
    and what the exit report gives.  A non-zero return code or a run
    that launched no DP kernel ends the script."""
    import torch
    from compseed_tpu_torch import cli
    from compseed_tpu_torch.ops import bsw_cuda
    reset_launches()
    del seed_s[:]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise SystemExit(f"cli {argv} returned {rc}:\n{text[-2000:]}")
    launches = launch_counts()
    rec = dict(wall_s=wall, launches=launches, seed_s=list(seed_s),
               overflows=text.count("cap overflow"))
    if "oracle" not in argv and \
            sum(v for k, v in launches.items() if k.startswith("bsw_")) <= 0:
        raise SystemExit(f"cli {argv}: no DP kernel was launched: {launches}")
    m = re.search(r"BWT-extend: +(\d+) queries, (\d+) calls", text)
    if m:
        q, c = int(m.group(1)), int(m.group(2))
        rec["bwt_hit_pct"] = 100.0 * (q - c) / q
    m = re.search(r"SA Lookup: +(\d+) queries, (\d+) calls", text)
    if m:
        q, c = int(m.group(1)), int(m.group(2))
        rec["sal_merged_pct"] = 100.0 * (q - c) / q
    m = re.findall(r"\[mem\] processed (\d+) reads \((\d+) reads/s\)", text)
    if m:
        rec["reads"], rec["align_reads_per_s"] = int(m[-1][0]), int(m[-1][1])
    m = re.search(r"densified .* in ([0-9.]+)s", text)
    if m:
        rec["densify_s"] = float(m.group(1))
    return rec


def bare_stream(dev, prefix, reads_path, k_bases, seed_s, want_sams):
    """What ``mem -K k_bases prefix reads_path`` runs, without the
    command around it: the index loaded from its files, a new seeder,
    engine and tail, the raw-reads file through ``align_stream``.  The
    SAM must equal ``want_sams``.  Returns reads/s over all of it and the
    seconds of every ``run_flat`` call."""
    import torch
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import read_reordered_chunks
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    del seed_s[:]
    t0 = time.perf_counter()
    opt = MemOptions()
    fm = FMIndex.load(prefix)
    seeder = device_seeder(opt, fm, dedup=True, device=dev)
    engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)
    done = []
    align_stream(opt, fm, read_reordered_chunks(reads_path, k_bases), engine,
                 seeder, NativeTail(opt, fm), on_done=done.extend,
                 stats=SeedingStats())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [r.sam for r in done] != want_sams:
        raise SystemExit("align_stream on the raw-reads file: SAM differs "
                         "from phase 4's")
    return dict(reads_per_s=len(done) / wall, wall_s=wall,
                seed_s=list(seed_s))


def phase_cli(dev, smi, fm, reads_arr, main_sams, main_rec):
    """Phase 5 (see the module docstring).  ``main_sams``: phase 4's SAM
    strings of one stream of N_CHUNKS x CHUNK reads; ``main_rec``: its
    record.  Returns the numbers of the ``cli`` JSON line; its
    ``launches`` are summed over every ``mem`` run of the phase."""
    import numpy as np
    import torch
    from compseed_tpu_torch import bench_input, cli
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.ops import seeder2
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    fx = os.path.join(ROOT, "tests", "fixtures")
    seed_s = []
    total = {}
    run_flat = seeder2.DeviceSeeder.run_flat

    def mem(argv):
        rec = run_cli(["mem"] + argv, seed_s)
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
        return rec

    def timed_run_flat(self, queries, stats=None):
        t0 = time.perf_counter()
        out = run_flat(self, queries, stats)     # ends in copies to the host
        seed_s.append(time.perf_counter() - t0)
        return out

    def text_of(arr):
        return [bytes(NT4_TO_ASCII[r]).decode() for r in arr]

    out = {"card": smi}
    seeder2.DeviceSeeder.run_flat = timed_run_flat
    try:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                prefix="chip_smoke_cli_",
                dir=os.path.join(ROOT, "build")) as tmp:
            def path(name):
                return os.path.join(tmp, name)

            # ---- index: the committed fixture index, byte for byte
            t0 = time.time()
            if cli.main(["index", "-p", path("tiny"),
                         os.path.join(fx, "tiny.fa")]) != 0:
                raise SystemExit("cli index failed")
            for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
                with open(path("tiny") + ext, "rb") as f, \
                        open(os.path.join(fx, "tiny" + ext), "rb") as g:
                    if f.read() != g.read():
                        raise SystemExit(f"cli index: tiny{ext} differs from "
                                         f"the committed file")
            log(f"[5] cli index: five files byte-equal to tests/fixtures/"
                f"tiny.* ({time.time() - t0:.1f} s)")

            # ---- the seven goldens at the CLI's defaults
            alt = os.path.join(fx, "tiny_alt")
            goldens = {}
            for gold, argv in (
                    ("golden_bwamem.sam", [path("tiny"), "reads.fq"]),
                    ("golden_compseed_reordered.sam",
                     [path("tiny"), "reads.reordered"]),
                    ("golden_bwamem_pe.sam",
                     [path("tiny"), "reads_1.fq", "reads_2.fq"]),
                    ("golden_bwamem_smartpe.sam",
                     ["-p", path("tiny"), "reads_mixed.fq"]),
                    ("golden_alt_se.sam", [alt, "reads_alt.fq"]),
                    ("golden_alt_j.sam", ["-j", alt, "reads_alt.fq"]),
                    ("golden_alt_pe.sam",
                     [alt, "reads_alt_1.fq", "reads_alt_2.fq"])):
                argv = [a if os.sep in a or a.startswith("-")
                        else os.path.join(fx, a) for a in argv]
                rec = mem(["-o", path(gold)] + argv)
                mine = sam_lines(path(gold))
                want = sam_lines(os.path.join(fx, gold))
                bad = [i for i, (m, g) in enumerate(zip(mine, want))
                       if m != g]
                log(f"[5] cli mem -> {gold}: {len(mine)} lines ({len(want)} "
                    f"in the golden), {len(bad)} differ; {rec['wall_s']:.1f} "
                    f"s, {rec['overflows']} cap overflow(s), launches "
                    f"{rec['launches']}")
                if len(mine) != len(want) or bad:
                    raise SystemExit(f"cli mem: SAM differs from {gold}: "
                                     f"lines {bad[:5]}")
                goldens[gold] = dict(wall_s=rec["wall_s"],
                                     launches=rec["launches"],
                                     overflows=rec["overflows"])
            out["goldens"] = goldens

            # ---- full width: the bench reads as a raw-reads file
            n_timed = N_CHUNKS * CHUNK
            k_bases = str(CHUNK * reads_arr.shape[1])
            seqs = text_of(reads_arr)
            with open(path("bench.reads"), "w") as f:
                for c in range(N_CHUNKS):
                    s0 = (c * CHUNK) % len(seqs)
                    f.write("\n".join((seqs[s0:] + seqs[:s0])[:CHUNK]) + "\n")
            prefix8 = bench_input.index_prefix(8)
            runs = []
            for run in range(RUNS + 1):            # the first warms up
                rec = mem(["-K", k_bases, "-o", path("bench.sam"), prefix8,
                           path("bench.reads")])
                rec["reads_per_s"] = n_timed / rec["wall_s"]
                log(f"[5] cli mem -K {k_bases}, run {run}: "
                    f"{rec['reads_per_s']:.1f} reads/s for the whole command "
                    f"({rec['wall_s']:.2f} s), {rec['align_reads_per_s']} "
                    f"reads/s in its own report; seeding s per chunk "
                    f"{[round(x, 3) for x in rec['seed_s']]}")
                runs.append(rec)
            with open(path("bench.sam")) as f:
                body = "".join(l for l in f if not l.startswith("@"))
            if body != "".join(main_sams):
                raise SystemExit("cli mem at full width: SAM differs from "
                                 "phase 4's align_stream")
            last = runs[-1]
            reuse = (round(last["bwt_hit_pct"], 4),
                     round(last["sal_merged_pct"], 4))
            if reuse != EXPECT_REUSE or last["reads"] != n_timed:
                raise SystemExit(f"cli mem at full width: exit report gives "
                                 f"{reuse} over {last['reads']} reads, "
                                 f"expected {EXPECT_REUSE} over {n_timed}")
            if last["launches"]["bsw_meta_dual_kernel"] != 2 * N_CHUNKS:
                raise SystemExit(f"cli mem at full width: expected "
                                 f"{2 * N_CHUNKS} fused launches: "
                                 f"{last['launches']}")
            # the same file through align_stream alone (what the command
            # runs, without its reader and writer threads), set up from
            # the index files like the command, in turns with it
            timed = runs[1:]
            bare = []
            for turn in ("bare", "bare", "cli"):
                if turn == "cli":
                    rec = mem(["-K", k_bases, "-o", path("bench.sam"),
                               prefix8, path("bench.reads")])
                    rec["reads_per_s"] = n_timed / rec["wall_s"]
                    timed.append(rec)
                else:
                    rec = bare_stream(dev, prefix8, path("bench.reads"),
                                      int(k_bases), seed_s, main_sams)
                    bare.append(rec)
                log(f"[5] in turns, {turn}: {rec['reads_per_s']:.1f} reads/s "
                    f"with its set-up; seeding s per chunk "
                    f"{[round(x, 3) for x in rec['seed_s']]}")
            out["full_width"] = dict(
                reads=n_timed, k_bases=int(k_bases),
                reads_per_s=statistics.median(r["reads_per_s"]
                                              for r in timed),
                runs=[r["reads_per_s"] for r in timed],
                align_reads_per_s=[r["align_reads_per_s"] for r in timed],
                warm_up_reads_per_s=runs[0]["reads_per_s"],
                stream_reads_per_s=main_rec["reads_per_s"],
                bare_in_turns_reads_per_s=[r["reads_per_s"] for r in bare],
                bare_in_turns_seed_s_per_chunk=[r["seed_s"] for r in bare],
                seed_s_per_chunk=[r["seed_s"] for r in timed],
                bwt_hit_pct=last["bwt_hit_pct"],
                sal_merged_pct=last["sal_merged_pct"],
                launches=last["launches"], sam_equals_stream=True)
            log(f"[5] cli at full width: "
                f"{out['full_width']['reads_per_s']:.1f} reads/s (median of {len(timed)}; phase 4's bare stream "
                f"{main_rec['reads_per_s']:.1f}, align_stream on the same "
                f"file in turns "
                f"{[round(r['reads_per_s'], 1) for r in bare]}), SAM "
                f"byte-equal to the stream's, reuse {reuse}")

            # ---- --sa-intv: interval 32 densified to 8 on the card
            t0 = time.time()
            prefix32 = bench_input.index_prefix(32)
            build32_s = time.time() - t0
            n_half = 2 * CHUNK
            with open(path("half.reads"), "w") as f:
                f.write("\n".join((seqs + seqs)[:n_half]) + "\n")
            sa = {}
            for tag, argv in (("8", [prefix8]), ("32", [prefix32]),
                              ("32->8", ["--sa-intv", "8", prefix32]),
                              ("8 again", [prefix8])):
                rec = mem(["-K", k_bases, "-o", path("half.sam")] + argv
                          + [path("half.reads")])
                with open(path("half.sam")) as f:
                    body = "".join(l for l in f if not l.startswith("@"))
                if body != "".join(main_sams[:n_half]):
                    raise SystemExit(f"cli mem on the interval-{tag} index: "
                                     f"SAM differs from phase 4's")
                sa[tag] = dict(seed_s_per_chunk=rec["seed_s"],
                               wall_s=rec["wall_s"],
                               densify_s=rec.get("densify_s"),
                               overflows=rec["overflows"])
                log(f"[5] cli mem, index at interval {tag}: seeding s per "
                    f"chunk {[round(x, 3) for x in rec['seed_s']]}, whole "
                    f"command {rec['wall_s']:.2f} s, densify_sa "
                    f"{rec.get('densify_s')} s; SAM equal")
            if sa["32->8"]["densify_s"] is None:
                raise SystemExit("cli mem --sa-intv 8 did not densify")
            # the densified sample itself against the direct build, and
            # densify_sa timed alone
            from compseed_tpu_torch.ops.device_index import (densify_sa,
                                                             to_device)
            dfi32 = to_device(FMIndex.load(prefix32), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dfi8 = densify_sa(dfi32, 8)
            torch.cuda.synchronize()
            densify_s = time.perf_counter() - t0
            want = torch.from_numpy(fm.sa_sampled.astype(np.int64)).to(dev)
            if dfi8.sa_sampled.dtype != dfi32.sa_sampled.dtype or \
                    not torch.equal(dfi8.sa_sampled.to(torch.int64), want):
                raise SystemExit("densify_sa(32 -> 8) differs from the index "
                                 "built at interval 8")
            out["sa_intv"] = dict(runs=sa, densify_s=densify_s,
                                  samples=int(want.numel()),
                                  build32_s=build32_s, reads=n_half)
            log(f"[5] densify_sa 32 -> 8 on the card: {densify_s:.3f} s for "
                f"{want.numel()} samples, equal to the direct build "
                f"(interval-32 index built in {build32_s:.1f} s)")

            # ---- paired-end at full width
            t0 = time.time()
            r1, r2 = bench_input.pe_pairs(PE_PAIRS)
            for name, arr in (("pe_1.fq", r1), ("pe_2.fq", r2)):
                qual = "I" * arr.shape[1]
                with open(path(name), "w") as f:
                    f.write("".join(f"@p{i}\n{s}\n+\n{qual}\n"
                                    for i, s in enumerate(text_of(arr))))
                with open(path(name)) as f, open(path("o" + name), "w") as g:
                    for _ in range(4 * PE_ORACLE_PAIRS):
                        g.write(f.readline())
            log(f"[5] {PE_PAIRS} pairs simulated and written in "
                f"{time.time() - t0:.1f} s")
            pe_runs = []
            for run in range(RUNS + 1):
                rec = mem(["-I", PE_INSERT, "-K", k_bases, "-o",
                           path("pe.sam"), prefix8, path("pe_1.fq"),
                           path("pe_2.fq")])
                rec["reads_per_s"] = 2 * PE_PAIRS / rec["wall_s"]
                log(f"[5] cli mem r1 r2, run {run}: {rec['reads_per_s']:.1f} "
                    f"reads/s for the whole command, "
                    f"{rec['align_reads_per_s']} in its own report; seeding "
                    f"s per chunk {[round(x, 3) for x in rec['seed_s']]}; "
                    f"{rec['overflows']} cap overflow(s); launches "
                    f"{rec['launches']}")
                pe_runs.append(rec)
            t0 = time.time()
            mem(["--engine", "oracle", "-I", PE_INSERT, "-o",
                 path("pe_oracle.sam"), prefix8, path("ope_1.fq"),
                 path("ope_2.fq")])
            oracle_s = time.time() - t0
            want = sam_lines(path("pe_oracle.sam"))
            mine = sam_lines(path("pe.sam"))
            n_hdr = sum(l.startswith("@") for l in want)
            names = {f"p{i}" for i in range(PE_ORACLE_PAIRS)}
            head = [l for l in mine if l.startswith("@")
                    or l.split("\t", 1)[0] in names]
            bad = [i for i, (m, g) in enumerate(zip(head, want)) if m != g]
            flags = [int(l.split("\t")[1]) for l in mine[n_hdr:]]
            proper = sum(1 for f in flags if f & 0x2 and not f & 0x900)
            log(f"[5] paired-end: {len(mine) - n_hdr} records for "
                f"{2 * PE_PAIRS} reads, {proper} primary records properly "
                f"paired; first {PE_ORACLE_PAIRS} pairs vs --engine oracle "
                f"({oracle_s:.1f} s): {len(bad)} of {len(want)} lines differ")
            if len(head) != len(want) or bad:
                raise SystemExit(f"paired-end: SAM differs from the host "
                                 f"oracle path: lines {bad[:5]}")
            if proper < PE_PAIRS:
                raise SystemExit(f"paired-end: only {proper} of "
                                 f"{2 * PE_PAIRS} reads properly paired")
            out["paired_end"] = dict(
                pairs=PE_PAIRS, insert=PE_INSERT,
                reads_per_s=statistics.median(r["reads_per_s"]
                                              for r in pe_runs[1:]),
                runs=[r["reads_per_s"] for r in pe_runs[1:]],
                align_reads_per_s=[r["align_reads_per_s"]
                                   for r in pe_runs[1:]],
                seed_s_per_chunk=[r["seed_s"] for r in pe_runs[1:]],
                launches=pe_runs[-1]["launches"],
                overflows=[r["overflows"] for r in pe_runs],
                properly_paired=proper, oracle_pairs=PE_ORACLE_PAIRS,
                oracle_s=oracle_s)

            # ---- -y 0: the lockstep round 3 in the seeder
            with open(path("y0.reads"), "w") as f:
                f.write("\n".join(seqs[:ORACLE_READS]) + "\n")
            rec = mem(["-y", "0", "-o", path("y0.sam"), prefix8,
                       path("y0.reads")])
            t0 = time.time()
            mem(["-y", "0", "--engine", "oracle", "-o",
                 path("y0_oracle.sam"), prefix8, path("y0.reads")])
            mine, want = sam_lines(path("y0.sam")), \
                sam_lines(path("y0_oracle.sam"))
            bad = [i for i, (m, g) in enumerate(zip(mine, want)) if m != g]
            log(f"[5] cli mem -y 0: {ORACLE_READS} reads, seeding "
                f"{[round(x, 3) for x in rec['seed_s']]} s, launches "
                f"{rec['launches']}; vs --engine oracle "
                f"({time.time() - t0:.1f} s): {len(bad)} lines differ")
            if len(mine) != len(want) or bad:
                raise SystemExit(f"-y 0: SAM differs from the host oracle "
                                 f"path: lines {bad[:5]}")
            out["y0"] = dict(reads=ORACLE_READS, seed_s=rec["seed_s"],
                             launches=rec["launches"],
                             overflows=rec["overflows"])
            out["launches"] = total
    finally:
        seeder2.DeviceSeeder.run_flat = run_flat
    return out


@contextlib.contextmanager
def engine_env(knobs):
    """The env knobs that select a seeding engine, set for the block."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def head_record(head, seedpk):
    """A seeder head's 28 scalars and digests of the whole head and seed
    matrix, as ``compseed_tpu_torch/engine_heads.json`` stores them."""
    import hashlib
    import numpy as np
    return dict(
        scalars=[int(x) for x in head[:28]],
        head_sha256=hashlib.sha256(
            np.ascontiguousarray(head, np.int32).tobytes()).hexdigest(),
        seedpk_sha256=hashlib.sha256(
            np.ascontiguousarray(seedpk, np.int32).tobytes()).hexdigest())


def reuse_of(head):
    """(bwt_hit_pct, sal_merged_pct) of one chunk from its head."""
    q = int(head[18]) + int(head[20]) + sum(int(x) for x in head[22:28:2])
    c = int(head[19]) + int(head[21]) + sum(int(x) for x in head[23:28:2])
    return 100.0 * (q - c) / q, 100.0 * (int(head[1]) - int(head[2])) / \
        int(head[1])


def phase_engines(dev, smi, opt, fm, fm_t, reads_arr, dfi, engine, tail,
                  chunks, main_sams):
    """Phase 6 (see the module docstring).  ``chunks``: phase 4's stream
    of N_CHUNKS x CHUNK reads; ``main_sams`` its SAM.  Returns the numbers
    of the ``engines`` JSON line."""
    import numpy as np
    import torch
    from compseed_tpu_torch.io.fastq import (read_fastq_chunks,
                                             read_reordered_chunks)
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.engine import device_engine
    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats

    with open(os.path.join(ROOT, "compseed_tpu_torch",
                           "engine_heads.json")) as f:
        stored = json.load(f)
    n_head = stored["chunk"]["reads"]
    out = {"card": smi, "heads_from": stored["command"]}

    def seeder_for(dedup, fm_=fm, dfi_=dfi):
        return DeviceSeeder(opt, fm_, dev, dfi=dfi_, dedup=dedup)

    # ---- (a) the first chunk through each engine: head and seed matrix
    # against the JAX package's constants; (b) then, on a fresh seeder a
    # run (an overflow switches the next run's engine), two timed runs
    # whose seeds must equal the default engine's
    if n_head != CHUNK:
        raise SystemExit(f"engine_heads.json holds a {n_head}-read chunk, "
                         f"phase 6 runs {CHUNK}")
    queries = list(reads_arr[:CHUNK])
    want = None
    full = {}
    for name, (dedup, env) in ENGINES.items():
        runs, spliced, overflows, rerun_s = [], [], [], []
        with engine_env(env):
            sd = seeder_for(dedup)
            R, L, qd, rd = sd._upload(queries)
            reset_launches()
            t0 = time.time()
            _, _, head, seedpk = sd._run(sd._build(R, L), qd, rd)
            head, seedpk = head.cpu().numpy(), seedpk.cpu().numpy()
            first_s = time.time() - t0
            counts = launch_counts()
            fm_launches = {k: v for k, v in counts.items()
                           if k in FM_KERNELS + CHAIN_KERNELS}
            lockstep_launches = {k: counts[k] for k in LOCKSTEP_KERNELS}
            rec = head_record(head, seedpk)
            if rec != stored["engines"][name]:
                raise SystemExit(f"engine {name}: the head of the first "
                                 f"chunk differs from the JAX package's: "
                                 f"{rec} vs {stored['engines'][name]}")
            for _ in range(2):
                sd = seeder_for(dedup)
                orig = sd._splice_oracle

                def splice(qs, bad, *a, orig=orig):
                    spliced.append(len(bad))
                    return orig(qs, bad, *a)

                sd._splice_oracle = splice
                got = sd.run_flat(queries)
                runs.append(sd.prof["device_s"])
                overflows.append(bool(sd.last_overflow))
                if sd.last_overflow:
                    rerun_s.append(sd.prof["rerun_s"])
            # one chunk on the route a stream takes (the call graph's,
            # captured by the run before), under the profiler: host
            # launches and syncs a chunk, gated
            R, L = sd._upload(queries)[:2]
            graphed = sd._graphed(sd._build(R, L))
            reset_launches()
            prof_rec = profile_chunk(lambda: sd.run_flat(queries),
                                     torch.cuda.synchronize)
            ext = launch_counts()["fm_extend_sel_kernel"] / 2
            call_rec = None
            if overflows[-1]:
                # a chunk that overflows the engine's caps is rerun and
                # the caps or the engine change: the engine's own chunk is
                # its call alone (engine_call), on a fresh seeder whose
                # first call captured its graph
                sc = seeder_for(dedup)
                engine_call(sc, queries)
                reset_launches()
                call_rec = profile_chunk(lambda: engine_call(sc, queries),
                                         torch.cuda.synchronize)
                call_rec["extend_launches"] = \
                    launch_counts()["fm_extend_sel_kernel"] / 2
                call_rec["graphed"] = sc._graphed(sc._build(R, L))
                sc._calls.drop_thread()
                del sc
        gated = call_rec or dict(prof_rec, extend_launches=ext,
                                 graphed=graphed)
        if not graphed or not gated["graphed"]:
            raise SystemExit(f"engine {name}: not on the call graph route")
        if gated["cudaStreamSynchronize"] > MAX_CHUNK_SYNCS or \
                gated["launches"] > MAX_CHUNK_LAUNCHES or \
                gated["extend_launches"]:
            raise SystemExit(f"engine {name}: a chunk by the call graph "
                             f"made {gated['cudaStreamSynchronize']} "
                             f"syncs and {gated['launches']} launches, "
                             f"{gated['extend_launches']} extension "
                             f"launches")
        if want is None:
            want = got
        if any(not np.array_equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"engine {name}: (lrep, sflat, soff) of the "
                             f"first chunk differ from the default engine's")
        hit, merged = reuse_of(head)
        split = {k: prof_rec[k] for k in (
            "launches", "cudaStreamSynchronize", "cudaMemcpyAsync",
            "ran_kernels", "device_busy_s", "wall_s")}
        if call_rec:
            split["engine_call"] = {k: call_rec[k] for k in (
                "launches", "cudaStreamSynchronize", "cudaMemcpyAsync",
                "ran_kernels", "device_busy_s", "wall_s", "kernels")}
        full[name] = dict(device_s=statistics.median(runs), runs=runs,
                          first_run_s=first_s, bwt_hit_pct=hit,
                          sal_merged_pct=merged, scalars=rec["scalars"],
                          overflow=overflows, rerun_s=rerun_s,
                          splice_reads=spliced, fm_launches=fm_launches,
                          lockstep_launches=lockstep_launches,
                          call_graph=graphed, chunk=split,
                          extend_launches_chunk=ext)
        log(f"[6] {name}: {CHUNK} reads, head and seed matrix equal the JAX "
            f"package's; device_s {[round(x, 4) for x in runs]} (first run "
            f"{first_s:.3f} s), BWT hit {hit:.4f} %, SAL merged "
            f"{merged:.4f} %, overflow flags {rec['scalars'][3:14]}, rerun "
            f"{rerun_s}, splice {spliced}; seeds equal the default engine's; "
            f"FM launches in the first run {fm_launches}, lockstep "
            f"{lockstep_launches}; a chunk on the "
            f"{'call graph' if graphed else 'eager'} route: {split}, "
            f"fm_extend_sel_kernel launches {ext}")
    out["full_width"] = full

    # ---- (c) cell A'': COMPSEED_ADAPTIVE_CAPS=0 and one forced switch
    with engine_env({"COMPSEED_ADAPTIVE_CAPS": "0"}):
        sd = seeder_for(True)
    sd.MEM3_F = 1
    seen = watch_overflow(sd)
    done = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    align_stream(opt, fm, iter(chunks), engine, sd, tail,
                 on_done=done.extend, stats=SeedingStats())
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    log(f"[6] (c) A'': per chunk (overflow, GP_F, rerun s, device s, "
        f"fwd_disabled) = {seen}; {len(done) / wall:.1f} reads/s; launches "
        f"{launches}")
    if [s[0] for s in seen] != [True] + [False] * (len(chunks) - 1):
        raise SystemExit("A'': chunk 1 alone must overflow")
    if not all(s[4] for s in seen) or sd.bwd_disabled or not sd.r2_dedup \
            or sd._cap_raises:
        raise SystemExit("A'': the overflow must switch the forward dedup "
                         "off and nothing else")
    if [r.sam for r in done] != main_sams:
        raise SystemExit("A'': SAM differs from phase 4's stream")
    if launches["bsw_meta_dual_kernel"] <= 0:
        raise SystemExit(f"A'': the fused DP kernel was not launched: "
                         f"{launches}")
    out["a2"] = dict(reads=len(done), reads_per_s=len(done) / wall,
                     wall_s=wall, rerun_s=seen[0][2],
                     device_s_per_chunk=[s[3] for s in seen],
                     overflow_flags=sd.prof["overflow_flags"],
                     launches=launches, sam_equals_stream=True)

    # ---- (d) the two 2,000-read goldens under all_off, one chunk each
    goldens = {}
    for name, reader, gold in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam"),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam")):
        reads = load_reads(reader, name)
        sd = seeder_for(False, fm_t, None)
        spliced = []
        orig = sd._splice_oracle

        def splice(qs, bad, *a, orig=orig):
            spliced.append(len(bad))
            return orig(qs, bad, *a)

        sd._splice_oracle = splice
        seen = watch_overflow(sd)
        eng = device_engine(opt, fm_t, dfi=sd.dfi, device=dev)
        done = []
        t0 = time.time()
        align_stream(opt, fm_t, iter([reads]), eng, sd, NativeTail(opt, fm_t),
                     on_done=done.extend, stats=SeedingStats())
        mine = "".join(r.sam for r in done).splitlines(keepends=True)
        want_g = golden(gold)
        bad = [i for i, (m, g) in enumerate(zip(mine, want_g)) if m != g]
        log(f"[6] (d) {name} under all_off: one chunk of {len(reads)} reads, "
            f"(overflow, GP_F, rerun s, device s, fwd_disabled) {seen}, "
            f"flags {sd.prof.get('overflow_flags')}, splice {spliced}; "
            f"{len(bad)} of {len(want_g)} records differ from {gold} "
            f"({time.time() - t0:.1f} s)")
        if len(mine) != len(want_g) or bad:
            raise SystemExit(f"all_off: SAM differs from {gold}: {bad[:5]}")
        goldens[name] = dict(overflow=seen[0][0], rerun_s=seen[0][2],
                             overflow_flags=sd.prof.get("overflow_flags"),
                             splice_reads=spliced)
    out["goldens_all_off"] = goldens
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh(dev, smi, opt, fm, reads_arr, dfi, chunks, main_sams):
    """Phase 7 (see the module docstring).  ``chunks``: phase 4's stream
    of N_CHUNKS x CHUNK reads; ``main_sams`` its SAM; ``dfi`` phase 4's
    index on the card.  Returns the numbers of the ``mesh`` JSON line; its
    ``launches`` are summed over (a)'s streams, counts set to 0 just
    before each (engine set-up included) and read just after."""
    import numpy as np
    import torch
    from compseed_tpu_torch import cli
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops import bsw_cuda
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.parallel.sharded import (ShardedBswRunner,
                                                     ShardedSeeder)
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    with open(os.path.join(ROOT, "compseed_tpu_torch",
                           "mesh_heads.json")) as f:
        stored = json.load(f)
    S_head = stored["chunk"]["shards"]
    if stored["chunk"]["reads"] != CHUNK or S_head not in MESH_SHARDS:
        raise SystemExit(f"mesh_heads.json holds {stored['chunk']}, phase 7 "
                         f"runs {CHUNK}-read chunks at {MESH_SHARDS} shards")
    out = {"card": smi, "heads_from": stored["command"]}
    t_phase = time.time()

    def reset_counts():
        reset_launches()

    def build(S, dfi_=dfi, gp_f=None):
        mesh = [dev] * S
        sd = ShardedSeeder(opt, fm, mesh=mesh, dfi=dfi_, dedup=True)
        if gp_f is not None:
            sd.GP_F = gp_f
        return sd, ShardedBswRunner(opt, np.array(opt.mat), mesh=mesh,
                                    dfi=sd.dfi)

    def heads_of(sd):
        """Each shard's head record of the seeder's first chunk."""
        got = []
        run = sd._run_shards

        def wrapped(*a):
            shards, fns = run(*a)
            if not got:
                got.extend(head_record(x[0], x[1].cpu().numpy())
                           for x in shards)
            return shards, fns

        sd._run_shards = wrapped
        return got

    def stream(sd, eng, chunks_):
        """The chunks through align_stream: SAM strings, wall seconds,
        SeedingStats and per chunk (overflow, R_shard, device s, shard
        s, GP_F after it)."""
        seen = []
        run_flat = sd.run_flat

        def watched(queries, stats=None):
            r = run_flat(queries, stats)
            seen.append(dict(overflow=bool(sd.last_overflow),
                             r_shard=sd.prof["r_shard"],
                             device_s=sd.prof["device_s"],
                             shard_s=sd.prof["shard_s"], gp_f=sd.GP_F,
                             rerun_s=sd.prof.get("rerun_s")))
            return r

        sd.run_flat = watched
        done = []
        st = SeedingStats()
        torch.cuda.synchronize()
        t0 = time.time()
        align_stream(opt, fm, iter(chunks_), eng, sd, NativeTail(opt, fm),
                     on_done=done.extend, stats=st)
        torch.cuda.synchronize()
        return [r.sam for r in done], time.time() - t0, st, seen

    # ---- (a) the stream at S = 1, 2, 4 on one card; (b) at S_head, the
    # first chunk's per-shard heads against the JAX package's
    full, total = {}, {}
    for S in MESH_SHARDS:
        reset_counts()
        sd, eng = build(S)
        heads = heads_of(sd) if S == S_head else None
        sams, wall, st, seen = stream(sd, eng, chunks)
        launches = launch_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        n = N_CHUNKS * CHUNK
        rec = dict(shards=S, reads_per_s=n / wall, wall_s=wall,
                   r_shard=seen[0]["r_shard"],
                   device_s_per_chunk=[c["device_s"] for c in seen],
                   shard_s_per_chunk=[c["shard_s"] for c in seen],
                   bwt_hit_pct=100.0 * (st.bwt_queries - st.bwt_calls)
                   / st.bwt_queries,
                   sal_merged_pct=100.0 * (st.sal_queries - st.sal_calls)
                   / st.sal_queries, launches=launches)
        log(f"[7] (a) S={S} on {dev}: {rec['reads_per_s']:.1f} reads/s "
            f"({wall:.2f} s for {n} reads), R_shard {rec['r_shard']}, "
            f"device s per chunk "
            f"{[round(x, 3) for x in rec['device_s_per_chunk']]}, shard s "
            f"{[[round(x, 3) for x in c] for c in rec['shard_s_per_chunk']]}"
            f", BWT hit {rec['bwt_hit_pct']:.4f} %, SAL merged "
            f"{rec['sal_merged_pct']:.4f} %, launches {launches}")
        if sams != main_sams:
            raise SystemExit(f"S={S}: SAM differs from phase 4's stream")
        if any(c["overflow"] for c in seen):
            raise SystemExit(f"S={S}: unexpected cap overflow")
        if launches["bsw_meta_dual_kernel"] != 2 * S * N_CHUNKS or \
                launches["probe_add_one_kernel"] <= 0 or \
                launches["fm_chain_walk_kernel"] <= 0 or \
                launches["fm_inv_psi_walk_kernel"] <= 0:
            raise SystemExit(f"S={S}: expected {2 * S * N_CHUNKS} fused "
                             f"launches (two a shard a chunk), the "
                             f"self-check's probe and the FM walks: "
                             f"{launches}")
        if heads is not None:
            want = stored["heads"]["int32"]
            bad = [s for s in range(S) if heads[s] != want[s]]
            log(f"[7] (b) S={S}: the first chunk's {S} shard heads vs the "
                f"JAX package's ShardedSeeder: {len(bad)} differ")
            if len(heads) != S or bad:
                raise SystemExit(f"S={S}: shard heads {bad} differ from "
                                 f"mesh_heads.json")
            rec["heads_equal_jax"] = True
        full[S] = rec
    out["full_width"] = full
    out["launches"] = total

    # ---- (c) forced overflow under sharding: every shard's round-1 pool
    # overflows, each shard reruns its own reads on the lockstep seeder
    S = max(MESH_SHARDS)
    reset_counts()
    sd, eng = build(S, gp_f=MESH_GP_F)
    sams, wall, _, seen = stream(sd, eng, chunks[:1])
    lf = launch_counts()
    log(f"[7] (c) S={S}, GP_F={MESH_GP_F}: overflow {seen[0]['overflow']}, "
        f"GP_F after {seen[0]['gp_f']}, {sd._cap_raises} cap raises, rerun "
        f"{seen[0]['rerun_s']:.2f} s (split {sd.prof.get('rerun_split')}), "
        f"chunk {wall:.2f} s, launches {lf}")
    if not seen[0]["overflow"] or sams != main_sams[:CHUNK]:
        raise SystemExit("forced overflow under sharding: no overflow, or "
                         "SAM differs from the unforced stream's")
    if lf["bsw_extend_kernel"] <= 0:
        raise SystemExit(f"forced overflow under sharding: the sharded flat "
                         f"pairs launched no DP kernel: {lf}")
    out["forced_overflow"] = dict(shards=S, gp_f=MESH_GP_F,
                                  gp_f_after=seen[0]["gp_f"],
                                  cap_raises=sd._cap_raises,
                                  rerun_s=seen[0]["rerun_s"], chunk_s=wall,
                                  rerun_split=sd.prof.get("rerun_split"),
                                  launches=lf)

    # ---- (f) the int64 index, sharded: heads against the JAX package's
    # int64 heads, SAM equal to the int32 run's
    reset_counts()
    dfi64 = to_device(fm, dev, force_dtype=np.int64)
    sd, eng = build(S_head, dfi_=dfi64)
    heads = heads_of(sd)
    sams, wall, _, seen = stream(sd, eng, chunks[:1])
    l64 = launch_counts()
    bad = [s for s in range(S_head)
           if heads[s] != stored["heads"]["int64"][s]]
    log(f"[7] (f) int64 index, S={S_head}: {wall:.2f} s for one chunk, "
        f"device s {seen[0]['device_s']:.3f}; shard heads vs the JAX "
        f"package's int64 heads: {len(bad)} differ; launches {l64}")
    if sd.dfi.dtype != torch.int64 or eng.dfi.dtype != torch.int64:
        raise SystemExit("the int64 index was not used")
    if bad or sams != main_sams[:CHUNK] or seen[0]["overflow"]:
        raise SystemExit(f"int64 index: shard heads {bad} differ, or SAM "
                         f"differs from the int32 run's")
    if l64["bsw_meta_dual_kernel"] <= 0 or \
            l64["fm_chain_walk_kernel"] <= 0 or \
            l64["fm_inv_psi_walk_kernel"] <= 0 or \
            min(l64[k] for k in CHAIN_KERNELS) <= 0:
        raise SystemExit(f"int64 index: a kernel of the path was not "
                         f"launched: {l64}")
    out["int64"] = dict(shards=S_head, chunk_s=wall,
                        device_s=seen[0]["device_s"], launches=l64,
                        heads_equal_jax=True)

    # ---- (d) the command line, (e) two processes and merge
    seqs = [bytes(NT4_TO_ASCII[r]).decode() for r in reads_arr]
    k_bases = str(CHUNK * reads_arr.shape[1])
    from compseed_tpu_torch import bench_input
    prefix8 = bench_input.index_prefix(8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_",
                                     dir=os.path.join(ROOT, "build")) as tmp:
        def path(name):
            return os.path.join(tmp, name)

        with open(path("bench.reads"), "w") as f:
            for c in range(N_CHUNKS):
                s0 = (c * CHUNK) % len(seqs)
                f.write("\n".join((seqs[s0:] + seqs[:s0])[:CHUNK]) + "\n")
        rec = run_cli(["mem", "--mesh", "1", "-K", k_bases, "-o",
                       path("m1.sam"), prefix8, path("bench.reads")], [])
        mine = sam_lines(path("m1.sam"))
        if "".join(l for l in mine if not l.startswith("@")) != \
                "".join(main_sams):
            raise SystemExit("cli mem --mesh 1: SAM differs from phase 4's "
                             "stream")
        log(f"[7] (d) cli mem --mesh 1: {rec['wall_s']:.2f} s for the bench "
            f"file, SAM equal to the stream's; launches {rec['launches']}")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["mem", "--mesh", "2", "-K", k_bases, "-o",
                           path("m2.sam"), prefix8, path("bench.reads")])
        n_cards = torch.cuda.device_count()
        log(f"[7] (d) cli mem --mesh 2 on {n_cards} card(s): exit code {rc}: "
            f"{err.getvalue().strip()[-200:]}")
        if n_cards < 2 and (rc != 1 or os.path.exists(path("m2.sam")) or
                            "--mesh 2" not in err.getvalue()):
            raise SystemExit("cli mem --mesh 2 with one card must return 1 "
                             "and write nothing")
        out["cli"] = dict(mesh1_wall_s=rec["wall_s"],
                          mesh1_launches=rec["launches"], mesh2_rc=rc)

        port = free_port()
        t0 = time.time()
        procs = []
        for i in range(2):
            env = dict(os.environ, COMPSEED_COORD=f"localhost:{port}",
                       COMPSEED_NPROCS="2", COMPSEED_PROC_ID=str(i))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "compseed_tpu_torch.cli", "mem", "-v",
                 "1", "-K", k_bases, "-o", path("two.sam"), prefix8,
                 path("bench.reads")], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        if rcs != [0, 0]:
            raise SystemExit(f"two processes returned {rcs}:\n"
                             + "\n".join(x[-2000:] for x in logs))
        shards = sorted(os.listdir(tmp))
        if cli.main(["merge", path("two.sam")]) != 0:
            raise SystemExit("cli merge failed")
        two_s = time.time() - t0
        merged = sam_lines(path("two.sam"))
        log(f"[7] (e) two processes on {dev} ({two_s:.1f} s with merge, "
            f"files {[x for x in shards if 'two' in x]}): merged SAM "
            f"{'equals' if merged == mine else 'DIFFERS FROM'} one process's")
        if merged != mine:
            raise SystemExit("two processes: merged SAM differs from one "
                             "process's")
        out["two_processes"] = dict(wall_s=two_s, rcs=rcs)
    out["phase_s"] = time.time() - t_phase
    log(f"[7] mesh: {out['phase_s']:.1f} s")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scratch-variants", action="store_true")
    ap.add_argument("--old-source")
    ap.add_argument("--fm-old-source")
    ap.add_argument("--chain-old-source", action="append", default=[])
    ap.add_argument("--walk-old-source", action="append", default=[])
    ap.add_argument("--smem-old-source")
    ap.add_argument("--lockstep-old-source")
    ap.add_argument("--entry-old-csrc")
    cli = ap.parse_args()
    if cli.entry_old_csrc and not all(os.path.isfile(os.path.join(
            cli.entry_old_csrc, f)) for f in ENTRY_PARENT_SOURCES.values()):
        ap.error(f"--entry-old-csrc {cli.entry_old_csrc}: not a csrc/ "
                 f"directory with {', '.join(ENTRY_PARENT_SOURCES.values())}")
    for opt_name, src in (("--fm-old-source", cli.fm_old_source),
                          ("--smem-old-source", cli.smem_old_source),
                          ("--lockstep-old-source",
                           cli.lockstep_old_source)):
        if src and not os.path.isfile(src):
            ap.error(f"{opt_name} {src}: no such file")
    for opt_name, srcs in (("--chain-old-source", cli.chain_old_source),
                           ("--walk-old-source", cli.walk_old_source)):
        for src in srcs:
            if not os.path.isfile(src):
                ap.error(f"{opt_name} {src}: no such file")
    # ---- phase 0: device
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this needs a "
            "CUDA card")
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import numpy as np

    from compseed_tpu_torch import bench_input, native
    from compseed_tpu_torch.index.build import build_index
    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import (Read, read_fastq_chunks,
                                             read_reordered_chunks)
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.index.build import unpack_pac
    from compseed_tpu_torch.ops import (bsw, bsw_cuda, chain_cuda, fm_cuda,
                                        lockstep_cases, lockstep_cuda,
                                        smem_cases, smem_cuda, walk_cuda)
    from compseed_tpu_torch.ops.bsw_cases import dual_meta_case
    from compseed_tpu_torch.ops.device_index import pack_pac_words, to_device
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.pipeline.align import align_chunk, align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[0] device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    opt = MemOptions()
    gap = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
               e_ins=opt.e_ins, zdrop=opt.zdrop)
    mat = torch.tensor(np.array(opt.mat, np.int32).reshape(5, 5),
                       device=dev)

    def reset_counts():
        reset_launches()

    def engine_under(env, fm_, seeder_):
        """A DP engine built with ``env`` set (the int16 opt-in is read
        when an engine is built)."""
        os.environ.update(env)
        try:
            return device_engine(opt, fm_, dfi=seeder_.dfi, device=dev)
        finally:
            for k in env:
                del os.environ[k]

    # ---- phase 1: build (both nvcc builds and g++ side by side),
    # self-check
    t0 = time.time()

    def timed_build(build):
        build(force=True)
        return time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=12) as ex:
        host = ex.submit(native.build_library, True)
        fm_build = ex.submit(timed_build, fm_cuda.build_library)
        chain_build = ex.submit(timed_build, chain_cuda.build_library)
        walk_build = ex.submit(timed_build, walk_cuda.build_library)
        smem_build = ex.submit(timed_build, smem_cuda.build_library)
        lockstep_build = ex.submit(timed_build, lockstep_cuda.build_library)
        # the exact rerun kernels' and the lockstep kernels' host loops
        # (g++), for their work counts
        twin = ex.submit(smem_cases.HostTwin)
        ls_twin = ex.submit(lockstep_cases.HostTwin)
        # the parent's collect and forward stage kernels, timed in turns
        # with the port's in phase 4 (--smem-old-source,
        # --lockstep-old-source)
        smem_old = ex.submit(old_build, smem_cuda, cli.smem_old_source)
        ls_old = ex.submit(old_build, lockstep_cuda,
                           cli.lockstep_old_source)
        # the parent's chain, walk and suffix-array entries (--entry-old-csrc)
        entry_parents = {
            what: ex.submit(old_build, module, os.path.join(
                cli.entry_old_csrc, ENTRY_PARENT_SOURCES[what]))
            for what, module in (("chain", chain_cuda), ("walk", walk_cuda),
                                 ("sa", fm_cuda))} if cli.entry_old_csrc \
            else {}
        dp_build_s = timed_build(bsw_cuda.build_library)
        fm_build_s = fm_build.result()
        chain_build_s = chain_build.result()
        walk_build_s = walk_build.result()
        smem_build_s = smem_build.result()
        lockstep_build_s = lockstep_build.result()
        build_s = time.time() - t0
        host.result()
        twin = twin.result()
        ls_twin = ls_twin.result()
        smem_old = smem_old.result()
        ls_old = ls_old.result()
        entry_parents = {k: f.result() for k, f in entry_parents.items()}
    fm_cuda.LIB.load()
    chain_cuda.LIB.load()
    walk_cuda.LIB.load()
    smem_cuda.LIB.load()
    lockstep_cuda.LIB.load()
    # CUPTI traces a CUDA graph's kernels only if it was running when the
    # graph was instantiated: start it before any seeder builds its graphs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    # what the card gives the collect and forward-stage kernels: resident
    # lanes by the occupancy query, ptxas' registers and spills; an
    # earlier build's registers and spills beside them
    occupancy = {}

    def ls_occ(kernel):
        return lambda t, d, lanes: lockstep_cuda.occupancy(kernel, t, d)

    for kernel, module, fn, widths, old in (
            ("smem_collect_kernel", smem_cuda, smem_cuda.occupancy,
             (4096, 16384), smem_old),
            ("smem_strategy_kernel", smem_cuda,
             lambda t, d, lanes: smem_cuda.occupancy(
                 t, d, lanes, "smem_strategy_kernel"), (8192,), smem_old),
            ("walk_stage_entry_kernel", lockstep_cuda,
             ls_occ("walk_stage_entry_kernel"), (589824,), ls_old),
            ("fwd_stage_kernel", lockstep_cuda, ls_occ("fwd_stage_kernel"),
             (65536,), ls_old),
            ("scan_lanes_kernel", lockstep_cuda, ls_occ("scan_lanes_kernel"),
             (16384,), ls_old),
            ("walk_stage_kernel", lockstep_cuda, ls_occ("walk_stage_kernel"),
             (589824,), ls_old)):
        occupancy[kernel] = dict(
            occupancy={f"{dt} at {lanes} lanes": fn(t, dev, lanes)
                       for dt, t in (("int32", torch.int32),
                                     ("int64", torch.int64))
                       for lanes in widths},
            ptxas=kernel_usage(module.LIB.log, kernel),
            old_ptxas=kernel_usage(old["log"], kernel) if old else None)
        log(occupancy_line(kernel, occupancy[kernel]["occupancy"],
                           occupancy[kernel]["ptxas"]) +
            f"; the parent's build: ptxas "
            f"{json.dumps(occupancy[kernel]['old_ptxas'])}")
    log(f"[1] build: DP kernels {dp_build_s:.2f} s, FM kernels "
        f"{fm_build_s:.2f} s, chain kernels {chain_build_s:.2f} s, walk "
        f"kernels {walk_build_s:.2f} s, exact rerun kernels "
        f"{smem_build_s:.2f} s, lockstep kernels {lockstep_build_s:.2f} s, "
        f"with the host tail {time.time() - t0:.2f} s")
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    probe_err = int((bsw_cuda.probe_add_one(x).to(torch.int64)
                     - bsw_cuda._probe_plain(x).to(torch.int64)).abs().max())
    bsw_cuda.self_check(dev)
    torch.cuda.synchronize()
    y = torch.empty_like(x)
    probe_err = max(probe_err, err(bsw_cuda.probe_add_one(x, out=y),
                                   bsw_cuda._probe_plain(x)))

    def probe_k():
        bsw_cuda.probe_add_one(x, out=y)

    def probe_lib():
        torch.add(x, 1, out=y)

    # in turns (kernel, library, library, kernel): the loop reads the
    # host's launch rate, the replayed graph the card's time per launch
    probe = {}
    for name, fn in (("k", probe_k), ("lib", probe_lib), ("lib", probe_lib),
                     ("k", probe_k)):
        probe.setdefault(name + "_loop", []).append(cuda_time_ms(fn, 200))
        probe.setdefault(name + "_graph", []).append(graph_time_ms(fn))
    probe_ms, probe_lib_ms = min(probe["k_loop"]), min(probe["lib_loop"])
    probe_graph_ms = min(probe["k_graph"])
    probe_lib_graph_ms = min(probe["lib_graph"])
    probe_alloc_ms = cuda_time_ms(lambda: bsw_cuda.probe_add_one(x), 200)
    probe_plain_ms = cuda_time_ms(lambda: bsw_cuda._probe_plain(x), 200)
    t0 = time.perf_counter()
    bsw_cuda.self_check(dev)
    self_check_ms = (time.perf_counter() - t0) * 1e3
    log(f"[1] self-check passed: probe max_abs_err {probe_err}; per launch "
        f"in a loop: kernel {probe_ms:.4f} ms (with its own allocation "
        f"{probe_alloc_ms:.4f}), torch.add(out=) {probe_lib_ms:.4f} ms, "
        f"plain x + 1 {probe_plain_ms:.4f} ms; replayed from a CUDA graph: "
        f"kernel {probe_graph_ms:.5f} ms, torch.add {probe_lib_graph_ms:.5f} "
        f"ms; all turns {json.dumps(probe)}; one self_check() "
        f"{self_check_ms:.3f} ms of wall time")
    if probe_err:
        raise SystemExit("probe kernel disagrees with its plain version")
    threads = {f"Q={Q} {'int16' if s16 else 'int32'}":
               bsw_cuda.block_threads(Q, s16)
               for Q in (128, 256, 512, 1024, 2048) for s16 in (False, True)}
    log(f"[1] pairs per block by class (0 = device-memory scratch): "
        f"{json.dumps(threads)}")

    variants = scratch_variants(cli.old_source) if cli.scratch_variants \
        else {}
    fm_builds = fm_walk_builds(cli.fm_old_source)
    log(f"[1] FM walk builds compared in phase 4: {list(fm_builds)}")
    chain_build_set = round_builds(cli.chain_old_source, chain_cuda,
                                   OldChainBuild)
    log(f"[1] chain kernel builds compared in phase 4: "
        f"{list(chain_build_set)}")
    walk_build_set = round_builds(cli.walk_old_source, walk_cuda,
                                  OldWalkBuild)
    log(f"[1] walk kernel builds compared in phase 4: "
        f"{list(walk_build_set)}")
    variant_ms = {}

    # ---- phase 2: kernels vs plain versions, synthetic pairs
    rng = np.random.default_rng(2024)
    errs32, errs16, errsg, errsd32, errsd16 = [], [], [], [], []
    synth = {}
    for T in (128, 256):
        for big_h0 in (True, False):
            q, ql, t, tl, h0, ws = random_pairs(rng, 4096, 128, T, big_h0)
            tiles = (mat,) + tuple(
                torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (q, ql[:, None], t, tl[:, None], h0[:, None],
                          ws[:, None]))
            r = compare(tiles, gap, state16=not big_h0)
            errs32.append(r["err32"])
            errsg.append(r["errg"])
            tag = f"T={T} {'h0 near bound' if big_h0 else 'h0 < 120'}"
            msg = (f"[2] P=4096 Q=128 {tag}: int32 kernel vs plain "
                   f"max_abs_err {r['err32']}, scratch kernel {r['errg']}; "
                   f"kernel {r['k32_ms']:.3f} ms, scratch kernel "
                   f"{r['g32_ms']:.3f} ms, plain {r['p32_ms']:.3f} ms")
            if not big_h0:
                errs16.append(r["err16"])
                msg += (f"; int16 kernel vs plain int16 vs int32 kernel "
                        f"max_abs_err {r['err16']}; kernel "
                        f"{r['k16_ms']:.3f} ms, plain {r['p16_ms']:.3f} ms")
            log(msg)
            synth[tag] = {k: v for k, v in r.items() if k.endswith("_ms")}
            if r["err32"] or r["errg"] or r.get("err16"):
                raise SystemExit(f"a kernel disagrees with its plain "
                                 f"version ({tag})")

    # the long reads' class: its rows do not fit in shared memory, so the
    # wrapper's own choice is the device-memory-scratch kernel
    if bsw_cuda.block_threads(LONG_Q, False) or \
            bsw_cuda.block_threads(LONG_Q, True):
        raise SystemExit(f"Q={LONG_Q} was expected to take the scratch kernel")
    q, ql, t, tl, h0, ws = random_pairs(rng, 512, LONG_Q, LONG_Q, False,
                                        qmax=LONG_LEN)
    tiles = (mat,) + tuple(
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (q, ql[:, None], t, tl[:, None], h0[:, None], ws[:, None]))
    n0 = bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"]
    gm = compare(tiles, gap, state16=True)
    if bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"] - n0 < 20:
        raise SystemExit(f"Q={LONG_Q} did not take the scratch kernel")
    gm["bound_ms"], gm["bound_by"] = dp_bound_ms(tiles, gm["cells"])
    errsg += [gm["err32"], gm["errg"], gm["err16"]]
    log(f"[2] P=512 Q={LONG_Q} T={LONG_Q} (scratch kernel by shape): "
        f"max_abs_err int32 {gm['err32']}, int16 {gm['err16']}; kernel "
        f"{gm['k32_ms']:.3f} / {gm['k16_ms']:.3f} ms, plain "
        f"{gm['p32_ms']:.3f} / {gm['p16_ms']:.3f} ms; {gm['cells']} band "
        f"cells, bound {gm['bound_ms']:.5f} ms by {gm['bound_by']}")
    synth[f"Q={LONG_Q} scratch"] = {k: v for k, v in gm.items()
                                    if k.endswith("_ms")}
    if gm["err32"] or gm["errg"] or gm["err16"]:
        raise SystemExit("the scratch kernel disagrees with its plain "
                         "version")
    if variants:
        variant_ms[f"seeded P=512 Q=T={LONG_Q}"] = time_scratch(
            variants, tiles, gap)
        log(f"[2] scratch kernel builds in turns, ms: "
            f"{json.dumps(variant_ms)}")

    # the fused kernel on seeded pair tables over the bench index
    t0 = time.time()
    fm, reads_arr = bench_input.setup()
    log(f"[2] bench input ready in {time.time() - t0:.1f} s: genome "
        f"{fm.l_pac} bp, {len(reads_arr)} reads, sa_intv {fm.sa_intv}")
    pac_dev = torch.from_numpy(pack_pac_words(fm.pac, fm.l_pac)
                               .astype(np.int64)).to(dev)
    ref_codes = unpack_pac(fm.pac, fm.l_pac)
    for w0, wide in ((100, False), (5, True), (1, False)):
        qarr, meta = dual_meta_case(rng, ref_codes, n=4000, P=4096, Q=128,
                                    T=256, w0=w0, opt=opt, R=512,
                                    wide_r0=wide)
        args = (mat, torch.from_numpy(qarr.reshape(-1)).to(dev), pac_dev,
                torch.from_numpy(meta).to(dev))
        kw = dict(Q=128, T=256, L=qarr.shape[1], l_pac=fm.l_pac, w0=w0,
                  wide_r0=wide, **gap)
        r = compare_dual(args, kw, gap)
        errsd32.append(r["err32"])
        errsd16.append(r["err16"])
        tag = f"fused w0={w0} wide_r0={wide}"
        log(f"[2] P=4096 Q=128 T=256 {tag}: {r['rejected']} lanes rejected "
            f"at round 0 (96 pad lanes), {r['cells']} band cells; max_abs_err "
            f"int32 {r['err32']}, int16 {r['err16']}; kernel "
            f"{r['k32_ms']:.3f} / {r['k16_ms']:.3f} ms, plain "
            f"{r['p32_ms']:.3f} / {r['p16_ms']:.3f} ms")
        synth[tag] = {k: v for k, v in r.items() if k.endswith("_ms")}
        if r["err32"] or r["err16"]:
            raise SystemExit(f"the fused kernel disagrees with its plain "
                             f"version ({tag})")
        if w0 == 5 and not 96 < r["rejected"] < 4096:
            raise SystemExit("the seeded pair table rejected no real lane")

    # a Q = 1024 class through _meta_dual_core: int32 rows do not fit, so
    # it takes the tile route on the scratch kernel (two launches); int16
    # rows fit and take one fused launch
    qarr, meta = dual_meta_case(rng, ref_codes, n=400, P=512, Q=1024,
                                T=1024, w0=100, opt=opt, R=64,
                                read_len=1000)
    args = (mat, torch.from_numpy(qarr.reshape(-1)).to(dev), pac_dev,
            torch.from_numpy(meta).to(dev))
    kw = dict(Q=1024, T=1024, L=qarr.shape[1], l_pac=fm.l_pac, w0=100,
              wide_r0=False, **gap)
    for s16, kernel, n in ((False, "bsw_extend_kernel_gmem", 2),
                           (True, "bsw_meta_dual_kernel_i16", 1)):
        n0 = dict(bsw_cuda.LAUNCHES)
        got = bsw._meta_dual_core(*args, **kw, state16=s16)
        torch.cuda.synchronize()
        if bsw_cuda.LAUNCHES != dict(n0, **{kernel: n0[kernel] + n}):
            raise SystemExit(f"Q=1024 state16={s16}: expected {n} launch(es) "
                             f"of {kernel} alone: {n0} -> {bsw_cuda.LAUNCHES}")
        e = err(got, bsw._meta_dual_plain(*args, **kw, state16=s16))
        (errsd16 if s16 else errsg).append(e)
        log(f"[2] P=512 Q=1024 T=1024 _meta_dual_core, "
            f"{'int16' if s16 else 'int32'} rows: {n} x {kernel}, "
            f"max_abs_err {e}")
        if e:
            raise SystemExit("_meta_dual_core disagrees with its plain "
                             "version at Q=1024")

    # the FM kernels against their plain versions over the bench index,
    # with int32 and with int64 positions
    fm_errs = {}
    for tag, force in (("int32", None), ("int64", np.int64)):
        t0 = time.time()
        e = fm_cases(to_device(fm, dev, force_dtype=force), rng)
        fm_errs[tag] = e
        log(f"[2] FM kernels vs plain versions over the bench index "
            f"({tag} positions, {len(e)} cases, {time.time() - t0:.1f} s): "
            f"max_abs_err {json.dumps(e)}")
        if any(e.values()):
            raise SystemExit(f"an FM kernel disagrees with its plain "
                             f"version ({tag}): "
                             f"{ {k: v for k, v in e.items() if v} }")

    # the chain kernels against their plain steps on the first bench
    # chunk's own rounds (int32 and int64 positions), and each round with
    # slot collisions and a full store
    chain_errs, chain_cases_, walk_errs, walk_cases_, boundaries = \
        chain_phase2(dev, opt, fm, list(reads_arr[:CHUNK]))
    # the round loops as graphs: every call of the chunk against the plain
    # loop, int32 and int64; the loop kernels against their plain version
    t0 = time.time()
    loop_rec = {tag: loop_check(dev, opt, fm, list(reads_arr[:CHUNK]), force)
                for tag, force in (("int32", None), ("int64", np.int64))}
    loop_rec["kernels"] = dict(
        **loop_kernels(chain_cuda, chain_cases_[(1, CHUNK)]),
        **loop_kernels(walk_cuda, walk_cases_[(1, 24 * CHUNK)]))
    log(f"[2] the round loops as graphs against the plain loop, every call "
        f"of the first chunk ({time.time() - t0:.1f} s): "
        f"{json.dumps(loop_rec)}")
    # the segment entry kernels on every boundary of the first chunk,
    # against their plain version, then timed against what they replaced
    t0 = time.time()
    loop_rec["entry"] = entry_check(boundaries, dict(
        chain=chain_build_set, walk=walk_build_set))
    log(f"[2] the segment entry kernels against their plain version on "
        f"every boundary of the first chunk ({time.time() - t0:.1f} s): "
        + json.dumps({k: dict(max_abs_err=r["max_abs_err"],
                              boundaries=r["boundaries"])
                      for k, r in loop_rec["entry"].items()}))
    loop_rec["entry_time"] = entry_time(boundaries["int32"], dict(
        chain=chain_build_set, walk=walk_build_set), entry_parents)
    del boundaries
    # the suffix-array walk's stage entry kernel on every boundary of the
    # first chunk's call and a 40-lane call, against its plain version,
    # then timed against what it replaced; the walk's folded loop test;
    # each seeding call as one graph against the eager _run, every chunk
    t0 = time.time()
    sa_cases_ = sa_capture(dev, opt, fm, list(reads_arr[:CHUNK]))
    sa_rec = dict(check=sa_check(sa_cases_))
    log(f"[2] sa_stage_entry_kernel against its plain version on every "
        f"boundary ({time.time() - t0:.1f} s): max_abs_err "
        f"{sa_rec['check']['max_abs_err']} over "
        f"{sa_rec['check']['boundaries']} boundaries; "
        f"{json.dumps(sa_rec['check'])}")
    sa_rec["time"] = sa_time(sa_cases_["int32"][:4], entry_parents.get("sa"))
    sa_rec["tail"] = sa_tail(sa_cases_["int32"][2])
    del sa_cases_
    # the lockstep kernels on every captured call of all_off's, bwd_win's
    # and fwd_staged's first chunk, int32 and int64
    t0 = time.time()
    ls_cases = {tag: lockstep_capture(dev, opt, fm, list(reads_arr[:CHUNK]),
                                      force)
                for tag, force in (("int32", None), ("int64", np.int64))}
    ls_rec = dict(check=lockstep_check(ls_cases))
    ls_calls = ls_cases["int32"]
    del ls_cases
    log(f"[2] lockstep kernels checked ({time.time() - t0:.1f} s)")
    call_rec = call_graph_check(dev, opt, fm, reads_arr)

    # ---- phase 3: goldens on the card, each file as one chunk
    fm_t = FMIndex.from_built(build_index(
        os.path.join(ROOT, "tests", "fixtures", "tiny.fa")))
    golden_runs = {}
    golden_calls = []       # the goldens' exact rerun calls (smem_cases)
    sa_keys = []            # the goldens' sa_batch calls: (index, positions)
    for name, reader, gold, env in (
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam", {}),
            ("reads.reordered", read_reordered_chunks,
             "golden_compseed_reordered.sam", {}),
            ("reads.fq", read_fastq_chunks, "golden_bwamem.sam",
             {"COMPSEED_BSW_I16": "1"})):
        reads = load_reads(reader, name)
        seeder = device_seeder(opt, fm_t, dedup=True, device=dev)
        engine = engine_under(env, fm_t, seeder)
        dp_kernel = "bsw_extend_kernel_i16" if env else "bsw_extend_kernel"
        name += " (int16 DP state)" if env else ""
        tail = NativeTail(opt, fm_t)
        seen = watch_overflow(seeder)
        done = []
        reset_counts()
        sa_calls = dict(plain=0, loop=0)
        with smem_cases.Capture() as smem_cap, \
                sa_loop_watch(sa_calls, sa_keys):
            align_stream(opt, fm_t, iter([reads]), engine, seeder, tail,
                         on_done=done.extend, stats=SeedingStats())
        launches = launch_counts()
        if sa_calls["plain"] or not sa_calls["loop"]:
            raise SystemExit(f"{name}: the rerun's sa_batch tested its loop "
                             f"on the host, or ran no loop on the card: "
                             f"{sa_calls}")
        if not env:
            golden_calls += smem_cap.calls
        mine = "".join(r.sam for r in done).splitlines(keepends=True)
        want = golden(gold)
        bad = [i for i, (m, g) in enumerate(zip(mine, want)) if m != g]
        log(f"[3] {name}: one chunk of {len(reads)} reads, overflow "
            f"{[s[0] for s in seen]}, {seeder._cap_raises} cap raise(s), "
            f"rerun {seen[0][2]} s, launches {launches}; {len(mine)} "
            f"records vs {gold} ({len(want)}): {len(bad)} differ")
        if not any(s[0] for s in seen) or seeder._cap_raises < 1:
            raise SystemExit(f"{name}: the overflow path was not taken")
        if launches[dp_kernel] <= 0:
            raise SystemExit(f"{name}: the overflow path did not launch "
                             f"{dp_kernel}: {launches}")
        if launches["fm_extend_sel_kernel"] or \
                launches["smem_collect_kernel"] != smem_cap.counts["collect"] \
                or launches["smem_strategy_kernel"] != \
                smem_cap.counts["strategy"] or not all(smem_cap.counts.values()):
            raise SystemExit(f"{name}: the rerun did not run its collect and "
                             f"round-3 calls one smem kernel launch each, or "
                             f"launched the extension kernel: calls "
                             f"{smem_cap.counts}, launches {launches}")
        if len(mine) != len(want) or bad:
            raise SystemExit(f"SAM differs from {gold}: records {bad[:5]}")
        golden_runs[name] = dict(rerun_s=seen[0][2], rerun_split=seen[0][5],
                                 launches=launches,
                                 rerun_calls=smem_cap.counts,
                                 sa_batch_calls=sa_calls)
        log(f"[3] {name}: the rerun's split (BatchSeeder.prof, s) "
            f"{json.dumps(seen[0][5])}")

    # ---- phase 4: the main path at bench size
    CH = CHUNK

    def mk_reads(arr, start):
        # named from 1, as the raw-reads reader names a compressor's output
        return [Read(name=str(start + i + 1), seq=bytes(
            NT4_TO_ASCII[arr[i]]).decode(), qual=None, comment=None)
            for i in range(len(arr))]

    def mk_chunks():
        out = []
        for c in range(N_CHUNKS):
            s0 = (c * CH) % len(reads_arr)
            out.append(mk_reads(
                np.concatenate([reads_arr[s0:], reads_arr[:s0]])[:CH],
                c * CH))
        return out

    n_timed = N_CHUNKS * CH
    captured = []

    def tile_route(*a, **kw):
        """The fused program by the tile route: build_tiles, one launch of
        the DP kernel per band round, the acceptance in PyTorch."""
        return bsw._meta_dual_tiles(bsw_cuda.bsw_extend_tiles, *a, **kw)

    def main_path(tag, seeder, env, dual=None, runs=RUNS):
        """Counts to 0, build the engine, one warm-up stream and ``runs``
        timed ones, read the counts.  ``dual`` replaces the runner's fused
        program for this window.  Returns (record, engine, tail, SAM of
        the last stream's reads)."""
        reset_counts()
        engine = engine_under(env, fm, seeder)
        tail = NativeTail(opt, fm)
        launch = bsw_cuda.bsw_meta_dual
        fused = bsw.bsw_meta_dual

        def capture(*a, **kw):
            if len(captured) < 2:
                captured.append(((a[0], a[1], a[2], a[3].clone()),
                                 {k: v for k, v in kw.items()
                                  if k != "state16"}))
            return launch(*a, **kw)

        bsw_cuda.bsw_meta_dual = capture
        if dual is not None:
            bsw.bsw_meta_dual = dual
        try:
            t0 = time.time()
            align_stream(opt, fm, iter(mk_chunks()), engine, seeder, tail,
                         on_done=lambda _: None, stats=SeedingStats())
            torch.cuda.synchronize()
            log(f"[4] {tag}: warm-up stream {time.time() - t0:.1f} s")
            bsw_cuda.bsw_meta_dual = launch
            return timed_streams(tag, seeder, engine, tail, runs)
        finally:
            bsw_cuda.bsw_meta_dual = launch
            bsw.bsw_meta_dual = fused

    def timed_streams(tag, seeder, engine, tail, runs):
        tail.prof.clear()
        engine.prof.clear()
        rates, seed_s, stats, done = [], [], None, []
        for run in range(runs):
            done = []
            st = SeedingStats()
            t0 = time.time()
            align_stream(opt, fm, iter(mk_chunks()), engine, seeder, tail,
                         on_done=done.extend, stats=st)
            torch.cuda.synchronize()
            dt = time.time() - t0
            if len(done) != n_timed or not all(r.sam for r in done):
                raise SystemExit(f"{tag}: main path lost reads")
            if seeder.last_overflow:
                raise SystemExit(f"{tag}: unexpected cap overflow")
            rates.append(n_timed / dt)
            seed_s.append(seeder.prof.get("device_s", 0.0))
            stats = st
            log(f"[4] {tag} run {run}: {n_timed / dt:.1f} reads/s")
        launches = launch_counts()
        prof = {k: round(v * 1e3, 1) for k, v in tail.prof.items()}
        prof.update({k: round(v * 1e3, 1) for k, v in engine.prof.items()})
        rec = dict(
            reads_per_s=statistics.median(rates), runs=rates,
            engine_call_ms_per_stream=engine.prof.get("engine_call", 0.0)
            * 1e3 / runs,
            bwt_hit_pct=100.0 * (stats.bwt_queries - stats.bwt_calls)
            / max(stats.bwt_queries, 1),
            sal_merged_pct=100.0 * (stats.sal_queries - stats.sal_calls)
            / max(stats.sal_queries, 1),
            bwt_rounds=stats.rounds, seed_run_flat_s_last_chunk=seed_s,
            tail_profile_ms=prof, launches=launches,
            streams=runs + 1, card=smi)
        log(f"[4] {tag}: " + json.dumps(rec))
        return rec, engine, tail, [r.sam for r in done]

    def oracle_check(tag, engine, seeder, tail, ref_sams):
        port_reads = mk_reads(reads_arr[:ORACLE_READS], 0)
        align_chunk(opt, fm, port_reads, 0, engine=engine, seeder=seeder,
                    tail=tail)
        bad = [i for i, (a, b) in enumerate(zip(port_reads, ref_sams))
               if a.sam != b]
        log(f"[4] {tag}: {ORACLE_READS} reads vs host oracle: {len(bad)} "
            f"differ")
        if bad:
            raise SystemExit(f"{tag}: SAM differs from the host oracle: "
                             f"reads {bad[:5]}")

    seeder = device_seeder(opt, fm, dedup=True, device=dev)
    # the plain compaction between segments (what the segment entry
    # kernels replaced, PyTorch's index_put_ and cumsum kernels among its
    # operations) counted over the int32 window: on the main path, whose
    # call graphs its first chunk captures (the profiled chunk replays
    # them), it must not run
    # (and so sa_batch_compact's plain version, what the stage entry
    # kernel replaced)
    from compseed_tpu_torch.ops import fm as main_fm
    from compseed_tpu_torch.ops import seedscan as main_ss
    compactions, compact = [], main_ss._compact_lanes
    sa_plain_calls, sa_plain = [], main_fm._sa_batch_compact_plain

    def counted_compact(*a, **kw):
        compactions.append(a[2])
        return compact(*a, **kw)

    def counted_sa_plain(*a, **kw):
        sa_plain_calls.append(a[1].shape[0])
        return sa_plain(*a, **kw)
    main_ss._compact_lanes = counted_compact
    main_fm._sa_batch_compact_plain = counted_sa_plain
    try:
        rec32, engine32, tail32, sams32 = main_path("int32", seeder, {})
    finally:
        main_ss._compact_lanes = compact
        main_fm._sa_batch_compact_plain = sa_plain
    l32 = rec32["launches"]
    if l32["bsw_meta_dual_kernel"] <= 0 or l32["probe_add_one_kernel"] <= 0 \
            or l32["fm_chain_walk_kernel"] <= 0 \
            or l32["fm_inv_psi_walk_kernel"] <= 0 \
            or min(l32[k] for k in CHAIN_KERNELS + WALK_KERNELS
                   + LOOP_KERNELS + SA_KERNELS) <= 0:
        raise SystemExit(f"int32 main path: a kernel was not launched: {l32}")
    if l32["bsw_meta_dual_kernel_i16"] or l32["bsw_extend_kernel_i16"]:
        raise SystemExit("an int16 kernel ran without COMPSEED_BSW_I16=1")
    if l32["bsw_meta_dual_kernel"] != 8 * (RUNS + 1):
        raise SystemExit(f"int32 main path: expected 8 fused launches per "
                         f"stream: {l32}")
    reuse = (round(rec32["bwt_hit_pct"], 4), round(rec32["sal_merged_pct"], 4))
    if reuse != EXPECT_REUSE:
        raise SystemExit(f"bwt_hit_pct / sal_merged_pct are {reuse}, "
                         f"expected {EXPECT_REUSE}")
    fm_rec, fm_calls = fm_main_path(dev, seeder, list(reads_arr[:CH]), l32)
    fm_rec["redesign"] = fm_redesign(dev, fm_builds, fm_calls, seeder.dfi,
                                     fm)
    del fm_calls
    fm_rec["phase2_max_abs_err"] = fm_errs
    fm_rec["main_launches"] = {k: l32[k] for k in FM_KERNELS}
    prof = fm_rec["profile"]
    chunk_launches = prof["launches"]
    log(f"[4] one {CHUNK}-read chunk: {chunk_launches} host launches "
        f"({prof['cudaGraphLaunch']} of them graphs), "
        f"{prof['cudaStreamSynchronize']} stream syncs, "
        f"{prof['cudaMemcpyAsync']} async copies; the card ran "
        f"{prof['ran_kernels']} kernels and {prof['ran_memsets']} memsets")
    if chunk_launches > MAX_CHUNK_LAUNCHES or \
            prof["cudaStreamSynchronize"] > MAX_CHUNK_SYNCS or \
            prof["cudaMemcpyAsync"] > MAX_CHUNK_COPIES:
        raise SystemExit(f"a chunk's launches / syncs / copies exceed "
                         f"{MAX_CHUNK_LAUNCHES} / {MAX_CHUNK_SYNCS} / "
                         f"{MAX_CHUNK_COPIES}: {prof}")
    fam = prof["ran_by_family"]
    log(f"[4] the chunk's loop entries: {fam['loop_entry']} one-thread loop "
        f"entry kernels, {fam['segment_entry']} segment entry kernels, "
        f"{fam['sa_loop']} suffix-array loop kernels, {fam['sa_stage']} "
        f"suffix-array stage entry kernels; {fam['index_put']} index_put "
        f"and {fam['scan']} scan kernels in all; the plain compaction ran "
        f"{len(compactions)} times and sa_batch_compact's plain version "
        f"{len(sa_plain_calls)} times in the int32 window")
    if fam["loop_entry"] > MAX_LOOP_ENTRY_KERNELS or compactions or \
            not fam["segment_entry"] or fam["sa_loop"] or sa_plain_calls \
            or not fam["sa_stage"]:
        raise SystemExit(f"a chunk ran {fam['loop_entry']} one-thread loop "
                         f"entry kernels (at most {MAX_LOOP_ENTRY_KERNELS}), "
                         f"{fam['segment_entry']} segment entry kernels, "
                         f"{fam['sa_loop']} suffix-array loop kernels (0 "
                         f"allowed), {fam['sa_stage']} stage entry kernels, "
                         f"the PyTorch compaction between segments "
                         f"({len(compactions)} times) or sa_batch_compact's "
                         f"plain version ({len(sa_plain_calls)} times)")
    chain_rec = chain_main_path(seeder, list(reads_arr[:CH]), l32,
                                chain_cases_, chain_build_set)
    chain_rec["segment_rounds"] = seg_rounds = segment_rounds(
        seeder, list(reads_arr[:CH]))
    log(f"[4] kept segment graphs, ms per round on the card (events): "
        f"{json.dumps(seg_rounds)}")
    chain_rec["segment_costs"] = costs = segment_costs(
        seeder, list(reads_arr[:CH]))
    log(f"[4] the loop graphs' host costs over one {CHUNK}-read chunk: "
        f"{json.dumps(costs)}")
    chain_rec["loop"] = loop_rec
    del chain_cases_
    chain_rec["phase2"] = chain_errs
    walk_rec = walk_main_path(l32, walk_cases_, chain_rec["split"], seeder,
                              list(reads_arr[:CH]), walk_build_set)
    del walk_cases_
    walk_rec["phase2"] = walk_errs

    # the host oracle path once; both engines are held to it
    t0 = time.time()
    ref_reads = mk_reads(reads_arr[:ORACLE_READS], 0)
    align_chunk(opt, fm, ref_reads, 0, engine=None, seeder=None,
                tail=NativeTail(opt, fm))
    ref_sams = [r.sam for r in ref_reads]
    log(f"[4] host oracle path, {ORACLE_READS} reads: "
        f"{time.time() - t0:.1f} s")
    oracle_check("int32", engine32, seeder, tail32, ref_sams)

    # (a) the same with int16 DP state
    rec16, engine16, tail16, sams16 = main_path(
        "int16", seeder, {"COMPSEED_BSW_I16": "1"}, runs=1)
    l16 = rec16["launches"]
    if l16["bsw_meta_dual_kernel_i16"] <= 0 or \
            l16["probe_add_one_kernel"] <= 0:
        raise SystemExit(f"int16 main path: a kernel was not launched: {l16}")
    if l16["bsw_meta_dual_kernel"]:
        raise SystemExit(f"int16 main path: the int32 fused kernel ran: {l16}")
    if sams16 != sams32:
        raise SystemExit("SAM differs between int32 and int16 DP state")
    oracle_check("int16", engine16, seeder, tail16, ref_sams)

    # the tile route (what the engine ran before the fused kernel), then
    # int32 once more: the windows are timed in turns (a, b, c, a) so that
    # a drift of the host's launch rate is not read as a gain
    rec_tiles, _, _, sams_tiles = main_path("int32 by the tile route",
                                            seeder, {}, dual=tile_route,
                                            runs=1)
    lt = rec_tiles["launches"]
    if lt["bsw_extend_kernel"] != 16 * 2 or \
            lt["bsw_meta_dual_kernel"]:
        raise SystemExit(f"tile route: expected 16 DP launches per stream "
                         f"and no fused one: {lt}")
    if sams_tiles != sams32:
        raise SystemExit("SAM differs between the fused kernel and the tile "
                         "route")
    rec32b = main_path("int32 again", seeder, {})[0]

    # (c) long reads through the host seeding path and the flat-pair
    # interface: their query-length class (Q = 2048) does not fit in
    # shared memory and takes the device-memory-scratch kernel
    lrng = np.random.default_rng(LONG_SEED)
    both = np.concatenate([ref_codes, 3 - ref_codes[::-1]])
    long_arr = []
    for _ in range(LONG_READS):
        g = int(lrng.integers(0, 2 * fm.l_pac - LONG_LEN))
        seq = both[g:g + LONG_LEN].copy()
        sub = lrng.random(LONG_LEN) < 0.01
        seq[sub] = lrng.integers(0, 4, int(sub.sum()))
        j = int(lrng.integers(200, LONG_LEN - 200))
        long_arr.append(np.concatenate([seq[:j], lrng.integers(0, 4, 3),
                                        seq[j:]]))
    t0 = time.time()
    want_long = mk_reads(long_arr, 0)
    align_chunk(opt, fm, want_long, 0, engine=None, seeder=None,
                tail=NativeTail(opt, fm))
    got_long = mk_reads(long_arr, 0)
    reset_counts()
    align_chunk(opt, fm, got_long, 0, engine=engine32, seeder=None,
                tail=NativeTail(opt, fm))
    torch.cuda.synchronize()
    llong = launch_counts()
    bad = [i for i, (a, b) in enumerate(zip(got_long, want_long))
           if a.sam != b.sam or not a.sam]
    log(f"[4] long reads: {LONG_READS} x {LONG_LEN + 3} bp, host path and "
        f"device DP engine {time.time() - t0:.1f} s, launches {llong}; "
        f"{len(bad)} differ from the host DP")
    if bad:
        raise SystemExit(f"long reads: SAM differs from the host DP: {bad}")
    if llong["bsw_extend_kernel_gmem"] <= 0:
        raise SystemExit(f"long reads: the device-memory-scratch kernel was "
                         f"not launched: {llong}")

    # (b) forced overflow: two chunks on a seeder whose round-1 pool cap
    # is too small for this input
    forced = device_seeder(opt, fm, dedup=True, dfi=seeder.dfi, device=dev)
    forced.GP_F = FORCED_GP_F
    seen = watch_overflow(forced)
    done = []
    reset_counts()
    t0 = time.time()
    with smem_cases.Capture() as forced_cap:    # the rerun's calls
        align_stream(opt, fm, iter(mk_chunks()[:2]), engine32, forced,
                     tail32, on_done=done.extend, stats=SeedingStats())
    torch.cuda.synchronize()
    forced_s = time.time() - t0
    lf = launch_counts()
    if lf["fm_extend_sel_kernel"] or not all(forced_cap.counts.values()) \
            or lf["smem_collect_kernel"] != forced_cap.counts["collect"] or \
            lf["smem_strategy_kernel"] != forced_cap.counts["strategy"]:
        raise SystemExit(f"forced overflow: the rerun did not run its "
                         f"collect and round-3 calls one smem kernel launch "
                         f"each, or launched the extension kernel: calls "
                         f"{forced_cap.counts}, launches {lf}")
    fm_rec["rerun_launches"] = lf["fm_extend_sel_kernel"]
    # the extension kernel's own calls: no path of the seeder launches it
    # (the rerun's collect and round-3 calls are one kernel each, the
    # lockstep scan and walks and fwd_staged's forward stages kernels of
    # their own), so they come from fwd_staged's plain staged forward
    # walk on the card, reached by patching its private route, which
    # extends each step by it
    fwd_route = main_ss._fwd_route
    with engine_env({"COMPSEED_FWD_MEMO": "0"}):
        staged = DeviceSeeder(opt, fm, dev, dfi=seeder.dfi, dedup=True)
        reset_counts()
        main_ss._fwd_route = lambda dev_: main_ss._fwd_stage_walk_plain
        try:
            with FmCapture() as ext_cap:
                staged.run_flat(list(reads_arr[:CH]))
        finally:
            main_ss._fwd_route = fwd_route
    torch.cuda.synchronize()
    fm_rec["ext_launches"] = launch_counts()["fm_extend_sel_kernel"]
    if launch_counts()["fwd_stage_kernel"]:
        raise SystemExit("the plain staged walk's run launched the forward "
                         "stage kernel")
    del staged
    if fm_rec["ext_launches"] <= 0:
        raise SystemExit("fwd_staged's plain staged walk launched no "
                         "extension kernel")
    fm_rec["extend_sel"] = {}
    ext_calls = {}
    for key, call in ext_cap.calls.items():
        if key[0] != "extend_sel_batch":
            continue
        r = fm_measure(key, call)
        fm_rec["extend_sel"][f"rank{key[1]}"] = r
        ext_calls[f"rank{key[1]}"] = (key, call)
        log(f"[4] fwd_staged's plain walk's extension {r['shape']}: "
            f"fm_extend_sel_kernel "
            f"max_abs_err {r['max_abs_err']}, {r['ms']:.4f} ms in a loop, "
            f"{r['graph_ms']:.5f} ms replayed from a graph (plain "
            f"{r['plain_ms']:.3f}); {r['words']} occ words, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}")
        if r["max_abs_err"]:
            raise SystemExit("fm_extend_sel_kernel disagrees with its plain "
                             "version on fwd_staged's lanes")
    fm_rec["extend_turns"] = fm_turns(fm_builds, ext_calls)
    free_builds(fm_builds)
    del ext_calls
    log(f"[4] fwd_staged's plain walk's extensions by build in turns: "
        f"{json.dumps(fm_rec['extend_turns'])}")
    log(f"[4] forced overflow (GP_F={FORCED_GP_F}): per chunk (overflow, "
        f"GP_F after, rerun s) = {seen}; both chunks {forced_s:.1f} s; "
        f"launches {lf}")
    if lf["bsw_extend_kernel"] <= 0:
        raise SystemExit(f"forced overflow: the DP kernel was not "
                         f"launched: {lf}")
    if len(seen) != 2 or not seen[0][0] or seen[1][0]:
        raise SystemExit("forced overflow: chunk 1 must overflow and "
                         "chunk 2 must not")
    if seen[0][1] != 2 * FORCED_GP_F:
        raise SystemExit(f"forced overflow: GP_F is {seen[0][1]}, expected "
                         f"{2 * FORCED_GP_F}")
    if [r.sam for r in done] != sams32[:2 * CH]:
        raise SystemExit("forced overflow: SAM differs from the unforced "
                         "run's")
    forced_rec = dict(gp_f=FORCED_GP_F, gp_f_after=seen[0][1],
                      rerun_s=seen[0][2], rerun_split=seen[0][5],
                      rerun_calls=forced_cap.counts, reads_per_chunk=CH,
                      both_chunks_s=forced_s, launches=lf,
                      goldens=golden_runs)
    log(f"[4] forced overflow: the rerun's split (BatchSeeder.prof, s) "
        f"{json.dumps(seen[0][5])}, calls {forced_cap.counts}")

    # the exact rerun's kernels: every captured call of the goldens' and
    # the forced overflow's reruns against its plain version, int32 and
    # int64; each forced-overflow call timed beside its bound and floor
    t0 = time.time()
    smem_rec = dict(launches={k: lf[k] for k in SMEM_KERNELS}, check=dict(
        goldens=smem_check("goldens", golden_calls,
                           to_device(fm_t, dev, force_dtype=np.int64)),
        forced=smem_check("forced overflow", forced_cap.calls,
                          to_device(fm, dev, force_dtype=np.int64))))
    del golden_calls
    # the card's dependent 16-byte load from L2 (a table of cell A's occ
    # table's bytes) and from device memory (a 2^30-base genome's): the
    # floor of a chain of dependent row reads
    smem_rec["load_latency"] = load_latency(dev, {
        "l2": seeder.dfi.occ_packed.numel() * 4,
        "hbm": ((LARGE_BASES >> 7) + 1) * 64})
    load_ms = smem_rec["load_latency"]["l2"]["ms"]
    smem_rec["time"] = smem_time(
        forced_cap.calls, twin,
        fm_rec["redesign"]["bench_latency"]["new"]["chain_step_ms"],
        old=smem_old, load_ms=load_ms)
    smem_rec["occupancy"] = occupancy["smem_collect_kernel"]
    smem_rec["strategy_occupancy"] = occupancy["smem_strategy_kernel"]
    del forced_cap
    smem_rec["phase_s"] = time.time() - t0
    log(f"[smem] the exact rerun's kernels: {smem_rec['phase_s']:.1f} s")
    # the lockstep kernels: each captured call of all_off's, bwd_win's and
    # fwd_staged's first chunk timed beside its bound and floor; cell A's
    # stream under COMPSEED_FWD_MEMO=0; sa_batch's loop graph against the
    # host-tested loop on the goldens' rerun calls
    t0 = time.time()
    ls_rec["time"] = lockstep_time(
        ls_calls, ls_twin,
        fm_rec["redesign"]["bench_latency"]["new"]["chain_step_ms"],
        old=ls_old, load_ms=load_ms)
    ls_rec["occupancy"] = {k: occupancy[k] for k in (
        "fwd_stage_kernel", "scan_lanes_kernel", "walk_stage_kernel",
        "walk_stage_entry_kernel")}
    del ls_calls
    ls_rec["sa_batch_turns"] = sa_batch_turns(sa_keys)
    del sa_keys
    ls_rec["phase_s"] = time.time() - t0
    log(f"[lockstep] timed: {ls_rec['phase_s']:.1f} s")
    ls_rec["fwd_stream"] = fwd_stream(opt, fm, seeder.dfi, dev, engine32,
                                      tail32, mk_chunks(), sams32)

    # the main path's own pair tables through every kernel and every
    # plain version
    cap = capd = None
    for args, kw in captured:
        d = compare_dual(args, kw, gap)
        tiles = d.pop("tiles")
        r = compare(tiles, gap, state16=True)
        errsd32.append(d["err32"])
        errsd16.append(d["err16"])
        errs32.append(r["err32"])
        errs16.append(r["err16"])
        errsg.append(r["errg"])
        P, Q = tiles[1].shape
        r["bound_ms"], r["bound_by"] = dp_bound_ms(tiles, r["cells"])
        d["bound_ms"], d["bound_by"] = dual_bound_ms(args[3], d["cells"])
        # the engine's call by both routes, host and card time together,
        # in turns (tiles, fused, fused, tiles)
        wall = {}
        for name, fn in (("tiles", tile_route), ("fused", bsw.bsw_meta_dual),
                         ("fused", bsw.bsw_meta_dual), ("tiles", tile_route)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(*args, **kw)
            torch.cuda.synchronize()
            wall.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3 / 5)
        d["call_wall_ms"] = wall
        log(f"[4] captured pair table P={P} Q={Q} T={tiles[3].shape[1]} "
            f"w0={kw['w0']}: fused kernel max_abs_err int32 {d['err32']}, "
            f"int16 {d['err16']}; {d['k32_ms']:.3f} / {d['k16_ms']:.3f} ms "
            f"(plain {d['p32_ms']:.3f} / {d['p16_ms']:.3f}); "
            f"{d['rejected']} lanes to round 1, {d['cells']} band cells in "
            f"both rounds, bound {d['bound_ms']:.5f} ms by {d['bound_by']}; "
            f"one engine call, wall ms: {json.dumps(wall)}")
        log(f"[4] its tiles at round 0: DP kernel max_abs_err int32 "
            f"{r['err32']}, int16 {r['err16']}, scratch {r['errg']}; int32 "
            f"{r['k32_ms']:.3f} ms (scratch kernel {r['g32_ms']:.3f}, plain "
            f"{r['p32_ms']:.3f}), int16 {r['k16_ms']:.3f} ms (plain "
            f"{r['p16_ms']:.3f}); {r['cells']} band cells, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}")
        if d["err32"] or d["err16"] or r["err32"] or r["err16"] or r["errg"]:
            raise SystemExit("a kernel disagrees with its plain version on "
                             "the main path's pairs")
        if variants:
            variant_ms[f"captured P={P} Q={Q}"] = time_scratch(
                variants, tiles, gap)
            log(f"[4] scratch kernel builds in turns, ms: "
                f"{json.dumps(variant_ms)}")
        cap, capd = cap or r, capd or d
    if cap is None:
        raise SystemExit("no pair table was captured from the main path")

    # ---- phase 5: the command line
    cli_rec = phase_cli(dev, smi, fm, reads_arr, sams32, rec32)

    # ---- phase 6: the seeding engines
    t0 = time.time()
    eng_rec = phase_engines(dev, smi, opt, fm, fm_t, reads_arr, seeder.dfi,
                            engine32, tail32, mk_chunks(), sams32)
    eng_rec["phase_s"] = time.time() - t0
    log(f"[6] engines: {eng_rec['phase_s']:.1f} s")

    # ---- phase 7: the sharded path on this card
    mesh_rec = phase_mesh(dev, smi, opt, fm, reads_arr, seeder.dfi,
                          mk_chunks(), sams32)

    fm_rec["sa_loop_tail"] = sa_rec["tail"]
    probe_bytes = 2 * 8 * 128 * 4
    probe_bound = max(probe_bytes / HBM_BYTES_PER_S,
                      8 * 128 / INT32_OPS_PER_S) * 1e3
    print(json.dumps({"build_s": build_s, "dp_build_s": dp_build_s,
                      "fm_build_s": fm_build_s,
                      "chain_build_s": chain_build_s,
                      "walk_build_s": walk_build_s,
                      "smem_build_s": smem_build_s, "smem": smem_rec,
                      "lockstep_build_s": lockstep_build_s,
                      "lockstep": ls_rec,
                      "fm": fm_rec,
                      "chain": chain_rec, "walk": walk_rec,
                      "synthetic_ms": synth,
                      "self_check_ms": self_check_ms, "main": rec32,
                      "main_int16": rec16, "main_tile_route": rec_tiles,
                      "main_again": rec32b, "forced_overflow": forced_rec,
                      "long_reads_launches": llong,
                      "probe_turns_ms": probe,
                      "call_graph": call_rec, "sa_stages": sa_rec,
                      "captured_fused": capd, "captured_tiles": cap,
                      "block_threads": threads,
                      "scratch_variants_ms": variant_ms}))
    print(json.dumps({"cli": cli_rec}))
    print(json.dumps({"engines": eng_rec}))
    print(json.dumps({"mesh": mesh_rec}))

    def row(name, replaces, launches, errs, ms, plain_ms, bound,
            source=KERNEL_SOURCE, **more):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=errs,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                    bound_by=bound["bound_by"],
                    library_ms=more.pop("library_ms", None),
                    cli_launches=cli_rec["launches"][name],
                    a2_launches=eng_rec["a2"]["launches"][name],
                    mesh_launches=mesh_rec["launches"][name], **more)

    probe_row = dict(bound_ms=probe_bound, bound_by="bytes")
    print(json.dumps({"kernels": [
        # launches: forced-overflow run (flat-pair interface after a rerun)
        row("bsw_extend_kernel", "compseed_tpu/ops/bsw_pallas.py:96",
            lf["bsw_extend_kernel"], max(errs32), cap["k32_ms"],
            cap["p32_ms"], cap),
        # launches: reads.fq as one chunk under COMPSEED_BSW_I16=1
        row("bsw_extend_kernel_i16",
            "compseed_tpu/ops/bsw_pallas.py:96 (state16)",
            golden_runs["reads.fq (int16 DP state)"]["launches"]
            ["bsw_extend_kernel_i16"], max(errs16), cap["k16_ms"],
            cap["p16_ms"], cap),
        # launches: the long reads' Q = 2048 class; times on seeded pairs
        # of that class
        row("bsw_extend_kernel_gmem",
            "compseed_tpu/ops/bsw_pallas.py:96 (query-length classes "
            "beyond shared memory)", llong["bsw_extend_kernel_gmem"],
            max(errsg), gm["k32_ms"], gm["p32_ms"], gm),
        # launches: the int32 and the int16 window of the main path
        row("bsw_meta_dual_kernel", "compseed_tpu/ops/bsw.py:234",
            l32["bsw_meta_dual_kernel"], max(errsd32), capd["k32_ms"],
            capd["p32_ms"], capd),
        row("bsw_meta_dual_kernel_i16",
            "compseed_tpu/ops/bsw.py:234 (state16)",
            l16["bsw_meta_dual_kernel_i16"], max(errsd16), capd["k16_ms"],
            capd["p16_ms"], capd),
        row("probe_add_one_kernel", "compseed_tpu/ops/bsw.py:310",
            l32["probe_add_one_kernel"], probe_err, probe_ms, probe_plain_ms,
            probe_row, library_ms=probe_lib_ms, graph_ms=probe_graph_ms,
            library_graph_ms=probe_lib_graph_ms)] + fm_rows(fm_rec, row)
        + chain_rows(dict(chain_rec, tail_check=loop_rec["kernels"][
            "chain_apply_kernel tail"]), l32, row,
            fm_rec["profile"]["kernels"])
        + walk_rows(dict(walk_rec, tail_check=loop_rec["kernels"][
            "walk_apply_kernel tail"]), l32, row,
            fm_rec["profile"]["kernels"])
        + loop_rows(loop_rec, l32, row, fm_rec["profile"]["kernels"])
        + sa_rows(sa_rec, l32, row, fm_rec["profile"]["kernels"])
        + smem_rows(smem_rec, row)
        + lockstep_rows(dict(ls_rec, launches=eng_rec["full_width"][
            "all_off"]["lockstep_launches"], fwd_launches=eng_rec[
            "full_width"]["fwd_staged"]["lockstep_launches"][
            "fwd_stage_kernel"]), row)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
