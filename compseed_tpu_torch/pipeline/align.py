"""End-to-end batch alignment.

Equivalent of seed_and_extend + mem_process_seqs
(mapping/comp_seed.cpp:2242-2560): per compressive batch (BATCH_SIZE reads)
run seeding, merged SAL, chaining/filtering, batched extension and
finalization, producing one SAM string per read.

Engines:
  * ``oracle`` — everything scalar on host (the parity reference).
  * ``device`` — seeding/SAL/extension on the card (compseed_tpu_torch.ops), host tail.
"""

from __future__ import annotations

import numpy as np

from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.io.fastq import Read
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.pipeline import chain as chain_mod
from compseed_tpu_torch.pipeline import extension, finalize, seeding
from compseed_tpu_torch.utils import NT4_TABLE


def encode_read(seq: str) -> np.ndarray:
    return NT4_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)].copy()


def encode_reads(reads: list[Read]) -> list[np.ndarray]:
    """Vectorized batch encode: one table lookup over the concatenated
    chunk instead of a per-read Python loop (a 16k-read chunk costs
    ~15 ms here vs ~200 ms looped — host time the device idles on)."""
    if not reads:
        return []
    buf = "".join(r.seq for r in reads).encode()
    flat = NT4_TABLE[np.frombuffer(buf, dtype=np.uint8)]
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r.seq) for r in reads], out=off[1:])
    return [flat[off[i]: off[i + 1]] for i in range(len(reads))]


def align_batch(opt: MemOptions, fm: FMIndex, reads: list[Read],
                n_processed: int, engine=None,
                stats: seeding.SeedingStats | None = None,
                seeder=None, tail=None, rg_id: str = "",
                pes_override=None, paired: bool | None = None) -> None:
    """Align reads[start:end] in place (fills .sam). ``n_processed`` is the
    global index of reads[0] (hash tie-breaking depends on it)."""
    if engine is None:
        engine = extension.oracle_engine(opt)
    queries = encode_reads(reads)
    if paired is None:
        paired = bool(opt.flag & 0x2)  # MEM_F_PE

    # fast path: flat seeder output straight into the native tail
    if seeder is not None and tail is not None and \
            hasattr(seeder, "run_flat"):
        lrep, sflat, soff = seeder.run_flat(queries, stats)
        if hasattr(engine, "set_query_context"):
            qd = getattr(seeder, "last_qd", None)
            engine.set_query_context(qd, getattr(seeder, "last_L", 0),
                                     getattr(seeder, "last_row_map", None))
        sams = tail.run_batch_flat(
            queries, lrep, sflat, soff, engine, n_processed,
            [r.name for r in reads], [r.qual for r in reads],
            [r.comment for r in reads], rg_id, paired=paired,
            pes_override=pes_override)
        for r, sam in zip(reads, sams):
            r.sam = sam
        return

    # --- seeding + merged SAL (comp_seed.cpp:2262-2347)
    if seeder is not None:
        per_read = seeder(fm, opt, queries, stats)
        matches_per_read = [m for m, _ in per_read]
        seeds_per_read = [s for _, s in per_read]
    else:
        matches_per_read = [seeding.collect_matches(fm, opt, q, stats)
                            for q in queries]
        seeds_per_read = [seeding.sample_seeds(opt, m)
                          for m in matches_per_read]
        seeding.resolve_sal(fm, seeds_per_read, stats)

    if tail is not None:  # native host tail (csrc/compseed_host.cpp)
        sams = tail.run_batch(
            queries, matches_per_read, seeds_per_read, engine, n_processed,
            [r.name for r in reads], [r.qual for r in reads],
            [r.comment for r in reads], rg_id, paired=paired)
        for r, sam in zip(reads, sams):
            r.sam = sam
        return

    # --- chaining + filtering (comp_seed.cpp:2356-2370)
    chains_per_read = []
    for q, matches, seeds in zip(queries, matches_per_read, seeds_per_read):
        chains = chain_mod.mem_chain(opt, fm, len(q), matches, seeds)
        chains = chain_mod.mem_chain_flt(opt, chains)
        chain_mod.mem_flt_chained_seeds(opt, fm, len(q), q, chains)
        chains_per_read.append(chains)

    # --- batched banded-SW extension (comp_seed.cpp:2372-2375)
    regs_per_read = extension.extend_batch(opt, fm, queries, chains_per_read,
                                           engine)

    # --- finalization (comp_seed.cpp:2377-2415)
    for r, (read, q, regs) in enumerate(zip(reads, queries, regs_per_read)):
        regs = [x for x in regs if x.qe > x.qb]
        regs = finalize.mem_sort_dedup_patch(opt, fm, q, regs)
        for p in regs:
            if p.rid >= 0 and fm.bns.anns[p.rid].is_alt:
                p.is_alt = 1
        finalize.mem_mark_primary_se(opt, regs, n_processed + r)
        if opt.flag & 0x800:  # MEM_F_PRIMARY5
            finalize.mem_reorder_primary5(opt.T, regs)
        read.sam = finalize.mem_reg2sam(opt, fm, read.name, q, read.qual,
                                        read.comment, regs, rg_id=rg_id)


def align_chunk(opt: MemOptions, fm: FMIndex, reads: list[Read],
                n_processed: int, engine=None,
                stats: seeding.SeedingStats | None = None,
                seeder=None, tail=None, rg_id: str = "",
                pes_override=None, paired: bool | None = None) -> None:
    """Process one -K chunk.

    With the device seeder and native tail, the whole chunk runs as one
    batch (device kernels and DP batches span the chunk; there is no
    cross-read state, so the reference's 512-read grouping is purely a
    locality knob).  Otherwise fall back to per-BATCH_SIZE groups.
    """
    if tail is not None:
        # one batch per chunk: PE insert-size inference (mem_pestat) runs
        # over the whole chunk exactly like mem_process_seqs
        align_batch(opt, fm, reads, n_processed, engine, stats, seeder,
                    tail, rg_id, pes_override=pes_override, paired=paired)
        return
    bs = opt.batch_size
    for start in range(0, len(reads), bs):
        batch = reads[start: start + bs]
        align_batch(opt, fm, batch, n_processed + start, engine, stats,
                    seeder, tail, rg_id, paired=paired)


def bseq_classify(reads: list[Read]) -> tuple[list[Read], list[Read]]:
    """Split a mixed batch into (single-end, paired-end) groups: two
    adjacent reads with the same (readno-trimmed) name form a pair
    (bseq_classify, bwalib/bwa.c:113-129)."""
    se: list[Read] = []
    pe: list[Read] = []
    has_last = True
    n = len(reads)
    for i in range(1, n):
        if has_last:
            if reads[i].name == reads[i - 1].name:
                pe.append(reads[i - 1])
                pe.append(reads[i])
                has_last = False
            else:
                se.append(reads[i - 1])
        else:
            has_last = True
    if has_last and n:
        se.append(reads[n - 1])
    return se, pe


def align_chunk_smart(opt: MemOptions, fm: FMIndex, reads: list[Read],
                      n_processed: int, engine=None, stats=None,
                      seeder=None, tail=None, rg_id: str = "",
                      pes_override=None, verbose: int = 3) -> None:
    """MEM_F_SMARTPE (-p) chunk processing: classify interleaved/mixed
    input into SE and PE groups and align each with the right pairing
    mode — fastmap.c:107-127.  The SE group is processed first at
    ``n_processed`` and the PE group at ``n_processed + n_se`` so the
    hash_64(id) tie-breaks match the reference exactly."""
    import sys

    se, pe = bseq_classify(reads)
    if verbose >= 3:
        print(f"[M::align_chunk_smart] {len(se)} single-end sequences; "
              f"{len(pe)} paired-end sequences", file=sys.stderr)
    if se:
        align_chunk(opt, fm, se, n_processed, engine, stats, seeder, tail,
                    rg_id, paired=False)
    if pe:
        align_chunk(opt, fm, pe, n_processed + len(se), engine, stats,
                    seeder, tail, rg_id, pes_override=pes_override,
                    paired=True)


def align_stream(opt: MemOptions, fm: FMIndex, chunk_iter, engine, seeder,
                 tail, on_done, stats=None, rg_id: str = "",
                 pes_override=None, n_processed: int = 0) -> int:
    """Overlapped chunk pipeline: while the host tail (chaining, DP
    acceptance, SAM) finishes chunk k, the device seeds chunk k+1 — the
    kt_pipeline compute overlap (cstl/kthread.c:121-149) across the
    host/device boundary.  on_done(chunk) is called in order.

    Returns the total number of reads processed."""
    import collections
    import concurrent.futures as cf
    import os

    paired = bool(opt.flag & 0x2)
    # pipeline depth: how many chunks may be seeding ahead of the tail.
    # Depth 2 keeps the device FIFO non-empty while the host runs
    # finalize/SAM/encode between chunks — at depth 1 the device idled
    # ~0.5 s per chunk waiting for the next seeding submission (measured
    # r4: engine_fetch showed the queue draining).  The seed worker is
    # one thread, so only one seeding's device intermediates are live at
    # a time; the extra cost is one more read-matrix snapshot.
    depth = max(1, int(os.environ.get("COMPSEED_PIPE_DEPTH", "2")))

    def seed(reads):
        queries = encode_reads(reads)
        out = seeder.run_flat(queries, stats)
        # snapshot the device read matrix before the next chunk's seeding
        # overwrites it (the engine slices pair sequences from it)
        ctx = (getattr(seeder, "last_qd", None),
               getattr(seeder, "last_L", 0),
               getattr(seeder, "last_row_map", None))
        return queries, out, ctx

    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        pending = collections.deque()   # (reads, future, base)
        total = 0
        for chunk in chunk_iter:
            fut = ex.submit(seed, chunk)
            base = n_processed + total
            total += len(chunk)
            if len(pending) >= depth:
                _drain(opt, engine, tail, pending.popleft(), paired,
                       pes_override, rg_id, on_done)
            pending.append((chunk, fut, base))
        while pending:
            _drain(opt, engine, tail, pending.popleft(), paired,
                   pes_override, rg_id, on_done)
    return total


def _drain(opt, engine, tail, pending, paired, pes_override, rg_id,
           on_done):
    reads, fut, base = pending
    queries, (lrep, sflat, soff), (qd, L, row_map) = fut.result()
    if hasattr(engine, "set_query_context"):
        engine.set_query_context(qd, L, row_map)
    sams = tail.run_batch_flat(
        queries, lrep, sflat, soff, engine, base,
        [r.name for r in reads], [r.qual for r in reads],
        [r.comment for r in reads], rg_id, paired=paired,
        pes_override=pes_override)
    for r, sam in zip(reads, sams):
        r.sam = sam
    on_done(reads)
