"""Command-line interface.

``compseed-tpu index``  — build the FM-index (bwaidx equivalent,
                          FM_index/index_main.c:211-255).
``compseed-tpu mem``    — align reads (CompSeed main.cpp:216-456); accepts
                          FASTQ or compressor-reordered raw reads (sniffed
                          by leading '@', main.cpp:399-406) and the full
                          BWA-MEM flag surface.

``mem`` runs on ``--device cuda`` with ``--engine device`` unless told
otherwise: seeding, SAL and the banded-SW extension on the card, the
native tail on the host.  ``--device cpu`` runs the same device programs
on the CPU, ``--engine oracle`` the scalar host path.  A card that is
missing or a kernel that does not build or launch ends the run with an
error; nothing carries on with another device or engine.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

from compseed_tpu_torch import options as opts
from compseed_tpu_torch.index.build import build_index
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.index.io import save_index
from compseed_tpu_torch.io.fastq import (read_fastq_chunks, read_reordered_chunks,
                                   sniff_open)
from compseed_tpu_torch.io.sam import sam_header
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.pipeline.align import align_chunk
from compseed_tpu_torch.pipeline.seeding import SeedingStats


def cmd_index(argv: list[str]) -> int:
    """bwaidx CLI surface (FM_index/index_main.c:211-255).  -a and -b
    are accepted for compatibility: every algorithm choice maps to the
    one 64-bit SA-IS build (csrc/sais.cpp), which produces the
    byte-identical index at every genome size (verified against the
    reference's bwtsw path at 200 Mbp, scripts/scale_check.py)."""
    ap = argparse.ArgumentParser(prog="compseed-tpu index")
    ap.add_argument("fasta")
    ap.add_argument("-p", "--prefix", default=None)
    ap.add_argument("-a", choices=["is", "bwtsw", "rb2", "auto"],
                    default="auto", dest="algo",
                    help="accepted for bwaidx compatibility; all map to "
                         "the 64-bit SA-IS build (same output bytes)")
    ap.add_argument("-b", default=None, dest="block_size",
                    help="bwtsw block size; ignored (no incremental "
                         "construction is needed)")
    ap.add_argument("-6", action="store_true", dest="name64",
                    help="name index files <fasta>.64.*")
    args = ap.parse_args(argv)
    prefix = args.prefix or (args.fasta + ".64" if args.name64
                             else args.fasta)
    if args.algo != "auto" or args.block_size is not None:
        print(f"[index] -a {args.algo}: the 64-bit SA-IS build covers "
              "every genome size; output bytes are identical",
              file=sys.stderr)
    t = time.time()
    built = build_index(args.fasta)
    save_index(prefix, built)
    print(f"[index] built {prefix} ({built.seq_len} bp doubled) "
          f"in {time.time() - t:.1f}s", file=sys.stderr)
    return 0


def _parse_pair(s: str) -> tuple[int, int]:
    parts = s.replace(";", ",").split(",")
    a = int(parts[0])
    b = int(parts[1]) if len(parts) > 1 else a
    return a, b


def _check_sa_intv(args, shm_name: str) -> int:
    """Validate --sa-intv against the interval of the index that ``mem``
    is about to load, read from the staged copy's metadata or the .sa
    header alone.  Returns the interval to densify to, 0 when the flag is
    absent or ignored (with a warning), -1 after printing an error."""
    new = args.sa_intv
    if not new:
        return 0
    from compseed_tpu_torch.index import shm as shm_mod
    if shm_mod.shm_available(shm_name):
        old = int(shm_mod.shm_load(shm_name).sa_intv)    # memory maps only
    else:
        import numpy as _np
        with open(args.index_prefix + ".sa", "rb") as f:
            old = int(_np.frombuffer(f.read(56), dtype="<u8")[5])
    if new < 0 or new & (new - 1) or (new < old and old % new):
        print(f"[E::mem] --sa-intv {new}: must be a power of two that "
              f"divides the index's suffix-array interval {old}",
              file=sys.stderr)
        return -1
    if new >= old:
        print(f"[W::mem] --sa-intv {new} is ignored: it is not smaller "
              f"than the index's suffix-array interval {old}",
              file=sys.stderr)
        return 0
    if args.engine != "device":
        print(f"[W::mem] --sa-intv {new} is ignored: it applies to "
              f"--engine device, not --engine {args.engine}",
              file=sys.stderr)
        return 0
    return new


def cmd_mem(argv: list[str]) -> int:
    # -h is BWA-MEM's XA-hits cap, so argparse's default help is disabled
    ap = argparse.ArgumentParser(prog="compseed-tpu mem", add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("index_prefix")
    ap.add_argument("reads")
    ap.add_argument("reads2", nargs="?", default=None)
    ap.add_argument("-t", type=int, default=1, dest="n_threads")
    ap.add_argument("-k", type=int, default=None, dest="min_seed_len")
    ap.add_argument("-w", type=int, default=None, dest="band_width")
    ap.add_argument("-d", type=int, default=None, dest="zdrop")
    ap.add_argument("-r", type=float, default=None, dest="split_factor")
    ap.add_argument("-y", type=int, default=None, dest="max_mem_intv")
    ap.add_argument("-c", type=int, default=None, dest="max_occ")
    ap.add_argument("-D", type=float, default=None, dest="drop_ratio")
    ap.add_argument("-W", type=int, default=None, dest="min_chain_weight")
    ap.add_argument("-s", type=int, default=None, dest="split_width")
    ap.add_argument("-G", type=int, default=None, dest="max_chain_gap")
    ap.add_argument("-N", type=int, default=None, dest="max_chain_extend")
    ap.add_argument("-A", type=int, default=None, dest="match_score")
    ap.add_argument("-B", type=int, default=None, dest="mismatch")
    ap.add_argument("-O", type=str, default=None, dest="gap_open")
    ap.add_argument("-E", type=str, default=None, dest="gap_ext")
    ap.add_argument("-L", type=str, default=None, dest="clip_pen")
    ap.add_argument("-U", type=int, default=None, dest="pen_unpaired")
    ap.add_argument("-T", type=int, default=None, dest="score_T")
    ap.add_argument("-h", type=str, default=None, dest="xa_hits")
    ap.add_argument("-Q", type=float, default=None, dest="mapq_coef_len")
    ap.add_argument("-X", type=float, default=None, dest="mask_level")
    ap.add_argument("-x", type=str, default=None, dest="preset")
    ap.add_argument("-K", type=int, default=None, dest="chunk_bases")
    ap.add_argument("-R", type=str, default=None, dest="rg_line")
    ap.add_argument("-H", type=str, default=None, dest="hdr_line")
    ap.add_argument("-o", type=str, default=None, dest="output")
    ap.add_argument("-f", type=str, default=None, dest="output_f",
                    help="alias of -o (fastmap.c:259-260)")
    ap.add_argument("-m", type=int, default=None, dest="max_matesw")
    ap.add_argument("-1", action="store_true", dest="single_io",
                    help="disable the reader/writer IO threads")
    ap.add_argument("-a", action="store_true", dest="all_aln")
    ap.add_argument("-C", action="store_true", dest="copy_comment")
    ap.add_argument("-V", action="store_true", dest="ref_hdr")
    ap.add_argument("-Y", action="store_true", dest="softclip")
    ap.add_argument("-M", action="store_true", dest="no_multi")
    ap.add_argument("-j", action="store_true", dest="ignore_alt")
    ap.add_argument("-5", action="store_true", dest="primary5")
    ap.add_argument("-q", action="store_true", dest="keep_supp_mapq")
    ap.add_argument("-p", action="store_true", dest="smart_pe")
    ap.add_argument("-S", action="store_true", dest="skip_pairing")
    ap.add_argument("-P", action="store_true", dest="no_rescue")
    ap.add_argument("-I", type=str, default=None, dest="insert_spec")
    ap.add_argument("--engine", choices=["oracle", "device"],
                    default="device")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device engine: cuda "
                         "(= cuda:0), cuda:N or cpu")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the device pipeline over N chips "
                         "(0 = single-device)")
    ap.add_argument("--sa-intv", type=int, default=0, dest="sa_intv",
                    help="densify the suffix-array sample ON DEVICE to "
                         "this interval (power of two < the on-disk "
                         "intv 32): device memory traded for SAL walk "
                         "depth; "
                         "the index files are untouched")
    ap.add_argument("--tail", choices=["python", "native"],
                    default="native")
    ap.add_argument("-v", type=int, default=3, dest="verbose")
    args = ap.parse_args(argv)
    if args.mesh > 0:
        raise NotImplementedError(
            "--mesh selects the sharded multi-device pipeline "
            "(parallel/mesh.py, parallel/sharded.py), not ported yet "
            "(ROADMAP: modules to port — multi-GPU)")

    opt = MemOptions()
    opt0: set[str] = set()

    def setopt(name, val):
        if val is not None:
            setattr(opt, name, val)
            opt0.add(name)

    setopt("min_seed_len", args.min_seed_len)
    setopt("w", args.band_width)
    setopt("zdrop", args.zdrop)
    setopt("split_factor", args.split_factor)
    setopt("max_mem_intv", args.max_mem_intv)
    setopt("max_occ", args.max_occ)
    setopt("drop_ratio", args.drop_ratio)
    setopt("min_chain_weight", args.min_chain_weight)
    setopt("split_width", args.split_width)
    setopt("max_chain_gap", args.max_chain_gap)
    setopt("max_chain_extend", args.max_chain_extend)
    setopt("a", args.match_score)
    setopt("b", args.mismatch)
    setopt("pen_unpaired", args.pen_unpaired)
    setopt("T", args.score_T)
    setopt("max_matesw", args.max_matesw)
    if args.output_f and not args.output:
        args.output = args.output_f
    if args.mask_level is not None:
        opt.mask_level = args.mask_level
    if args.gap_open is not None:
        opt.o_del, opt.o_ins = _parse_pair(args.gap_open)
        opt0.update(("o_del", "o_ins"))
    if args.gap_ext is not None:
        opt.e_del, opt.e_ins = _parse_pair(args.gap_ext)
        opt0.update(("e_del", "e_ins"))
    if args.clip_pen is not None:
        opt.pen_clip5, opt.pen_clip3 = _parse_pair(args.clip_pen)
        opt0.update(("pen_clip5", "pen_clip3"))
    if args.xa_hits is not None:
        opt.max_XA_hits, opt.max_XA_hits_alt = _parse_pair(args.xa_hits)
        opt0.update(("max_XA_hits", "max_XA_hits_alt"))
    if args.mapq_coef_len is not None:
        opt.mapQ_coef_len = args.mapq_coef_len
        opt.mapQ_coef_fac = int(math.log(opt.mapQ_coef_len)) \
            if opt.mapQ_coef_len > 0 else 0
        opt0.add("mapQ_coef_len")
    if args.all_aln:
        opt.flag |= opts.MEM_F_ALL
    if args.ref_hdr:
        opt.flag |= opts.MEM_F_REF_HDR
    if args.softclip:
        opt.flag |= opts.MEM_F_SOFTCLIP
    if args.no_multi:
        opt.flag |= opts.MEM_F_NO_MULTI
    if getattr(args, "primary5"):
        opt.flag |= opts.MEM_F_PRIMARY5 | opts.MEM_F_KEEP_SUPP_MAPQ
    if args.keep_supp_mapq:
        opt.flag |= opts.MEM_F_KEEP_SUPP_MAPQ
    if args.smart_pe:
        opt.flag |= opts.MEM_F_PE | opts.MEM_F_SMARTPE
        if args.reads2:  # fastmap.c:415
            print("[W::mem] when '-p' is in use, the second query file is "
                  "ignored.", file=sys.stderr)
            args.reads2 = None
    if args.reads2:
        opt.flag |= opts.MEM_F_PE
    if args.skip_pairing:
        opt.flag |= opts.MEM_F_NOPAIRING
    if args.no_rescue:
        opt.flag |= opts.MEM_F_NO_RESCUE

    pes_override = None
    if args.insert_spec:  # fastmap.c:266-283 -I mean[,std[,max[,min]]]
        parts = [float(x) for x in args.insert_spec.split(",")]
        avg = parts[0]
        std = parts[1] if len(parts) > 1 else avg * 0.1
        # the +0.499 rounding applies to explicit max/min too, and the
        # low>=1 clamp precedes the explicit overrides (fastmap.c:273-279)
        high = int(avg + 4.0 * std + 0.499)
        low = max(int(avg - 4.0 * std + 0.499), 1)
        if len(parts) > 2:
            high = int(parts[2] + 0.499)
        if len(parts) > 3:
            low = int(parts[3] + 0.499)
        pes_override = []
        for d in range(4):
            if d == 1:  # FR only
                pes_override += [0.0, float(low), float(high), avg, std]
            else:
                pes_override += [1.0, 0.0, 0.0, 0.0, 0.0]

    if args.preset:
        opts.apply_preset(opt, opt0, args.preset)
    else:
        opts.update_a(opt, opt0)
    opt.refresh_mat()

    rg_id = ""
    hdr_extra = None
    if args.rg_line:
        rg = args.rg_line.replace("\\t", "\t")
        for field in rg.split("\t"):
            if field.startswith("ID:"):
                rg_id = field[3:]
        hdr_extra = rg
    if args.hdr_line:
        # -H: a literal header line if it starts with '@', else a FILE
        # of header lines (fastmap.c:250-265)
        if args.hdr_line.startswith("@"):
            lines = [args.hdr_line]
        else:
            with open(args.hdr_line) as hf:
                lines = [l.rstrip("\n") for l in hf if l.strip()]
        for line in lines:
            hdr_extra = (hdr_extra + "\n" if hdr_extra else "") + line

    # shm-staged index first (bwa_idx_load_from_shm, main.cpp:389-393)
    from compseed_tpu_torch.index import shm as shm_mod
    shm_name = os.path.basename(args.index_prefix)
    sa_intv = _check_sa_intv(args, shm_name)
    if sa_intv < 0:
        return 1
    if shm_mod.shm_available(shm_name):
        print(f"[mem] attaching shm-staged index {shm_name!r}",
              file=sys.stderr)
        fm = shm_mod.shm_load(shm_name)
    else:
        fm = FMIndex.load(args.index_prefix)
    if args.ignore_alt:
        for a in fm.bns.anns:
            a.is_alt = 0

    dev = None
    if args.engine == "device":
        import torch
        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)    # tensors report cuda:0
        if dev.type == "cuda" and not torch.cuda.is_available():
            print(f"[E::mem] --device {args.device}: no CUDA device is "
                  "available (pass --device cpu or --engine oracle to run "
                  "without one)", file=sys.stderr)
            return 1

    out = open(args.output, "w") if args.output else sys.stdout
    pg = ("@PG\tID:compseed-tpu\tPN:compseed-tpu\tVN:0.1.0\tCL:"
          + " ".join(["compseed-tpu", "mem"] + argv))
    out.write(sam_header(fm, hdr_extra, pg))

    engine = None
    seeder = None
    tail = None
    # sniff ONCE on a single opened stream ('<cmd' pipes / URLs must not
    # be re-opened); the stream with the sniffed byte pushed back is what
    # the reader consumes
    if args.reads2 is not None:
        is_fastq_in, reads_stream = True, args.reads
    else:
        is_fastq_in, reads_stream = sniff_open(args.reads)
    if args.engine == "device":
        from compseed_tpu_torch.ops.engine import (device_engine,
                                                   device_seeder)
        try:
            dfi = None
            if sa_intv:
                import numpy as _np
                from compseed_tpu_torch.ops.device_index import (densify_sa,
                                                                 to_device)
                t_d = time.time()
                dfi = densify_sa(to_device(fm, dev), sa_intv)
                # keep the host views in agreement (oracle fallback / SAL)
                fm.sa_sampled = \
                    dfi.sa_sampled.cpu().numpy().astype(_np.uint64)
                if args.verbose >= 3:
                    print(f"[mem] densified the suffix-array sample from "
                          f"interval {fm.sa_intv} to {sa_intv} in "
                          f"{time.time() - t_d:.2f}s", file=sys.stderr)
                fm.sa_intv = sa_intv
            # compressive dedup on for every input mode (the reference
            # builds its SSTs unconditionally); the adaptive cap
            # fallback protects low-sharing FASTQ input
            seeder = device_seeder(opt, fm, dedup=True, dfi=dfi, device=dev)
            # on a card this builds the kernels and runs their launch
            # self-check
            engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)
        except (RuntimeError, OSError) as e:
            # a kernel that does not build or launch, or a device that
            # cannot be used: the run ends here
            print(f"[E::mem] --engine device on {dev}: {e}",
                  file=sys.stderr)
            if args.output:
                out.close()
            return 1
    if args.tail == "native":
        from compseed_tpu_torch.native import NativeTail, set_threads
        set_threads(args.n_threads)   # -t threads the host tail's kt_for
        tail = NativeTail(opt, fm)

    chunk_bases = args.chunk_bases if args.chunk_bases and \
        args.chunk_bases > 0 else opt.chunk_size * opt.n_threads
    if args.reads2:
        from compseed_tpu_torch.io.fastq import read_fastq_pair_chunks
        reader = lambda src, cb: read_fastq_pair_chunks(
            src, args.reads2, cb)
    else:
        reader = read_fastq_chunks if is_fastq_in else read_reordered_chunks
    # 3-stage pipeline: reader thread | align (this thread) | writer
    # thread — the kt_pipeline(2, process, 3) overlap of main.cpp:438 with
    # the same ordered-output guarantee (single aligner, FIFO queues).
    import queue
    import threading

    # -1 (no_mt_io, fastmap.c:234): no IO/compute overlap — queues of
    # depth 1 serialize the reader/aligner/writer hand-offs
    qcap_in, qcap_out = (1, 1) if args.single_io else (2, 4)
    q_in: "queue.Queue" = queue.Queue(maxsize=qcap_in)
    q_out: "queue.Queue" = queue.Queue(maxsize=qcap_out)

    def _reader():
        try:
            for chunk in reader(reads_stream, chunk_bases):
                q_in.put(chunk)
        finally:
            q_in.put(None)

    def _writer():
        while True:
            item = q_out.get()
            if item is None:
                break
            for r in item:
                if r.sam:
                    out.write(r.sam)

    rt = threading.Thread(target=_reader, daemon=True)
    wt = threading.Thread(target=_writer, daemon=True)
    rt.start()
    wt.start()
    stats = SeedingStats()
    t0 = time.time()

    def _chunks():
        while True:
            c = q_in.get()
            if c is None:
                return
            if not args.copy_comment:
                for r in c:
                    r.comment = None
            yield c

    state = {"n": 0}

    def _done(chunk):
        q_out.put(chunk)
        state["n"] += len(chunk)
        if args.verbose >= 3:
            print(f"[mem] processed {state['n']} reads "
                  f"({state['n'] / (time.time() - t0):.0f} reads/s)",
                  file=sys.stderr)

    from compseed_tpu_torch.parallel import distributed as dist_mod
    proc_id, n_procs = dist_mod.init_distributed(
        device=dev if dev is not None else "cpu")
    if n_procs > 1:
        # multi-host / multi-process: round-robin -K chunk ownership with
        # per-chunk shard files; `compseed-tpu merge` restores global
        # order byte-identically (parallel/distributed.py)
        if not args.output:
            print("[E::mem] distributed mode requires -o", file=sys.stderr)
            return 1
        if proc_id == 0:
            with open(args.output + ".header", "w") as hf:
                hf.write(sam_header(fm, hdr_extra, pg))
        n_processed = 0
        ci = 0
        for chunk in _chunks():
            base = n_processed
            n_processed += len(chunk)
            if dist_mod.owns_chunk(ci, proc_id, n_procs):
                align_chunk(opt, fm, chunk, base, engine=engine,
                            stats=stats, seeder=seeder, tail=tail,
                            rg_id=rg_id, pes_override=pes_override)
                with open(dist_mod.shard_path(args.output, ci), "w") as f:
                    for r in chunk:
                        if r.sam:
                            f.write(r.sam)
                state["n"] += len(chunk)
            ci += 1
        q_out.put(None)
        rt.join()
        wt.join()
        if args.output:
            out.close()
            os.remove(args.output)   # shards + header replace the stream
        return 0

    if opt.flag & opts.MEM_F_SMARTPE:
        # -p: classify each chunk into SE/PE groups (fastmap.c:107-127)
        from compseed_tpu_torch.pipeline.align import align_chunk_smart
        n_processed = 0
        for chunk in _chunks():
            align_chunk_smart(opt, fm, chunk, n_processed, engine=engine,
                              stats=stats, seeder=seeder, tail=tail,
                              rg_id=rg_id, pes_override=pes_override,
                              verbose=args.verbose)
            n_processed += len(chunk)
            _done(chunk)
    elif seeder is not None and tail is not None and \
            hasattr(seeder, "run_flat"):
        # overlapped: device seeds chunk k+1 while the tail finishes k
        from compseed_tpu_torch.pipeline.align import align_stream
        align_stream(opt, fm, _chunks(), engine, seeder, tail, _done,
                     stats=stats, rg_id=rg_id, pes_override=pes_override)
    else:
        n_processed = 0
        for chunk in _chunks():
            align_chunk(opt, fm, chunk, n_processed, engine=engine,
                        stats=stats, seeder=seeder, tail=tail, rg_id=rg_id,
                        pes_override=pes_override)
            n_processed += len(chunk)
            _done(chunk)
    q_out.put(None)
    rt.join()
    wt.join()
    if args.output:
        out.close()
    if args.verbose >= 3 and stats.bwt_queries:
        # same wording as the reference's exit report (main.cpp:206-209)
        print(f"BWT-extend:  {stats.bwt_queries} queries, {stats.bwt_calls} "
              f"calls, {100.0 * (stats.bwt_queries - stats.bwt_calls) / stats.bwt_queries:.2f} % hit in SST",
              file=sys.stderr)
        print(f"SA Lookup:   {stats.sal_queries} queries, {stats.sal_calls} "
              f"calls, {100.0 * (stats.sal_queries - stats.sal_calls) / stats.sal_queries:.2f} % merged",
              file=sys.stderr)
        if stats.rounds:
            r = stats.rounds
            print("BWT rounds:  " + " ".join(
                f"{k}={r.get(k, 0)}" for k in
                ("bq1", "bc1", "bq2", "bc2", "fq1", "fc1", "fq2",
                 "fc2", "fq3", "fc3")), file=sys.stderr)
    if args.verbose >= 3 and tail is not None and tail.prof:
        split = " ".join(f"{k} {v:.2f}s" for k, v in tail.prof.items())
        print(f"Host tail:   {split}", file=sys.stderr)
    return 0


def cmd_merge(argv: list[str]) -> int:
    """Merge distributed per-chunk SAM shards into one ordered file."""
    from compseed_tpu_torch.parallel.distributed import merge_shards
    ap = argparse.ArgumentParser(prog="compseed-tpu merge")
    ap.add_argument("output", help="the -o path the mem runs used")
    ap.add_argument("--keep", action="store_true",
                    help="keep shard files after merging")
    args = ap.parse_args(argv)
    header = None
    hdr_path = args.output + ".header"
    if os.path.exists(hdr_path):
        header = open(hdr_path).read()
    n = merge_shards(args.output, header=header, remove=not args.keep)
    if not args.keep and os.path.exists(hdr_path):
        os.remove(hdr_path)
    print(f"[merge] {n} shards -> {args.output}", file=sys.stderr)
    return 0


def cmd_reorder(argv: list[str]) -> int:
    """Reference-free read reordering — the compressor preprocessing
    step (SPRING/Minicom/PgRC reorder stage, main.cpp:36-58) built in,
    so layout-ordered input for `mem` needs no external compressor."""
    from compseed_tpu_torch.io.fastq import read_fastq_chunks
    from compseed_tpu_torch.io.reorder import reorder_reads
    ap = argparse.ArgumentParser(prog="compseed-tpu reorder")
    ap.add_argument("input", help="FASTQ/FASTA (kopen: file/gz/-/URL)")
    ap.add_argument("-o", dest="output", default="-",
                    help="output path (default stdout)")
    ap.add_argument("-k", type=int, default=21,
                    help="anchor k-mer length (default 21)")
    ap.add_argument("-B", dest="block", type=int, default=4_000_000,
                    help="reads per reordering block (memory bound)")
    args = ap.parse_args(argv)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    total = 0
    for chunk in read_fastq_chunks(args.input, args.block * 200):
        order = reorder_reads([r.seq for r in chunk], k=args.k)
        for i in order:
            r = chunk[i]
            nm = r.name + (" " + r.comment if r.comment else "")
            if r.qual is None:
                out.write(f">{nm}\n{r.seq}\n")
            else:
                out.write(f"@{nm}\n{r.seq}\n+\n{r.qual}\n")
        total += len(chunk)
    if out is not sys.stdout:
        out.close()
    print(f"[reorder] {total} reads", file=sys.stderr)
    return 0


def cmd_shm(argv: list[str]) -> int:
    """Stage/drop a shared-memory index copy (bwashm.c semantics)."""
    from compseed_tpu_torch.index import shm as shm_mod
    ap = argparse.ArgumentParser(prog="compseed-tpu shm")
    ap.add_argument("prefix", nargs="?")
    ap.add_argument("-d", action="store_true", dest="drop",
                    help="destroy staged indexes")
    ap.add_argument("-l", action="store_true", dest="list_them")
    args = ap.parse_args(argv)
    if args.drop:
        shm_mod.shm_destroy(os.path.basename(args.prefix)
                            if args.prefix else None)
        return 0
    if args.list_them:
        root = shm_mod.SHM_ROOT
        if os.path.isdir(root):
            for n in sorted(os.listdir(root)):
                print(n)
        return 0
    if not args.prefix:
        ap.error("prefix required to stage")
    name = shm_mod.shm_stage(args.prefix)
    print(f"[shm] staged index as {name!r}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: compseed-tpu {index,mem,reorder,shm,merge} ...",
              file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return cmd_index(rest)
    if cmd == "mem":
        return cmd_mem(rest)
    if cmd == "reorder":
        return cmd_reorder(rest)
    if cmd == "shm":
        return cmd_shm(rest)
    if cmd == "merge":
        return cmd_merge(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
