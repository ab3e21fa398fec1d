"""Seconds per chunk of compseed_tpu_torch's DeviceSeeder on the bench
input, for two or more checkouts of the repo timed in turns.

    python3 scripts/torch_seeding_ab.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--engine default] \
        [--device cuda] [--mesh NAME=S ...]

Each turn is a fresh process that imports compseed_tpu_torch from its
tree, uploads the bench index (``bench_input.setup``), runs one warm-up
pass and then ``--passes`` timed passes of ``--chunks`` 16,384-read
chunks through ``DeviceSeeder.run_flat`` (seeding alone: no DP engine,
no tail), and prints one JSON line.  The summary line gives per tree the
median seconds per chunk over its turns and every value.  Trees that
predate an engine knob can only be timed on the default engine.
``--mesh NAME=S`` seeds that name's turns through
``parallel.sharded.ShardedSeeder`` over ``[device] * S`` instead (one
tree may appear under two names, e.g. ``--tree plain=. --tree mesh1=.
--mesh mesh1=1``, to time the sharded layer against the seeder alone).
``--profile`` also runs, after the timed passes of every turn, one chunk
under torch.profiler (``chip_smoke.profile_chunk`` of THIS checkout, the
same pass ``chip_smoke.py`` phase 4 makes): launches, stream syncs and
async copies per chunk and the card's busy share.  ``--stream`` also
times, after those, the whole alignment of the turn's chunks
(``pipeline.align.align_stream`` with the device DP engine and the native
tail, as ``chip_smoke.py`` phase 4 runs it): one warm-up stream, then
reads/s of one more.  ``--segments`` also runs, after those, the same
chunk on the eager route with every round loop's segment timed on the
card between CUDA events on kept graphs (``chip_smoke.segment_rounds`` of
THIS checkout): ms per round of each loop and the kernels its body graph
holds.  ``--call`` times, profiles and warms up with the engine's call
alone instead of ``run_flat`` (``chip_smoke.engine_call`` of THIS
checkout: the upload, the call and the fetches, with no response to an
overflow), for an engine whose bench chunks overflow its caps
(fwd_staged), which ``run_flat`` would rerun and then switch off; each
timed chunk's overflow flag is recorded, and ``device_s`` is the call's
seconds as ``run_flat`` times them.  In a tree whose seeder runs its round
loops as
CUDA graphs (``ops.cuda_lib.LoopGraph``) each turn also gives the
capture and instantiation ms of every graph it built (a graph is built
at a shape's first call on a thread, in the warm-up pass, and kept), and
in one that runs each call as one graph (``ops.cuda_lib.CallGraph``)
those of each call graph; every turn gives the warm-up pass's seconds
per chunk (its first chunk builds the graphs).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHUNK = 16384

_TURN = r"""
import json, os, sys, time
sys.path.insert(0, {tree!r})
import torch
from compseed_tpu_torch import bench_input
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
dev = torch.device({device!r})
if dev.type == "cuda" and dev.index is None:
    dev = torch.device("cuda", 0)    # the seeder holds its index to cuda:0
fm, reads = bench_input.setup()
knobs = {knobs!r}
os.environ.update(knobs[1])
if {shards}:
    from compseed_tpu_torch.parallel.sharded import ShardedSeeder
    sd = ShardedSeeder(MemOptions(), fm, mesh=[dev] * {shards},
                       dedup=knobs[0])
else:
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=knobs[0])
chunks = [[reads[(c * {chunk} + i) % len(reads)] for i in range({chunk})]
          for c in range({chunks})]
def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()
if {profile!r}:
    # CUPTI traces a CUDA graph's kernels only if it was running when the
    # graph was instantiated: start it before the warm-up builds them
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        sync()
graphs, calls = [], []
try:
    from compseed_tpu_torch.ops import cuda_lib
    end = cuda_lib.LoopGraph.end
    def timed_end(self):
        end(self)
        graphs.append((self.capture_s * 1e3, self.instantiate_s * 1e3))
    cuda_lib.LoopGraph.end = timed_end
    init = cuda_lib.CallGraph.__init__
    def timed_init(self, *a, **kw):
        init(self, *a, **kw)
        calls.append((self.capture_s * 1e3, self.instantiate_s * 1e3))
    cuda_lib.CallGraph.__init__ = timed_init
except (ImportError, AttributeError):
    pass                             # a tree without loop or call graphs
if {profile!r} or {segments!r} or {call!r}:
    import importlib.util
    spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
if {call!r}:
    def step(c):
        head, s = smoke.engine_call(sd, c)
        return bool(head[3:14].any()), s
else:
    def step(c):
        sd.run_flat(c)
        return sd.last_overflow, sd.prof["device_s"]
warm = []
for c in chunks:
    sync()
    t0 = time.perf_counter()
    step(c)
    sync()
    warm.append(time.perf_counter() - t0)
secs, dev_s, ovf = [], [], []
for _ in range({passes}):
    for c in chunks:
        sync()
        t0 = time.perf_counter()
        o, s = step(c)
        sync()
        secs.append(time.perf_counter() - t0)
        dev_s.append(s)
        ovf.append(o)
        if o and not {call!r}:
            raise SystemExit("a chunk overflowed: not the engine's own time")
rec = dict(run_flat_s=secs, device_s=dev_s, warmup_run_flat_s=warm)
if {call!r}:
    rec["overflow"] = ovf
if graphs:
    rec["graph_ms"] = dict(capture=[c for c, _ in graphs],
                           instantiate=[i for _, i in graphs])
if calls:
    rec["call_graph_ms"] = dict(capture=[c for c, _ in calls],
                                instantiate=[i for _, i in calls])
if {stream!r}:
    from compseed_tpu_torch.io.fastq import Read
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops.engine import device_engine
    from compseed_tpu_torch.pipeline.align import align_stream
    from compseed_tpu_torch.pipeline.seeding import SeedingStats
    from compseed_tpu_torch.utils import NT4_TO_ASCII
    opt = MemOptions()
    engine = device_engine(opt, fm, dfi=sd.dfi, device=dev)
    tail = NativeTail(opt, fm)
    def mk():
        return [[Read(name=str(c * {chunk} + i + 1),
                      seq=bytes(NT4_TO_ASCII[q]).decode(), qual=None,
                      comment=None) for i, q in enumerate(ch)]
                for c, ch in enumerate(chunks)]
    rates = []
    for _ in range(2):
        done, sts = [], SeedingStats()
        sync()
        t0 = time.perf_counter()
        align_stream(opt, fm, iter(mk()), engine, sd, tail,
                     on_done=done.extend, stats=sts)
        sync()
        rates.append(len(done) / (time.perf_counter() - t0))
    rec["stream_reads_per_s"] = rates[1]
    rec["stream_warmup_reads_per_s"] = rates[0]
if {profile!r}:
    rec["profile"] = smoke.profile_chunk(lambda: step(chunks[0]), sync)
if {segments!r}:
    rec["segments"] = smoke.segment_rounds(sd, chunks[0])
print(json.dumps(rec))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout of the repo")
    ap.add_argument("--order", help="turns, comma-separated names "
                    "(default: each tree, then again in reverse)")
    ap.add_argument("--engine", default="default")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--mesh", action="append", default=[],
                    help="NAME=S: that name's turns on a ShardedSeeder "
                         "of S shards")
    ap.add_argument("--profile", action="store_true",
                    help="profile one chunk after each turn's passes")
    ap.add_argument("--stream", action="store_true",
                    help="time the whole alignment of the chunks too")
    ap.add_argument("--segments", action="store_true",
                    help="time each loop's kept segment graphs a round")
    ap.add_argument("--call", action="store_true",
                    help="the engine's call alone, no overflow response "
                         "(chip_smoke.engine_call) in place of run_flat")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    shards = {n: int(v) for n, v in (m.split("=", 1) for m in args.mesh)}
    names = list(trees)
    order = args.order.split(",") if args.order else names + names[::-1]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from compseed_tpu_torch.ops.seeder2 import ENGINES
    knobs = ENGINES[args.engine]
    runs = {n: [] for n in names}
    for name in order:
        code = _TURN.format(tree=os.path.abspath(trees[name]),
                            device=args.device, knobs=knobs, chunk=CHUNK,
                            chunks=args.chunks, passes=args.passes,
                            shards=shards.get(name, 0),
                            profile=args.profile, stream=args.stream,
                            segments=args.segments, call=args.call,
                            smoke=os.path.join(here, "chip_smoke.py"))
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"turn {name}: exit code {proc.returncode}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps(dict(turn=name, **rec)), flush=True)
    print(json.dumps({n: dict(
        median_run_flat_s=statistics.median(
            x for r in rs for x in r["run_flat_s"]),
        median_device_s=statistics.median(
            x for r in rs for x in r["device_s"]),
        turns=[r["run_flat_s"] for r in rs],
        stream_reads_per_s=[r["stream_reads_per_s"] for r in rs
                            if "stream_reads_per_s" in r],
        graph_ms=[r["graph_ms"] for r in rs if "graph_ms" in r],
        call_graph_ms=[r["call_graph_ms"] for r in rs
                       if "call_graph_ms" in r],
        warmup_run_flat_s=[r["warmup_run_flat_s"] for r in rs],
        profiles=[r["profile"] for r in rs if "profile" in r],
        segments=[r["segments"] for r in rs if "segments" in r])
        for n, rs in runs.items() if rs}))


if __name__ == "__main__":
    main()
