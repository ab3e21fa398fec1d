"""Seconds per chunk of compseed_tpu_torch's DeviceSeeder on the bench
input, for two or more checkouts of the repo timed in turns.

    python3 scripts/torch_seeding_ab.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--engine default] \
        [--device cuda]

Each turn is a fresh process that imports compseed_tpu_torch from its
tree, uploads the bench index (``bench_input.setup``), runs one warm-up
pass and then ``--passes`` timed passes of ``--chunks`` 16,384-read
chunks through ``DeviceSeeder.run_flat`` (seeding alone: no DP engine,
no tail), and prints one JSON line.  The summary line gives per tree the
median seconds per chunk over its turns and every value.  Trees that
predate an engine knob can only be timed on the default engine.
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
sd = DeviceSeeder(MemOptions(), fm, dev, dedup=knobs[0])
chunks = [[reads[(c * {chunk} + i) % len(reads)] for i in range({chunk})]
          for c in range({chunks})]
def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()
for c in chunks:
    sd.run_flat(c)
secs, dev_s = [], []
for _ in range({passes}):
    for c in chunks:
        sync()
        t0 = time.perf_counter()
        sd.run_flat(c)
        sync()
        secs.append(time.perf_counter() - t0)
        dev_s.append(sd.prof["device_s"])
        if sd.last_overflow:
            raise SystemExit("a chunk overflowed: not the engine's own time")
print(json.dumps(dict(run_flat_s=secs, device_s=dev_s)))
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
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
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
                            chunks=args.chunks, passes=args.passes)
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
        turns=[r["run_flat_s"] for r in rs]) for n, rs in runs.items() if rs}))


if __name__ == "__main__":
    main()
