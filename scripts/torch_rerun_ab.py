"""Seconds of compseed_tpu_torch's exact rerun (a chunk that overflows a cap
of ``DeviceSeeder`` rerun on the lockstep seeder, ``ops/smem.BatchSeeder``)
for two or more checkouts of the repo, timed in turns on the card.

    python3 scripts/torch_rerun_ab.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--runs 2] [--profile]

Each turn is a fresh process that imports compseed_tpu_torch from its
tree and runs the reruns ``chip_smoke.py`` makes: ``forced`` (the first
16,384 bench reads on a DeviceSeeder whose round-1 pool is forced small,
GP_F = 18), ``golden`` (tests/fixtures/reads.fq, 2,000 reads as one chunk
on the tiny index) and ``mesh`` (the forced chunk on a ShardedSeeder over
the card four times, GP_F = 2: each shard reruns).  A warm-up run of each,
then ``--runs`` runs each on a fresh seeder: every run's ``rerun_s``
(DeviceSeeder's own) and the split of each BatchSeeder's ``prof`` (r1 and
its collect calls, r2, r3, sal, post: seconds; a mesh run's four shards
summed) and the kernels each rerun launched.  ``--profile`` also runs the
golden's rerun alone (``BatchSeeder.run_flat`` on the chunk) under
torch.profiler (``chip_smoke.profile_chunk`` of THIS checkout): host
launches, stream syncs, copies, the kernels the card ran by name.  Prints
one JSON line a turn and a summary line: per tree and case, the median
``rerun_s`` over its turns' runs and every run's split.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_TURN = r"""
import json, os, sys, time
sys.path.insert(0, {tree!r})
import torch
from compseed_tpu_torch import bench_input
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.io.fastq import read_fastq_chunks
from compseed_tpu_torch.ops import fm_cuda, smem
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.parallel.sharded import ShardedSeeder
from compseed_tpu_torch.pipeline.align import encode_read
try:
    from compseed_tpu_torch.ops import smem_cuda
    counted = (fm_cuda.LAUNCHES, smem_cuda.LAUNCHES)
except ImportError:             # a tree before the exact rerun's kernels
    counted = (fm_cuda.LAUNCHES,)
dev = torch.device("cuda", 0)
opt = MemOptions()
fm, reads = bench_input.setup()
fm_t = FMIndex.load(os.path.join({tree!r}, "tests", "fixtures", "tiny"))
golden = []
for ch in read_fastq_chunks(os.path.join({tree!r}, "tests", "fixtures",
                                         "reads.fq"), 10 ** 9):
    golden.extend(encode_read(r.seq) for r in ch)
chunk = list(reads[:16384])
dfi, dfi_t = to_device(fm, dev), to_device(fm_t, dev)
profs = []
run_flat = smem.BatchSeeder.run_flat
def recorded(self, *a, **kw):
    out = run_flat(self, *a, **kw)
    profs.append(self.prof)
    return out
smem.BatchSeeder.run_flat = recorded
def split(prof):
    out = dict(r1=sum(s for _, s in prof["r1"]), r1_calls=len(prof["r1"]))
    out.update((k, prof[k]) for k in ("r2", "r3", "sal", "post"))
    return out
def seeder(case):
    if case == "mesh":
        sd = ShardedSeeder(opt, fm, mesh=[dev] * 4, dfi=dfi, dedup=True)
        sd.GP_F = 2
    elif case == "forced":
        sd = DeviceSeeder(opt, fm, dev, dfi=dfi, dedup=True)
        sd.GP_F = 18
    else:
        sd = DeviceSeeder(opt, fm_t, dev, dfi=dfi_t, dedup=True)
    return sd, golden if case == "golden" else chunk
out = {{}}
for case in ("forced", "golden", "mesh"):
    rec = out[case] = dict(rerun_s=[], split=[], launches=[])
    for run in range({runs} + 1):           # the first is the warm-up
        sd, qs = seeder(case)
        for counts in counted:
            for k in counts:
                counts[k] = 0
        del profs[:]
        sd.run_flat(qs)
        torch.cuda.synchronize()
        if not sd.last_overflow:
            raise SystemExit(f"{{case}}: the chunk did not overflow")
        if run:
            rec["rerun_s"].append(sd.prof["rerun_s"])
            s = {{}}
            for p in profs:
                for k, v in split(p).items():
                    s[k] = s.get(k, 0) + v
            rec["split"].append(s)
            rec["launches"].append({{k: v for c in counted
                                    for k, v in c.items() if v}})
if {profile!r}:
    import importlib.util
    spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out["golden_profile"] = smoke.profile_chunk(
        lambda: run_flat(smem.BatchSeeder(opt, fm_t, dev, dfi_t), golden),
        torch.cuda.synchronize)
out["card"] = torch.cuda.get_device_name(0)
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout of the repo")
    ap.add_argument("--order", help="turns, comma-separated names "
                    "(default: each tree, then again in reverse)")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="profile the golden's rerun alone in each turn")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = args.order.split(",") if args.order else names + names[::-1]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {n: [] for n in names}
    for name in order:
        code = _TURN.format(tree=os.path.abspath(trees[name]),
                            runs=args.runs, profile=args.profile,
                            smoke=os.path.join(here, "chip_smoke.py"))
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"turn {name}: exit code {proc.returncode}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps(dict(turn=name, **rec)), flush=True)
    print(json.dumps({n: {case: dict(
        median_rerun_s=statistics.median(
            x for r in rs for x in r[case]["rerun_s"]),
        rerun_s=[r[case]["rerun_s"] for r in rs],
        split=[r[case]["split"] for r in rs])
        for case in ("forced", "golden", "mesh")}
        for n, rs in runs.items() if rs}))


if __name__ == "__main__":
    main()
