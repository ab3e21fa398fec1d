"""The kernel names torch.profiler gives one chunk of each named seeding
engine, in a process of its own, beside the launches the wrappers count.

    python3 scripts/torch_profile_names.py [--engine all_off] ...

For each engine (all_off, fwd_staged and bwd_win unless ``--engine`` names
others) a fresh DeviceSeeder over the bench index takes the first 16,384
bench reads through ``chip_smoke.engine_call`` (the call graph's route)
in two ``chip_smoke.profile_chunk`` passes (each a profiled call, then one
without the profiler): the first profiled call captures and instantiates
its call graph while the profiler records, the second replays the kept
graph.  Prints one JSON line an engine: the card's kernels and the
profiler's launches by kernel name of both profiled calls, and the
wrappers' counts over the four calls (a launch captured into a graph
counts once per launch of the graph, so a loop body's kernel counts once
however many rounds it ran).  A kernel the profiler names that the engine
never launches shows its names cannot be trusted; chip_smoke.py's phase 6
makes the same profile late in its long process.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHUNK = 16384


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", action="append", default=[])
    cli = ap.parse_args()
    engines = cli.engine or ["all_off", "fwd_staged", "bwd_win"]
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_profile_names: needs a CUDA card")
    import chip_smoke as cs
    from compseed_tpu_torch import bench_input, native
    from compseed_tpu_torch.ops import (bsw_cuda, chain_cuda, fm_cuda,
                                        lockstep_cuda, smem_cuda, walk_cuda)
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    libs = (fm_cuda, chain_cuda, walk_cuda, smem_cuda, lockstep_cuda,
            bsw_cuda)
    with cf.ThreadPoolExecutor(len(libs) + 1) as ex:
        for f in [ex.submit(m.LIB.build) for m in libs] + [
                ex.submit(native.build_library, True)]:
            f.result()
    for m in libs:
        m.LIB.load()
    from torch.profiler import ProfilerActivity, profile
    # CUPTI traces a graph's kernels only if it ran when the graph was
    # instantiated (chip_smoke.py starts it the same way)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    fm, reads = bench_input.setup()
    queries = list(reads[:CHUNK])
    dfi = to_device(fm, dev)
    for name in engines:
        dedup, knobs = ENGINES[name]
        with cs.engine_env(knobs):
            sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=dedup)
        cs.reset_launches()
        out = dict(engine=name)
        for what in ("first", "kept"):
            p = cs.profile_chunk(lambda: cs.engine_call(sd, queries),
                                 torch.cuda.synchronize)
            out[what] = dict(ran_kernels=p["ran_kernels"],
                             kernels={k: v["launches"]
                                      for k, v in p["kernels"].items()})
        out["wrapper_launches"] = {k: v for k, v in cs.launch_counts().items()
                                   if v}
        print(json.dumps(out), flush=True)
        sd._calls.drop_thread()
        del sd
        torch.cuda.empty_cache()
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
