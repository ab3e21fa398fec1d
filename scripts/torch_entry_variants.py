"""The round loops' segment entry kernels of several builds, timed in turns
on one card at every boundary of the first bench chunk.

    python3 scripts/torch_entry_variants.py --variant DIR [--variant DIR ...]

Each DIR holds an edited copy of ``compseed_tpu_torch/csrc/chain_scan.cu``
and ``walk_chain.cu`` whose struct Args is the port's, with the headers
they include beside them (``compact.cuh``, ``loop_graph.cuh``,
``lookback.cuh``, ``key_sort.cuh``).  The first 16,384 bench reads are
seeded once through the plain rounds (``entry_cases.BoundaryCapture``,
int32 positions); every build's segment entry kernel (the port's and each
DIR's) is held to the plain version at every boundary, as captured, with
no live lane, exactly w live and w + 37 live at RCAP
(``chip_smoke.entry_check``), and then timed on the card alone in turns
beside the PyTorch compaction the kernels replaced
(``chip_smoke.entry_time``: a CUDA graph of 20 launches, replayed,
``ENTRY_TURNS`` turns each order).  The look-back words are sized for
tiles of 256 lanes, the smallest a variant may take.  Prints the card's
``nvidia-smi`` line and one JSON line: per boundary the medians and every
time, per build the max_abs_err.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 256          # the smallest tile a variant may take, in lanes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="DIR with an edited chain_scan.cu and walk_chain.cu")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the kernels have no CPU mode")
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from compseed_tpu_torch import bench_input
    from compseed_tpu_torch.ops import chain_cuda, cuda_lib, entry_cases
    from compseed_tpu_torch.ops import walk_cuda
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_lib.ENTRY_TILE = TILE
    dev = torch.device("cuda", 0)
    builds = dict(
        chain=smoke.round_builds(
            [os.path.join(d, "chain_scan.cu") for d in args.variant],
            chain_cuda, smoke.OldChainBuild),
        walk=smoke.round_builds(
            [os.path.join(d, "walk_chain.cu") for d in args.variant],
            walk_cuda, smoke.OldWalkBuild))
    fm, reads = bench_input.setup()
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    with entry_cases.BoundaryCapture() as cap:
        sd.run_flat(list(reads[:smoke.CHUNK]))
    torch.cuda.synchronize()
    check = smoke.entry_check({"int32": cap.cases}, builds)
    times = smoke.entry_time(cap.cases, builds)
    print(json.dumps(dict(
        max_abs_err={k: r["max_abs_err"] for k, r in check.items()},
        builds={w: list(b) for w, b in builds.items()}, times=times)))


if __name__ == "__main__":
    main()
