"""Multi-host distribution: torch.distributed + deterministic shard merge.

The reference is single-node (POSIX shm shares the index between
processes on one machine, bwashm.c; kt_pipeline orders output,
cstl/kthread.c:95-105).  The multi-host equivalent implemented here:

  * ``init_distributed`` — bring up ``torch.distributed`` from the
    coordinator env vars so every host joins one process group.
  * Work partitioning is BY -K CHUNK, round-robin on chunk index
    (``owns_chunk``): chunk k belongs to host k % n_hosts.  Chunk
    boundaries are byte-deterministic (fixed base count), so every host
    slices the identical chunk stream without coordination — the -K
    reproducibility contract (main.cpp:266,437) carried across hosts.
  * The FM-index is loaded per host (replicated — it is read-only; the
    intra-host multi-device path is not ported yet).
  * Each host writes ``out.shardNNNN`` files; ``merge_shards`` (or
    ``compseed-tpu merge``) concatenates records back into global chunk
    order.  Merge is pure file concatenation in chunk-index order, so
    the merged SAM is byte-identical to a single-host run.

Scaling expectation: alignment is embarrassingly parallel across chunks
(zero cross-host communication after init; the only shared resource is
the input filesystem), so host-count scaling is limited only by input
IO — the ≥80% N-host efficiency north star is structural rather than
tuned.  On this single-host rig the path is exercised by
tests/test_torch_cli.py with n_hosts simulated process-locally.
"""

from __future__ import annotations

import glob
import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device) -> tuple[int, int]:
    """Initialize torch.distributed when a multi-host launch is configured
    (env: COMPSEED_COORD, COMPSEED_NPROCS, COMPSEED_PROC_ID): the
    coordinator's host:port is the group's TCP address, the backend is
    nccl for a CUDA ``device`` and gloo for the CPU.  Returns
    (process_id, n)."""
    coordinator = coordinator or os.environ.get("COMPSEED_COORD")
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get("COMPSEED_NPROCS", "0") or 0)
    process_id = process_id if process_id is not None else \
        int(os.environ.get("COMPSEED_PROC_ID", "0") or 0)
    if num_processes <= 1:
        return 0, 1
    if coordinator:
        import torch
        import torch.distributed

        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    # no coordinator: single-host multi-process partitioning (the
    # bwashm.c model — processes share the shm-staged index and split
    # the chunk stream; no cross-process collectives are needed)
    return process_id, num_processes


def owns_chunk(chunk_index: int, process_id: int, n_processes: int) -> bool:
    """Deterministic chunk ownership: round-robin on the -K chunk index."""
    return chunk_index % max(n_processes, 1) == process_id


def shard_path(output: str, chunk_index: int) -> str:
    return f"{output}.shard{chunk_index:06d}"


def merge_shards(output: str, header: str | None = None,
                 remove: bool = True) -> int:
    """Concatenate per-chunk shard files into ``output`` in chunk-index
    order; returns the number of shards merged.  Byte-identical to the
    single-host stream because chunk boundaries are content-determined."""
    shards = sorted(glob.glob(f"{output}.shard*"))
    with open(output, "w") as out:
        if header is not None:
            out.write(header)
        for s in shards:
            with open(s) as f:
                out.write(f.read())
            if remove:
                os.remove(s)
    return len(shards)
