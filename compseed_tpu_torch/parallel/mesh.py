"""Device lists for data parallelism (port of compseed_tpu/parallel/mesh.py).

The reference is single-node shared-memory (kt_for over 512-read tiles,
cstl/kthread.c; POSIX-shm index sharing, bwalib/bwashm.c).  The JAX
package's equivalent is a one-axis ``Mesh``: the FM-index replicated per
device (it is read-only), read batches sharded over the ``data`` axis,
per-shard results gathered back in deterministic -K order.

PyTorch has no mesh.  Here a mesh is a list of ``torch.device``s, one per
shard; a device may appear more than once (its shards then run one after
the other on it, as the JAX package's virtual CPU mesh runs them on one
host).  ``replicate_index`` places one copy of the index on each distinct
device, and ``data_parallel_step`` runs a function over contiguous shards
of a batch.  The production sharded pipeline is parallel/sharded.py.
"""

from __future__ import annotations

import dataclasses

import torch

from compseed_tpu_torch.ops.device_index import DeviceFMIndex


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh over ``devices`` (``cuda`` taken as ``cuda:0``), by
    default every visible CUDA device.  Raises when no card is visible:
    the default never carries on with the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                               "the devices, e.g. [torch.device('cpu')] * 4, "
                               "to shard on the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: an empty device list")
    return mesh


def distinct(devices) -> list[torch.device]:
    """The mesh's devices, each once, in order of first appearance."""
    return list(dict.fromkeys(devices))


def replicate_index(devices, dfi: DeviceFMIndex) -> dict:
    """One DeviceFMIndex per distinct device of ``devices``: ``dfi``
    itself where it already lies, a copy of its arrays elsewhere (same
    dtype, same ``fill_oob``)."""
    out = {}
    for d in distinct(devices):
        out[d] = dfi if dfi.device == d else dataclasses.replace(
            dfi, occ_packed=dfi.occ_packed.to(d),
            sa_sampled=dfi.sa_sampled.to(d),
            L2=dfi.L2.to(d), pac_words=dfi.pac_words.to(d))
    return out


def data_parallel_step(devices, fn, dfi: DeviceFMIndex):
    """Return ``run(batch)``: dim 0 of ``batch`` cut into len(devices)
    contiguous shards (the last ones shorter or empty), ``fn(replica,
    shard)`` on each shard's device, and the shards' rows back in order
    on the first device.  ``fn`` returns a tensor or a tuple of tensors,
    each with one row per batch row."""
    mesh = make_mesh(devices)
    reps = replicate_index(mesh, dfi)

    def run(batch: torch.Tensor):
        per = -(-batch.shape[0] // len(mesh))
        outs = [fn(reps[d], part.to(d))
                for d, part in zip(mesh, torch.split(batch, max(per, 1)))]
        single = isinstance(outs[0], torch.Tensor)
        cols = zip(*([o] if single else o for o in outs))
        res = tuple(torch.cat([x.to(mesh[0]) for x in c]) for c in cols)
        return res[0] if single else res

    return run
