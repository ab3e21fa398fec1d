"""Device engines pluggable into the pipeline (port of
compseed_tpu/ops/engine.py).

``device_engine``  — batched banded-SW extension (ops/bsw.py) with the
                     engine interface the native tail calls.
``device_seeder``  — batched compressive seeding + merged SAL
                     (ops/seeder2.py, or ops/smem.py as version "v1").
"""

from __future__ import annotations

import os

import numpy as np
import torch

from compseed_tpu_torch.ops.bsw import BswRunner


def device_engine(opt, fm=None, dfi=None, *, device: torch.device):
    return BswRunner(opt, np.array(opt.mat), device, dfi=dfi)


def device_seeder(opt, fm, dedup: bool = False, dfi=None, *,
                  device: torch.device, version: str | None = None):
    """v2 (default): the device-resident seeder (ops/seeder2); v1
    (COMPSEED_SEEDER=v1): the lockstep seeder (ops/smem), which v2 also
    reruns an overflowing chunk on.  dfi: pass a prepared DeviceFMIndex
    instead of uploading ``fm``."""
    version = version or os.environ.get("COMPSEED_SEEDER", "v2")
    if version == "v1":
        from compseed_tpu_torch.ops.smem import BatchSeeder
        return BatchSeeder(opt, fm, device, dfi=dfi)
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    return DeviceSeeder(opt, fm, device, dfi=dfi, dedup=dedup)
