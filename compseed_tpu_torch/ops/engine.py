"""Device engines pluggable into the pipeline (port of
compseed_tpu/ops/engine.py).

``device_engine``  — batched banded-SW extension (ops/bsw.py) with the
                     engine interface the native tail calls.
``device_seeder``  — batched compressive seeding + merged SAL
                     (ops/seeder2.py).
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
    """The v2 device-resident seeder (ops/seeder2).  dfi: pass a prepared
    DeviceFMIndex instead of uploading ``fm``.  The v1 lockstep seeder
    (COMPSEED_SEEDER=v1) is not ported yet."""
    version = version or os.environ.get("COMPSEED_SEEDER", "v2")
    if version != "v2":
        raise NotImplementedError(
            f"COMPSEED_SEEDER={version}: only the v2 seeder is ported to "
            "compseed_tpu_torch (ROADMAP: modules to port — exact "
            "fallbacks, smem.BatchSeeder)")
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    return DeviceSeeder(opt, fm, device, dfi=dfi, dedup=dedup)
