"""Carry the device FM-index — the system's "weights" — between the JAX
package and the port.

The JAX ``DeviceFMIndex`` is a dataclass of four arrays (occ_rows,
sa_sampled, L2, pac_words) plus five meta fields.  Handed over as numpy
arrays and a meta dict, they load into the port unchanged; ``to_arrays``
is the inverse, so an index round-trips bit-exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from compseed_tpu_torch.ops.device_index import DeviceFMIndex, from_arrays

ARRAY_FIELDS = ("occ_rows", "sa_sampled", "L2", "pac_words")
META_FIELDS = ("primary", "seq_len", "sa_intv", "l_pac", "idx_dtype")


def from_jax_index(arrays: dict[str, np.ndarray], meta: dict,
                   device: torch.device) -> DeviceFMIndex:
    """Build the port's index from the JAX index's fields as numpy."""
    missing = [k for k in ARRAY_FIELDS if k not in arrays] + \
        [k for k in META_FIELDS if k not in meta]
    if missing:
        raise KeyError(f"missing index fields: {missing}")
    return from_arrays(*(np.asarray(arrays[k]) for k in ARRAY_FIELDS),
                       **{k: meta[k] for k in META_FIELDS}, device=device)


def to_arrays(dfi: DeviceFMIndex) -> tuple[dict[str, np.ndarray], dict]:
    """The port's index as JAX-layout numpy arrays (uint32 words) + meta."""
    arrays = dict(
        occ_rows=dfi.occ_rows.cpu().numpy().astype(np.uint32),
        sa_sampled=dfi.sa_sampled.cpu().numpy(),
        L2=dfi.L2.cpu().numpy(),
        pac_words=dfi.pac_words.cpu().numpy().astype(np.uint32))
    meta = {k: getattr(dfi, k) for k in META_FIELDS}
    return arrays, meta
