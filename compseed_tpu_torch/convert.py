"""Carry the FM-index — the system's "weights" — between the JAX
package and the port.

The JAX ``DeviceFMIndex`` is a dataclass of four arrays (occ_rows,
sa_sampled, L2, pac_words) plus five meta fields.  Handed over as numpy
arrays and a meta dict, they load into the port unchanged, apart from
the occ rows, which the port holds packed (``device_index.
pack_occ_rows``); ``to_arrays`` is the inverse, unpacking them, so an
index round-trips bit-exactly.
``fmindex_from_jax_package`` does the same for the host-side ``FMIndex``
(numpy arrays + reference metadata), with no disk round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from compseed_tpu_torch.index.build import AmbHole, BntSeq, SeqAnn
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.ops.device_index import (DeviceFMIndex, from_arrays,
                                                 pack_occ_rows,
                                                 unpack_occ_rows)

# the JAX index's array fields; occ_rows is (n, 12) uint32 there
ARRAY_FIELDS = ("occ_rows", "sa_sampled", "L2", "pac_words")
META_FIELDS = ("primary", "seq_len", "sa_intv", "l_pac", "idx_dtype")


def from_jax_index(arrays: dict[str, np.ndarray], meta: dict,
                   device: torch.device) -> DeviceFMIndex:
    """Build the port's index from the JAX index's fields as numpy."""
    missing = [k for k in ARRAY_FIELDS if k not in arrays] + \
        [k for k in META_FIELDS if k not in meta]
    if missing:
        raise KeyError(f"missing index fields: {missing}")
    occ, *rest = (np.asarray(arrays[k]) for k in ARRAY_FIELDS)
    return from_arrays(pack_occ_rows(occ), *rest,
                       **{k: meta[k] for k in META_FIELDS}, device=device)


def to_arrays(dfi: DeviceFMIndex) -> tuple[dict[str, np.ndarray], dict]:
    """The port's index as JAX-layout numpy arrays (uint32 words) + meta."""
    arrays = dict(
        occ_rows=unpack_occ_rows(dfi.occ_packed.cpu().numpy()),
        sa_sampled=dfi.sa_sampled.cpu().numpy(),
        L2=dfi.L2.cpu().numpy(),
        pac_words=dfi.pac_words.cpu().numpy().astype(np.uint32))
    meta = {k: getattr(dfi, k) for k in META_FIELDS}
    return arrays, meta


def fmindex_from_jax_package(fm) -> FMIndex:
    """The port's host ``FMIndex`` from the JAX package's (any object
    with the same fields): arrays are copied, the reference metadata is
    rebuilt from the port's own dataclasses."""
    bns = BntSeq(
        l_pac=int(fm.bns.l_pac), seed=int(fm.bns.seed),
        anns=[SeqAnn(name=a.name, anno=a.anno, offset=int(a.offset),
                     length=int(a.length), n_ambs=int(a.n_ambs),
                     gi=int(a.gi), is_alt=int(a.is_alt))
              for a in fm.bns.anns],
        ambs=[AmbHole(offset=int(h.offset), length=int(h.length), amb=h.amb)
              for h in fm.bns.ambs])
    return FMIndex(
        primary=int(fm.primary), L2=np.array(fm.L2), seq_len=int(fm.seq_len),
        bwt_words=np.array(fm.bwt_words), cp_occ=np.array(fm.cp_occ),
        sa_intv=int(fm.sa_intv), sa_sampled=np.array(fm.sa_sampled),
        bns=bns, pac=np.array(fm.pac))
