"""Alignment options — the full BWA-MEM tunable surface.

Semantics contract: ``mem_opt_t`` (reference mapping/comp_seed.h:41-73) with
defaults from ``mem_opt_init`` (mapping/comp_seed.cpp:26-61), the ``-x``
presets and ``update_a`` rescaling (main.cpp:130-143, 357-386).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

# Flag bits (mapping/comp_seed.h:21-30)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000

MEM_MAPQ_COEF = 30.0
MEM_MAPQ_MAX = 60

# Reads per compressive batch (mapping/comp_seed.h:36).  The SST-equivalent
# batch-level redundancy is harvested within groups of this many reads.
BATCH_SIZE = 512
MAX_READ_LEN = 65535


def fill_scmat(a: int, b: int) -> list[int]:
    """5x5 scoring matrix: match a, mismatch -b, anything vs N = -1.

    Contract: bwa_fill_scmat (bwalib/bwa.c:135-144).
    """
    mat = []
    for i in range(4):
        for j in range(4):
            mat.append(a if i == j else -b)
        mat.append(-1)
    mat.extend([-1] * 5)
    return mat


@dataclass
class MemOptions:
    a: int = 1                    # match score
    b: int = 4                    # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                  # band width
    zdrop: int = 100

    max_mem_intv: int = 20        # -y, 3rd-round seeding occurrence threshold

    T: int = 30                   # output score threshold
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    # NB: mapQ_coef_fac is an *int* field in mem_opt_t (comp_seed.h:68), so
    # log(mapQ_coef_len) truncates: int(log(50)) == 3.  This feeds mapq.
    mapQ_coef_fac: int = field(default_factory=lambda: int(math.log(50.0)))
    max_ins: int = 10000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    mat: list[int] = field(default_factory=lambda: fill_scmat(1, 4))

    # --- fields below are engine knobs of this implementation, not BWA-MEM's
    batch_size: int = BATCH_SIZE   # compressive group size (SST scope)

    def refresh_mat(self) -> None:
        self.mat = fill_scmat(self.a, self.b)

    def copy(self) -> "MemOptions":
        o = MemOptions(**{f.name: getattr(self, f.name) for f in fields(self)
                          if f.name != "mat"})
        o.mat = list(self.mat)
        return o


def apply_preset(opt: MemOptions, opt0: set[str], mode: str) -> None:
    """-x presets; only fills options not explicitly set (in opt0).

    Contract: main.cpp:357-386.
    """
    def unset(name: str) -> bool:
        return name not in opt0

    if mode == "intractg":
        if unset("o_del"): opt.o_del = 16
        if unset("o_ins"): opt.o_ins = 16
        if unset("b"): opt.b = 9
        if unset("pen_clip5"): opt.pen_clip5 = 5
        if unset("pen_clip3"): opt.pen_clip3 = 5
    elif mode in ("pacbio", "pbref", "ont2d"):
        if unset("o_del"): opt.o_del = 1
        if unset("e_del"): opt.e_del = 1
        if unset("o_ins"): opt.o_ins = 1
        if unset("e_ins"): opt.e_ins = 1
        if unset("b"): opt.b = 1
        if unset("split_factor"): opt.split_factor = 10.0
        if mode == "ont2d":
            if unset("min_chain_weight"): opt.min_chain_weight = 20
            if unset("min_seed_len"): opt.min_seed_len = 14
            if unset("pen_clip5"): opt.pen_clip5 = 0
            if unset("pen_clip3"): opt.pen_clip3 = 0
        else:
            if unset("min_chain_weight"): opt.min_chain_weight = 40
            if unset("min_seed_len"): opt.min_seed_len = 17
            if unset("pen_clip5"): opt.pen_clip5 = 0
            if unset("pen_clip3"): opt.pen_clip3 = 0
    else:
        raise ValueError(f"unknown read type {mode!r}")


def update_a(opt: MemOptions, opt0: set[str]) -> None:
    """When -A changes the match score, rescale unset penalties.

    Contract: main.cpp:130-143.
    """
    if "a" in opt0:
        if "b" not in opt0: opt.b *= opt.a
        if "T" not in opt0: opt.T *= opt.a
        if "o_del" not in opt0: opt.o_del *= opt.a
        if "e_del" not in opt0: opt.e_del *= opt.a
        if "o_ins" not in opt0: opt.o_ins *= opt.a
        if "e_ins" not in opt0: opt.e_ins *= opt.a
        if "zdrop" not in opt0: opt.zdrop *= opt.a
        if "pen_clip5" not in opt0: opt.pen_clip5 *= opt.a
        if "pen_clip3" not in opt0: opt.pen_clip3 *= opt.a
        if "pen_unpaired" not in opt0: opt.pen_unpaired *= opt.a
