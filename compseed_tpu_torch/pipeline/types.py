"""Pipeline data types (mem_seed_t / mem_chain_t / mem_alnreg_t / mem_aln_t,
mapping/comp_seed.h:77-146)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int
    aln: int = -1  # index of the alnreg created from this seed (V2)


@dataclass
class Chain:
    pos: int
    rid: int
    is_alt: int
    seeds: list[Seed]
    frac_rep: float = 0.0
    w: int = 0
    kept: int = 0
    first: int = -1

    @property
    def n(self) -> int:
        return len(self.seeds)


@dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0
    chain: Chain | None = None  # a->c in V2, used for seedcov


@dataclass
class Aln:
    """Final per-record alignment (mem_aln_t, comp_seed.h:136-146)."""
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: list = field(default_factory=list)  # [(op, len)] op: 0M 1I 2D 3S 4H
    MD: str = ""
    XA: str | None = None
    score: int = 0
    sub: int = -1
    alt_sc: int = 0
