"""Shared helpers: nt4 encoding, hash_64, deterministic RNG for N-filling."""

from __future__ import annotations

import numpy as np

# ASCII -> 2-bit nucleotide code, 4 for ambiguous, 5 for '-'.
# Contract: nst_nt4_table (FM_index/bntseq.c:46-63).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord("-")] = 5

NT4_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
NT4_TO_ASCII_COMP = np.frombuffer(b"TGCAN", dtype=np.uint8)

_MASK64 = (1 << 64) - 1


def hash_64(key: int) -> int:
    """Wang 64-bit integer hash used for alignment tie-breaking.

    Contract: hash_64 (bwalib/utils.h:99-110).
    """
    key &= _MASK64
    key = (key + (~(key << 32) & _MASK64)) & _MASK64
    key ^= key >> 22
    key = (key + (~(key << 13) & _MASK64)) & _MASK64
    key ^= key >> 8
    key = (key + (key << 3)) & _MASK64
    key ^= key >> 15
    key = (key + (~(key << 27) & _MASK64)) & _MASK64
    key ^= key >> 31
    return key


class Lrand48:
    """glibc drand48-family LCG, needed to reproduce the reference's
    deterministic ambiguous-base filling (FM_index/bntseq.c:266,295-296)
    bit-exactly so .pac files are byte-identical."""

    A = 0x5DEECE66D
    C = 0xB
    M = 1 << 48

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) % self.M
        return self.x >> 17
