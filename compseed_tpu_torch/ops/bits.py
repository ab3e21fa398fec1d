"""Unsigned integer arithmetic on torch tensors.

torch has no uint32/uint64 arithmetic (shifts, adds, maxima and
comparisons on uint32 are not implemented for CPU tensors) and no
popcount.  The port's convention, used everywhere:

  * a 32-bit word (the JAX package's uint32) is an **int64 tensor
    holding a value in [0, 2**32)**.  AND/OR/XOR keep the range; a
    result that can leave it is masked with ``MASK32``;
  * a 64-bit word (the JAX package's uint64: the chain memo's slot hash,
    the staged forward engine's prefix and group hashes) is an int64
    tensor holding the same bit pattern.

Right shifts on int64 are arithmetic, so ``lsr64`` is the logical one.
The wrapping adds and multiplies are built from limbs small enough that no
intermediate leaves the int64 range, so they do not depend on how a
backend treats signed overflow.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def const64(v: int) -> int:
    """A uint64 Python constant as the int64 value of the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)``: the low 32 bits of an integer tensor, as an
    int64 word (negative int32 values wrap like a C cast)."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits reinterpreted as a signed int32 (a truncating cast
    spelled out, so no out-of-range conversion is left to the backend)."""
    x = x.to(torch.int64) & MASK32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of 32-bit words held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def lsr64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of 64-bit patterns held in int64 (0 < n < 64)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for 32-bit words held in int64.  ``b`` may be a
    tensor or a Python int in [0, 2**32)."""
    lo = a * (b & 0xFFFF)                         # < 2**48
    hi = (a * (b >> 16)) & 0xFFFF                 # contributes bits 16..31
    return (lo + (hi << 16)) & MASK32


def _join64(hi32: torch.Tensor, lo32: torch.Tensor) -> torch.Tensor:
    """The int64 holding bits hi32:lo32 (both words in [0, 2**32))."""
    return (hi32 - ((hi32 >> 31) << 32)) * (1 << 32) + lo32


def add64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2**64 for 64-bit patterns held in int64, without a
    signed overflow."""
    lo = (a & MASK32) + (b & MASK32)
    hi = (lsr64(a, 32) + lsr64(b, 32) + (lo >> 32)) & MASK32
    return _join64(hi, lo & MASK32)


def sub64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2**64 for 64-bit patterns held in int64."""
    lo = (a & MASK32) - (b & MASK32)                 # in (-2**32, 2**32)
    hi = (lsr64(a, 32) - lsr64(b, 32) + (lo >> 32)) & MASK32
    return _join64(hi, lo & MASK32)


def mul64(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**64 for 64-bit patterns held in int64 (the uint64
    multiply of the chain memo's slot hash).  ``b`` may be a tensor or a
    Python int holding a 64-bit pattern (see ``const64``)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(const64(b), dtype=torch.int64, device=a.device)
    a0, a1 = a & MASK32, lsr64(a, 32)
    b0, b1 = b & MASK32, lsr64(b, 32)
    # a0*b0 split on b0's 16-bit halves: x + y*2**16, each < 2**48
    x = a0 * (b0 & 0xFFFF)
    y = a0 * (b0 >> 16)
    lo32 = (x + ((y & 0xFFFF) << 16)) & MASK32
    carry = ((x >> 16) + y) >> 16                 # (a0*b0) >> 32
    hi32 = (carry + mul32(a0, b1) + mul32(a1, b0)) & MASK32
    return _join64(hi32, lo32)
