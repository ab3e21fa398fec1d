"""compseed_tpu_torch.ops.bits — unsigned arithmetic on int64 tensors —
against numpy's uint32/uint64 and jax.lax.population_count, exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compseed_tpu_torch.ops import bits

EDGE32 = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                   0xFFFFFFFF, 0x55555555, 0xAAAAAAAA], np.uint64)
EDGE64 = np.array([0, 1, 0x7FFFFFFFFFFFFFFF, 0x8000000000000000,
                   0xFFFFFFFFFFFFFFFF, 0xBF58476D1CE4E5B9,
                   0x94D049BB133111EB, 0xFFFFFFFF, 0x100000000],
                  np.uint64)


def _words32(seed, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE32, rng.integers(0, 2**32, n,
                                                dtype=np.uint64)])


def _words64(seed, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE64, rng.integers(0, 2**64 - 1, n,
                                                dtype=np.uint64,
                                                endpoint=True)])


def _t64(u: np.ndarray) -> torch.Tensor:
    """uint64 bit patterns -> the port's int64 tensor of the same bits."""
    return torch.from_numpy(u.astype(np.uint64).view(np.int64).copy())


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_popcount32_vs_jax():
    w = _words32(1)
    want = np.asarray(jax.lax.population_count(
        jnp.asarray(w.astype(np.uint32))))
    got = bits.popcount32(_t64(w)).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got[0] == 0 and got[list(EDGE32).index(0xFFFFFFFF)] == 32


def test_u32_and_as_i32_vs_numpy_casts():
    rng = np.random.default_rng(2)
    v = np.concatenate([[0, -1, -2**31, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                         -2**33 - 5],
                        rng.integers(-2**40, 2**40, 2000)]).astype(np.int64)
    t = torch.from_numpy(v)
    assert np.array_equal(bits.u32(t).numpy(),
                          v.astype(np.uint32).astype(np.int64))
    assert np.array_equal(bits.as_i32(t).numpy(), v.astype(np.int32))
    v32 = v.astype(np.int32)
    assert np.array_equal(bits.u32(torch.from_numpy(v32)).numpy(),
                          v32.astype(np.uint32).astype(np.int64))


@pytest.mark.parametrize("n", [1, 15, 29, 31, 32, 33, 63])
def test_lsr64_vs_numpy(n):
    w = _words64(3 + n)
    want = w >> np.uint64(n)
    assert np.array_equal(_u64(bits.lsr64(_t64(w), n)), want)


def test_mul32_wraps_like_uint32():
    a, b = _words32(4), _words32(5)[::-1].copy()
    with np.errstate(over="ignore"):
        want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    assert np.array_equal(bits.mul32(_t64(a), _t64(b)).numpy(), want)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
        with np.errstate(over="ignore"):
            want = (a.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        assert np.array_equal(bits.mul32(_t64(a), c).numpy(), want)


def test_mul64_wraps_like_uint64():
    a, b = _words64(6), _words64(7)[::-1].copy()
    with np.errstate(over="ignore"):
        want = a * b
    assert np.array_equal(_u64(bits.mul64(_t64(a), _t64(b))), want)
    for c in (0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 0xFFFFFFFFFFFFFFFF):
        with np.errstate(over="ignore"):
            want = a * np.uint64(c)
        assert np.array_equal(_u64(bits.mul64(_t64(a), c)), want)


def test_add64_sub64_wrap_like_uint64():
    a, b = _words64(10), _words64(11)[::-1].copy()
    with np.errstate(over="ignore"):
        assert np.array_equal(_u64(bits.add64(_t64(a), _t64(b))), a + b)
        assert np.array_equal(_u64(bits.sub64(_t64(a), _t64(b))), a - b)
        assert np.array_equal(_u64(bits.sub64(_t64(b), _t64(a))), b - a)


@pytest.mark.parametrize("dt", [np.int32, np.int64])
def test_slot_hash_vs_jax(dt):
    """The chain memo's uint64 slot hash (seedscan._slot_hash), including
    negative (garbage-lane) l/s values and large int64 intervals."""
    from compseed_tpu.ops import seedscan as jss
    from compseed_tpu_torch.ops import seedscan as tss
    rng = np.random.default_rng(8)
    n = 3000
    wv = rng.integers(0, 2**30, n).astype(np.uint32)
    hi = 2**31 - 1 if dt == np.int32 else 2**40
    l = rng.integers(-hi, hi, n).astype(dt)
    s = rng.integers(-hi, hi, n).astype(dt)
    l[:4] = [0, -1, 1, hi - 1]
    for H in (1 << 10, 1 << 22):
        want = np.asarray(jss._slot_hash(jnp.asarray(wv), jnp.asarray(l),
                                         jnp.asarray(s), H))
        got = tss._slot_hash(torch.from_numpy(wv.astype(np.int64)),
                             torch.from_numpy(l), torch.from_numpy(s), H)
        assert np.array_equal(got.numpy(), want.astype(np.int64)), H
