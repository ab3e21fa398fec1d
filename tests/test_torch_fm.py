"""compseed_tpu_torch.ops.fm vs compseed_tpu.ops.fm and the scalar oracle
(mirrors tests/test_ops_fm.py), exactly, at int32 and int64."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.cpu import fm_oracle as fo
from compseed_tpu.ops import fm as jfm
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops.device_index import to_device

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def dev(request, micro):
    seq, _, fm = micro
    return (seq, fm, jax_to_device(fm, force_dtype=request.param),
            to_device(convert.fmindex_from_jax_package(fm), CPU,
                      force_dtype=request.param))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _intervals(seq, fm, rng, n):
    """Valid bi-intervals from backward search of short patterns."""
    iks = []
    for _ in range(n):
        plen = int(rng.integers(1, 8))
        pos = int(rng.integers(0, len(seq) - plen))
        pat = seq[pos: pos + plen]
        ik = fo.set_intv(fm, int(pat[-1]))
        for j in range(plen - 2, -1, -1):
            nxt = fo.extend(fm, ik, 1)[int(pat[j])]
            if nxt[2] == 0:
                break
            ik = nxt
        iks.append(ik)
    return np.stack(iks).astype(np.int64)


def test_occ4_batch(dev):
    seq, fm, jd, td = dev
    rng = np.random.default_rng(21)
    ks = np.concatenate([rng.integers(0, fm.seq_len, size=200),
                         [-1, 0, fm.seq_len - 1, fm.primary,
                          fm.primary - 1, fm.primary + 1]]).astype(np.int64)
    got = tfm.occ4_batch(td, _t(ks)).numpy()
    assert np.array_equal(got, np.asarray(jfm.occ4_batch(jd, jnp.asarray(ks))))
    for i, k in enumerate(ks):
        assert np.array_equal(got[i], fo.occ4(fm, int(k) if k != -1
                                              else fo.NEG1)), k
    ka, kb = ks[:100], ks[100:200]
    ga, gb = tfm._occ4_pair(td, _t(ka), _t(kb))
    wa, wb = jfm._occ4_pair(jd, jnp.asarray(ka), jnp.asarray(kb))
    assert np.array_equal(ga.numpy(), np.asarray(wa))
    assert np.array_equal(gb.numpy(), np.asarray(wb))


def test_rank4_all_offsets(dev):
    """_rank4 over every in-block offset of a few rows (masks 0..all)."""
    seq, fm, jd, td = dev
    rows = np.arange(min(4, td.occ_rows.shape[0]))
    ks = (rows[:, None] * 128 + np.arange(128)[None, :]).reshape(-1)
    got = tfm._rank4(*tfm._row_fetch(td, _t(ks)), td.dtype).numpy()
    want = np.asarray(jfm._rank4(*jfm._row_fetch(jd, jnp.asarray(ks)),
                                 jd.dtype))
    assert np.array_equal(got, want)


def test_extend_batch(dev):
    seq, fm, jd, td = dev
    iks = _intervals(seq, fm, np.random.default_rng(22), 50)
    for is_back in (0, 1):
        got = tfm.extend_batch(td, _t(iks), is_back).numpy()
        want = np.asarray(jfm.extend_batch(jd, jnp.asarray(iks), is_back))
        assert np.array_equal(got, want), is_back
        for i in range(len(iks)):
            assert np.array_equal(got[i], fo.extend(fm, iks[i], is_back))


def test_extend_sel_batch(dev):
    seq, fm, jd, td = dev
    rng = np.random.default_rng(24)
    iks = _intervals(seq, fm, rng, 64)
    cs = rng.integers(0, 4, size=len(iks)).astype(np.int32)
    for is_back in (0, 1):
        got = tfm.extend_sel_batch(td, _t(iks), _t(cs), is_back).numpy()
        want = np.asarray(jfm.extend_sel_batch(jd, jnp.asarray(iks),
                                               jnp.asarray(cs), is_back))
        assert np.array_equal(got, want), is_back
        full = tfm.extend_batch(td, _t(iks), is_back).numpy()
        assert np.array_equal(got, full[np.arange(len(iks)), cs])
        assert np.array_equal(tfm._sel4(_t(full[:, :, 2]), _t(cs)).numpy(),
                              full[np.arange(len(iks)), cs, 2])


def test_out_of_range_lanes_read_what_jax_reads(dev):
    """Garbage intervals (the members of an overflowed dedup group carry
    them until the chunk is rerun) read what the JAX package reads on an
    index with ``fill_oob`` (what the seeder hands the engines that can
    overflow so): a row block in [-n, 0) wraps, one beyond reads all-ones
    words, and an SA sample index wraps once and clamps — so an
    overflowed chunk's counters match, and no gather leaves its tensor."""
    seq, fm, jd, td = dev
    td = dataclasses.replace(td, fill_oob=True)
    n = td.occ_rows.shape[0]
    span = n * 128
    ks = np.array([-3 * span, -span - 200, -span + 5, -300, -1, 0,
                   fm.seq_len, span - 1, span, span + 4000, 7 * span],
                  np.int64)
    if jd.dtype == jnp.int32:
        ks = ks.clip(-2**31, 2**31 - 1)
    iks = np.stack([ks, ks[::-1], np.full(len(ks), 9)], axis=1)
    cs = np.arange(len(ks)).astype(np.int32) % 4
    for is_back in (0, 1):
        got = tfm.extend_sel_batch(td, _t(iks), _t(cs), is_back).numpy()
        want = np.asarray(jfm.extend_sel_batch(jd, jnp.asarray(iks),
                                               jnp.asarray(cs), is_back))
        assert np.array_equal(got, want), is_back
    got = tfm.occ4_batch(td, _t(ks)).numpy()
    assert np.array_equal(got, np.asarray(jfm.occ4_batch(jd,
                                                         jnp.asarray(ks))))
    kq = ks - ks % td.sa_intv                 # sampled rows: no walk
    sa_ok = tfm.sa_batch(td, _t(kq)).numpy()
    assert np.array_equal(sa_ok, np.asarray(jfm.sa_batch(jd,
                                                         jnp.asarray(kq))))


def test_inv_psi_and_bwt_b0(dev):
    seq, fm, jd, td = dev
    ks = np.concatenate([np.arange(0, fm.seq_len + 1, 3),
                         [fm.primary, fm.primary - 1, fm.primary + 1]])
    ks = ks[(ks >= 0) & (ks <= fm.seq_len)].astype(np.int64)
    got = tfm.inv_psi_batch(td, _t(ks)).numpy()
    assert np.array_equal(got, np.asarray(jfm.inv_psi_batch(
        jd, jnp.asarray(ks))))
    kb = ks[ks < fm.seq_len]
    assert np.array_equal(tfm.bwt_b0_batch(td, _t(kb)).numpy(),
                          np.asarray(jfm.bwt_b0_batch(jd, jnp.asarray(kb))))


def test_sa_batch(dev):
    seq, fm, jd, td = dev
    ks = np.random.default_rng(23).integers(
        0, fm.seq_len + 1, size=300).astype(np.int64)
    got = tfm.sa_batch(td, _t(ks)).numpy()
    assert np.array_equal(got, np.asarray(jfm.sa_batch(jd, jnp.asarray(ks))))
    for i, k in enumerate(ks):
        assert got[i] == fo.sa_lookup(fm, int(k)), k


@pytest.mark.parametrize("n", [300, 1024])
def test_sa_batch_compact(dev, n):
    """Staged compaction: same values and the same stage-cap overflow
    flag as the JAX function (n=1024 of mostly unsampled rows overflows
    the narrow stages on this sa_intv=32 index; n=300 with k=0 padding
    does not)."""
    seq, fm, jd, td = dev
    rng = np.random.default_rng(25 + n)
    ks = rng.integers(0, fm.seq_len + 1, size=n).astype(np.int64)
    if n == 300:
        ks = np.concatenate([ks, np.zeros(900, np.int64)])
    got, govf = tfm.sa_batch_compact(td, _t(ks))
    want, wovf = jfm.sa_batch_compact(jd, jnp.asarray(ks))
    assert bool(govf) == bool(wovf)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if not bool(govf):
        for i in range(0, len(ks), 7):
            assert got[i] == fo.sa_lookup(fm, int(ks[i]))
