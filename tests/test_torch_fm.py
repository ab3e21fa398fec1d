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
from compseed_tpu_torch.ops.device_index import (DeviceFMIndex,
                                                 pack_occ_rows, to_device)

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
    rows = np.arange(min(4, td.n_rows))
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
    n = td.n_rows
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


def _occ4_numpy(rows, primary, ks):
    """bwt_occ4 over (n, 12) uint32 rows in the JAX layout, in uint64: the
    block's counts plus the codes at offsets 0..off (k == -1: zeros)."""
    out = np.zeros((len(ks), 4), np.uint64)
    for i, k in enumerate(ks):
        if k == -1:
            continue
        kk = k - (k >= primary)
        r = rows[kk >> 7].astype(np.uint64)
        p = np.arange((kk & 127) + 1)
        hi = (r[4 + (p >> 5)] >> (p & 31).astype(np.uint64)) & 1
        lo = (r[8 + (p >> 5)] >> (p & 31).astype(np.uint64)) & 1
        codes = (hi << 1) | lo
        out[i] = r[:4] + np.array([(codes == b).sum() for b in range(4)],
                                  np.uint64)
    return out


@pytest.mark.parametrize("fill_oob", [False, True], ids=["in", "fill_oob"])
def test_row_fetch_counts_at_or_above_2_31_int64(fill_oob):
    """An int64 index over 2^33 positions whose checkpoint counts are at
    or above 2^31 (negative as the packed table's int32 words): _row_fetch
    gives them back as uint32 values and occ4_batch ranks on them, equal
    to a numpy uint64 reference; under fill_oob a block past the table
    reads the all-ones row as 2^32 - 1 words."""
    rng = np.random.default_rng(27)
    n = 6
    rows = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    rows[:, :4] = rng.integers(2**31, 2**32 - 128, (n, 4))
    rows[2, :4] = [2**31, 2**32 - 129, 2**31 + 1, 3 * 2**30]
    primary = 3 * 128 + 17
    td = DeviceFMIndex(
        occ_packed=torch.from_numpy(pack_occ_rows(rows)),
        sa_sampled=torch.zeros(1, dtype=torch.int64),
        L2=torch.tensor([0, 2**31, 2**32, 2**32 + 2**31, 2**33]),
        pac_words=torch.zeros(1, dtype=torch.int64), primary=primary,
        seq_len=2**33, sa_intv=32, l_pac=2**32, idx_dtype=np.int64,
        fill_oob=fill_oob)
    assert td.dtype == torch.int64
    assert bool((td.occ_packed[:, :4] < 0).all())
    ks = np.concatenate([np.arange(0, (n - 1) * 128, 7), [-1, primary,
                         primary - 1, primary + 1, (n - 1) * 128 - 1]])
    cnt, hi, lo, off = tfm._row_fetch(td, _t(ks))
    assert cnt.dtype == hi.dtype == lo.dtype == torch.int64
    r = rows[ks >> 7].astype(np.int64)             # -1 wraps, as a gather
    assert np.array_equal(cnt.numpy(), r[:, :4])
    assert np.array_equal(hi.numpy(), r[:, 4:8])
    assert np.array_equal(lo.numpy(), r[:, 8:12])
    got = tfm.occ4_batch(td, _t(ks)).numpy()
    assert got.min() >= 0 and got.max() >= 2**31
    assert np.array_equal(got.astype(np.uint64),
                          _occ4_numpy(rows, primary, ks))
    past = _t(np.array([n * 128 + 5, 9 * n * 128]))
    if fill_oob:
        for x in tfm._row_fetch(td, past)[:3]:
            assert bool((x == 2**32 - 1).all())
    else:
        with pytest.raises(IndexError):
            tfm._row_fetch(td, past)
