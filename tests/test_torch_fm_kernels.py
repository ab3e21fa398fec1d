"""The FM kernels of compseed_tpu_torch/csrc/fm_walk.cu, held three ways on
the CPU: the kernels' own lane code (the source compiled with g++ into
host loops), the port's dispatching functions on CPU tensors (the plain
versions) and the JAX package's functions, exactly, at int32 and int64
index types over the ``micro`` and ``tiny`` fixture indexes:

  fm_extend_sel_kernel   vs ops/fm.extend_sel_batch, compseed_tpu's
                         extend_sel_batch;
  fm_chain_walk_kernel   vs ops/seedscan._chain_walk, compseed_tpu's
                         _chain_walk;
  fm_inv_psi_walk_kernel vs ops/fm._walk, compseed_tpu's inv_psi_batch
                         stepped as sa_batch_compact steps it.

Every kernel's lane code reads the packed occ table (device_index.
pack_occ_rows) and ranks a row in one piece or two, one a thread of its
lane's pair on the card; the host loops add the pieces as the card's
shuffles do.  So also: the packed table against the JAX layout (pack,
unpack), both piece counts' ranks against rank4 at every block offset,
and the host loops against their plain versions over a random index
(fm_cases.random_index, whose rows are checked against
build_occ_rows).

Also: the wrappers' input checks, that the entry points take a plain
version for CPU tensors only, and chain_scan's ``report_rounds``
histogram against the JAX package's.  The kernels themselves are held to
their plain versions on the card in tests/test_torch_cuda.py."""

import ast
import ctypes as ct
import dataclasses
import inspect
import re
import shutil
import subprocess
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import fm as jfm
from compseed_tpu.ops import seedscan as jss
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import fm as tfm
from compseed_tpu_torch.ops import fm_cuda
from compseed_tpu_torch.ops import seedscan as tss
from compseed_tpu_torch.ops.device_index import (build_occ_rows,
                                                 pack_occ_rows, to_device,
                                                 unpack_occ_rows)
from compseed_tpu_torch.ops.fm_cases import (garbage, intervals, pack,
                                             random_chain_lanes,
                                             random_extend_lanes,
                                             random_index,
                                             random_index_rows_match_build,
                                             random_sa_lanes, sa_lanes,
                                             windows)

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/fm_walk.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    so = str(tmp_path_factory.mktemp("fm_walk") / "libfm_walk_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, fm_cuda.LIB.src], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    index = [p, ll, p, ll, i]
    lib.fm_extend_sel_host.argtypes = index + [p, p, i, p, ll, i]
    lib.fm_chain_walk_host.argtypes = index + \
        [p, p, p, p, p, p, i, i, p, p, p, p, ll, i]
    lib.fm_inv_psi_walk_host.argtypes = index + \
        [p, p, p, i, ll, p, p, p, ll, i, p, ll, p]
    lib.fm_rank_pieces_host.argtypes = [p, p, p, ll, i, p, p]
    for fn in (lib.fm_extend_sel_host, lib.fm_chain_walk_host,
               lib.fm_inv_psi_walk_host, lib.fm_rank_pieces_host):
        fn.restype = i
    return lib


@pytest.fixture(scope="module", params=[
    ("micro", None), ("micro", np.int64), ("tiny", None), ("tiny", np.int64)],
    ids=["micro-int32", "micro-int64", "tiny-int32", "tiny-int64"])
def idx(request, micro, tiny_fm):
    """(JAX index, port index on the CPU) of one fixture at one dtype."""
    name, force = request.param
    fm = micro[2] if name == "micro" else tiny_fm
    return (jax_to_device(fm, force_dtype=force),
            to_device(convert.fmindex_from_jax_package(fm), CPU,
                      force_dtype=force))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_dt(td):
    return np.int64 if td.dtype == torch.int64 else np.int32


def _index_args(td):
    """The host entries' index arguments: the packed rows; the arrays
    stay referenced by the returned tuple's first element."""
    occ = np.ascontiguousarray(td.occ_packed.numpy())
    L2 = np.ascontiguousarray(td.L2.numpy())
    return (occ, L2), [occ.ctypes.data, occ.shape[0], L2.ctypes.data,
                       td.primary, int(td.fill_oob)]


def _ptr(a):
    return None if a is None else a.ctypes.data


# ---------------------------------------------------------------------------
def test_pack_occ_rows_roundtrips(idx, tiny_fm, micro):
    """pack_occ_rows holds build_occ_rows' words, reinterpreted as int32, in
    the kernels' order (counts; hi0 lo0 hi1 lo1; hi2 lo2 hi3 lo3; zeros),
    the last row (counts only) included; unpack_occ_rows gives back
    build_occ_rows' rows and the JAX index's occ_rows bit for bit; the
    JAX index carried across builds the same table."""
    jd, td = idx
    fm = tiny_fm if td.seq_len == tiny_fm.seq_len else micro[2]
    rows = build_occ_rows(fm.cp_occ, fm.bwt_words)
    p = td.occ_packed
    assert p.dtype == torch.int32 and p.shape == (td.n_rows, 16)
    assert p.is_contiguous()
    assert np.array_equal(p.numpy(), pack_occ_rows(rows))
    assert not p[:, 12:].any()
    assert not rows[-1, 4:].any() and rows[-1, :4].any()
    assert np.array_equal(p[:, 4:12:2].numpy().view(np.uint32), rows[:, 4:8])
    assert np.array_equal(p[:, 5:12:2].numpy().view(np.uint32), rows[:, 8:12])
    back = unpack_occ_rows(p.numpy())
    assert back.dtype == np.uint32
    assert np.array_equal(back, rows)
    assert np.array_equal(back, np.asarray(jd.occ_rows))
    arrays = {k: np.asarray(getattr(jd, k)) for k in convert.ARRAY_FIELDS}
    meta = {k: getattr(jd, k) for k in convert.META_FIELDS}
    assert torch.equal(convert.from_jax_index(arrays, meta, CPU).occ_packed, p)
    # words at and above 2^31 become negative int32, and come back
    big = np.array([[2**32 - 1, 2**31, 2**31 - 1, 0] + [2**31 + 5] * 8],
                   np.uint32)
    got = pack_occ_rows(big)
    assert got[0, :4].tolist() == [-1, -2**31, 2**31 - 1, 0]
    assert np.array_equal(unpack_occ_rows(got), big)


@pytest.mark.parametrize("pieces", [1, 2])
def test_rank_pieces_sum_to_rank4(host, pieces):
    """The kernels' per-piece rank (rank_piece), summed over ``pieces``
    pieces as the card's shuffles sum them, equals rank4 of the unpacked
    row (ops/fm.py::_rank4) at every block offset 0-127 on random rows and
    on fill_oob's all-ones row; the pieces' codes add up to the BWT code
    at the offset."""
    rng = np.random.default_rng(53 + pieces)
    n_rows = 24
    rows = rng.integers(0, 2**32, (n_rows, 12), dtype=np.int64)
    rows[:, :4] = rng.integers(0, 2**32 - 128, (n_rows, 4))
    rows[3] = 2**32 - 1                      # all ones, as fill_oob reads
    rows[5, 4:] = 0
    occ = torch.from_numpy(rows)
    packed = pack_occ_rows(rows.astype(np.uint32))
    row = np.repeat(np.arange(-1, n_rows), 128).astype(np.int64)
    off = np.tile(np.arange(128), n_rows + 1).astype(np.int32)
    out = np.zeros((len(row), 4), np.int64)
    code = np.zeros(len(row), np.int32)
    rc = host.fm_rank_pieces_host(packed.ctypes.data, row.ctypes.data,
                                  off.ctypes.data, len(row), pieces,
                                  out.ctypes.data, code.ctypes.data)
    assert rc == 0
    full = torch.cat([torch.full((1, 12), 2**32 - 1, dtype=torch.int64),
                      occ])[torch.from_numpy(row + 1)]
    o = torch.from_numpy(off.astype(np.int64))
    want = tfm._rank4(full[:, 0:4], full[:, 4:8], full[:, 8:12], o,
                      torch.int64)
    assert np.array_equal(out, want.numpy())
    assert np.array_equal(code, tfm._bwt_code(full[:, 4:8], full[:, 8:12],
                                              o).numpy())


@pytest.mark.parametrize("pieces", [0, 4])
def test_rank_pieces_refuse_other_counts(host, pieces):
    """A rank is cut into one piece or two, no other count (the walks'
    threads a lane are constants of the source): the host entry refuses
    the others and writes nothing."""
    packed = np.zeros((1, 16), np.int32)
    row, off = np.zeros(1, np.int64), np.full(1, 70, np.int32)
    out, code = np.full((1, 4), 7, np.int64), np.full(1, 7, np.int32)
    assert host.fm_rank_pieces_host(packed.ctypes.data, row.ctypes.data,
                                    off.ctypes.data, 1, pieces,
                                    out.ctypes.data, code.ctypes.data) == -1
    assert (out == 7).all() and code[0] == 7


@pytest.mark.parametrize("seed", [3, 4])
def test_random_index_matches_build(seed):
    """fm_cases.random_index (the card's tables larger than L2) makes the
    rows build_occ_rows makes of its BWT, and L2 from the totals."""
    dfi = random_index(1 << 16, seed, CPU)
    assert dfi.occ_packed.shape == (513, 16) and dfi.dtype == torch.int32
    assert not hasattr(dfi, "occ_rows")
    assert random_index_rows_match_build(dfi, 1 << 16)
    assert not dfi.occ_packed[:, 12:].any()
    tot = dfi.occ_packed[-1, :4].to(torch.int64)
    assert int(tot.sum()) == dfi.seq_len == 1 << 16
    assert dfi.L2.tolist() == [0] + torch.cumsum(tot, 0).tolist()
    assert 0 < dfi.primary < dfi.seq_len
    other = random_index(1 << 16, seed + 10, CPU)
    assert not torch.equal(other.occ_packed, dfi.occ_packed)
    bad = dfi.occ_packed.clone()
    bad[7, 6] ^= 1 << 9
    assert not random_index_rows_match_build(
        dataclasses.replace(dfi, occ_packed=bad), 1 << 16)


@pytest.mark.parametrize("shape", ["fwd W=5", "back W=8 stop_s", "sa 8"])
def test_host_walks_equal_plain_on_random_index(host, shape):
    """The walks' host loops (every piece of every group) equal their plain
    versions over a random index, with the lanes chip_smoke.py drives on
    its table larger than L2."""
    dfi = random_index(1 << 17, 11, CPU)
    gen = torch.Generator().manual_seed(12)
    if shape.startswith("sa"):
        a, _ = random_sa_lanes(dfi, gen, 2000, 8)
        want = tfm._walk_plain(*a)
        rc, got = _host_walk(host, dfi, *(x.numpy() for x in a[1:4]), 8)
        assert rc == 0
        assert int(want[1].sum()) > 2000
    else:
        W = int(shape.split("W=")[1][0])
        a, kw = random_chain_lanes(dfi, gen, 2000, W, shape.startswith(
            "back"), stop="stop_s" in shape)
        want = tss._chain_walk_plain(*a, **kw)
        stop = kw["stop_s"]
        rc, got = _host_chain(host, dfi, a[1].numpy(), W,
                              *(x.numpy() for x in a[3:7]), kw["is_back"],
                              None if stop is None else stop.numpy())
        assert rc == 0
        assert 0 < int(want[3].sum()) < 2000 * W
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
def _host_extend(host, td, ik, c, is_back):
    keep, index = _index_args(td)
    ik = np.ascontiguousarray(ik, _np_dt(td))
    c = np.ascontiguousarray(c, np.int32)
    out = np.zeros_like(ik)
    rc = host.fm_extend_sel_host(*index, ik.ctypes.data, c.ctypes.data,
                                 int(is_back), out.ctypes.data, len(c),
                                 int(td.dtype == torch.int64))
    return rc, out


@pytest.mark.parametrize("is_back", [False, True], ids=["fwd", "back"])
def test_extend_sel_three_ways(host, idx, is_back):
    """Kernel lane code == plain version == JAX, on search intervals, the
    root, intervals around primary and k == -1 queries, every child."""
    jd, td = idx
    rng = np.random.default_rng(31 + is_back)
    ik = intervals(td, rng, 300)
    c = torch.from_numpy(rng.integers(0, 4, ik.shape[0]).astype(np.int32))
    got = tfm.extend_sel_batch(td, ik, c, is_back).numpy()
    want = np.asarray(jfm.extend_sel_batch(jd, jnp.asarray(ik.numpy()),
                                           jnp.asarray(c.numpy()), is_back))
    rc, out = _host_extend(host, td, ik.numpy(), c.numpy(), is_back)
    assert rc == 0
    assert np.array_equal(got, want)
    assert np.array_equal(out, want)
    # the cases occur: primary inside an interval, an occ query at -1
    fwd = 1 - int(is_back)
    x, s = ik[:, fwd].to(torch.int64), ik[:, 2].to(torch.int64)
    assert bool(((x <= td.primary) & (x + s - 1 >= td.primary)).any())
    assert bool((x == 0).any())


def test_extend_sel_batched_lanes(host, idx):
    """A (P, M, 3) batch with a broadcast child (smem's backward shrink):
    the dispatch keeps the shape; the kernel sees it flat."""
    jd, td = idx
    rng = np.random.default_rng(37)
    ik = intervals(td, rng, 96).reshape(12, 8, 3)
    c = torch.from_numpy(rng.integers(0, 4, 12).astype(np.int32))
    cb = c[:, None].expand(12, 8)
    got = tfm.extend_sel_batch(td, ik, cb, True)
    assert got.shape == (12, 8, 3)
    want = np.asarray(jfm.extend_sel_batch(
        jd, jnp.asarray(ik.numpy()), jnp.asarray(cb.numpy()), True))
    rc, out = _host_extend(host, td, ik.reshape(-1, 3).numpy(),
                           cb.reshape(-1).numpy(), True)
    assert rc == 0
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(out.reshape(12, 8, 3), want)


@pytest.mark.parametrize("is_back", [False, True], ids=["fwd", "back"])
def test_extend_sel_garbage_lanes(host, idx, is_back):
    """With fill_oob, garbage intervals read what JAX's gather reads (a
    block in [-n, 0) wraps, one outside [-n, n) reads all-ones words), in
    all three; without it the plain version's index check raises and the
    kernel's lane code faults (on the card: a trap) instead of reading
    past the table."""
    jd, td = idx
    ks = garbage(td)
    ik = np.stack([ks, ks[::-1], np.full(len(ks), 9)], axis=1)
    c = (np.arange(len(ks)) % 4).astype(np.int32)
    oob = dataclasses.replace(td, fill_oob=True)
    want = np.asarray(jfm.extend_sel_batch(jd, jnp.asarray(ik),
                                           jnp.asarray(c), is_back))
    got = tfm.extend_sel_batch(oob, _t(ik), _t(c), is_back).numpy()
    rc, out = _host_extend(host, oob, ik, c, is_back)
    assert rc == 0
    assert np.array_equal(got, want)
    assert np.array_equal(out, want)
    with pytest.raises(IndexError):
        tfm.extend_sel_batch(td, _t(ik), _t(c), is_back)
    assert _host_extend(host, td, ik, c, is_back)[0] == -1


def test_extend_sel_child_out_of_range_faults(host, idx):
    """A child outside [0, 3] is no input of the kernel: its lane faults
    rather than reading L2 past its four bases."""
    _, td = idx
    ik = np.array([[1, 1, 1]])
    assert _host_extend(host, td, ik, np.array([4]), False)[0] == -1
    assert _host_extend(host, td, ik, np.array([-1]), True)[0] == -1


@pytest.mark.parametrize("is_back", [False, True], ids=["fwd", "back"])
def test_extend_sel_through_convert(host, idx, is_back):
    """On the JAX index carried across (convert.from_jax_index packs its
    occ_rows): the kernel's lane code on the packed table ==
    _extend_sel_plain == the JAX extend_sel_batch, on search intervals as
    a (12, 8, 3) batch and on garbage lanes under fill_oob; a child out of
    range makes the host loop return -1."""
    jd, _ = idx
    arrays = {k: np.asarray(getattr(jd, k)) for k in convert.ARRAY_FIELDS}
    meta = {k: getattr(jd, k) for k in convert.META_FIELDS}
    td = convert.from_jax_index(arrays, meta, CPU)
    rng = np.random.default_rng(33 + is_back)
    ks = garbage(td)
    g = np.stack([ks, ks[::-1], np.full(len(ks), 9)], axis=1)
    for fm_, ik in ((td, intervals(td, rng, 96).numpy().reshape(12, 8, 3)),
                    (dataclasses.replace(td, fill_oob=True), g)):
        c = rng.integers(0, 4, ik.shape[:-1]).astype(np.int32)
        got = tfm._extend_sel_plain(fm_, _t(ik), _t(c), is_back).numpy()
        want = np.asarray(jfm.extend_sel_batch(jd, jnp.asarray(ik),
                                               jnp.asarray(c), is_back))
        rc, out = _host_extend(host, fm_, ik.reshape(-1, 3), c.reshape(-1),
                               is_back)
        assert rc == 0
        assert np.array_equal(got, want)
        assert np.array_equal(out.reshape(ik.shape), want)
    c = np.zeros(len(ks), np.int32)
    c[3] = 5
    assert _host_extend(host, td, g[:4] * 0 + 1, c[:4], is_back)[0] == -1


@pytest.mark.parametrize("is_back", [False, True], ids=["fwd", "back"])
def test_host_extend_equals_plain_on_random_index(host, is_back):
    """The extension's host loop equals its plain version over a random
    index, with the lanes chip_smoke.py drives on its table larger than
    L2 (fm_cases.random_extend_lanes)."""
    dfi = random_index(1 << 17, 13, CPU)
    gen = torch.Generator().manual_seed(14 + is_back)
    a, _ = random_extend_lanes(dfi, gen, 2000, is_back)
    want = tfm._extend_sel_plain(*a)
    rc, got = _host_extend(host, dfi, a[1].numpy(), a[2].numpy(), is_back)
    assert rc == 0
    assert np.array_equal(got, want.numpy())
    assert int(want[:, 2].gt(0).sum()) > 100


# ---------------------------------------------------------------------------
def _host_chain(host, td, wv, W, k, l, s, valid, is_back, stop_s):
    keep, index = _index_args(td)
    dt = _np_dt(td)
    U = len(k)
    k, l, s = (np.ascontiguousarray(x, dt) for x in (k, l, s))
    wv = np.ascontiguousarray(wv, np.int64)
    valid = np.ascontiguousarray(valid, np.uint8)
    stop = None if stop_s is None else np.ascontiguousarray(stop_s, dt)
    ck, cl, cs = (np.zeros((U, W), dt) for _ in range(3))
    ln = np.zeros(U, np.int32)
    rc = host.fm_chain_walk_host(
        *index, wv.ctypes.data, k.ctypes.data, l.ctypes.data, s.ctypes.data,
        valid.ctypes.data, _ptr(stop), int(is_back), W, ck.ctypes.data,
        cl.ctypes.data, cs.ctypes.data, ln.ctypes.data, U,
        int(td.dtype == torch.int64))
    return rc, (ck, cl, cs, ln)


def _chain_lanes(td, rng, U, oob):
    ik = intervals(td, rng, U)
    if oob:
        ks = garbage(td)
        g = np.stack([ks, ks[::-1], np.full(len(ks), 9)], axis=1)
        ik = torch.cat([ik, _t(g).to(td.dtype)])
    return ik


@pytest.mark.parametrize("oob", [False, True], ids=["in", "oob"])
@pytest.mark.parametrize("stop", [False, True], ids=["nostop", "stop_s"])
@pytest.mark.parametrize("W", [1, 8, 10])
@pytest.mark.parametrize("is_back", [False, True], ids=["fwd", "back"])
def test_chain_walk_three_ways(host, idx, is_back, W, stop, oob):
    """Kernel lane code == ops/seedscan._chain_walk on CPU tensors == the
    JAX package's _chain_walk: ck, cl, cs after every column and ln, with
    an ambiguous base at every column j, invalid lanes, stop_s present or
    absent, and (with fill_oob) garbage lanes that step."""
    jd, td = idx
    if oob:
        td = dataclasses.replace(td, fill_oob=True)
    rng = np.random.default_rng(41 + 2 * W + stop + 4 * is_back)
    ik = _chain_lanes(td, rng, 200, oob)
    U = ik.shape[0]
    bases = windows(rng, U, W)
    wv = pack(bases)
    valid = rng.random(U) < 0.9
    k, l, s = (ik[:, i].numpy() for i in range(3))
    stop_s = rng.integers(1, 40, U).astype(_np_dt(td)) if stop else None
    got = tss._chain_walk(td, _t(wv), W, _t(k), _t(l), _t(s), _t(valid),
                          is_back=is_back,
                          stop_s=None if stop_s is None else _t(stop_s))
    want = jss._chain_walk(jd, jnp.asarray(bases), W, jnp.asarray(k),
                           jnp.asarray(l), jnp.asarray(s),
                           jnp.asarray(valid), is_back=is_back,
                           stop_s=None if stop_s is None
                           else jnp.asarray(stop_s))
    rc, out = _host_chain(host, td, wv, W, k, l, s, valid, is_back, stop_s)
    assert rc == 0
    for name, g, w, h in zip(("ck", "cl", "cs", "ln"), got, want, out):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w), name
        assert np.array_equal(h, w), name
    ln = out[3]
    assert (ln[~valid] == 0).all()
    if not stop:
        # lanes stopped at the first columns by an ambiguous base, and
        # walked all W where nothing stopped them
        assert set(np.unique(ln[valid])) >= set(range(min(W, 4)))
        assert (ln[valid] == W).any()
    elif W > 1:
        # some lane stopped on its interval, not on an ambiguous base
        nxt = bases[np.arange(U), np.minimum(ln, W - 1)]
        assert (valid & (ln > 0) & (ln < W) & (nxt <= 3)).any()


def test_chain_walk_non_stepping_lanes_read_nothing(host, idx):
    """Invalid lanes and lanes whose first base is ambiguous keep their
    state whatever it is: the kernel reads no row for them, so garbage
    there cannot fault even without fill_oob."""
    _, td = idx
    ks = garbage(td)
    U, W = len(ks), 8
    rng = np.random.default_rng(43)
    bases = rng.integers(0, 4, (U, W))
    bases[::2, 0] = 5
    valid = np.arange(U) % 2 == 0         # valid lanes start ambiguous
    rc, (ck, cl, cs, ln) = _host_chain(host, td, pack(bases), W, ks,
                                       ks[::-1], np.full(U, 9), valid, True,
                                       None)
    assert rc == 0
    dt = _np_dt(td)
    assert (ln == 0).all()
    assert np.array_equal(ck, np.repeat(ks.astype(dt)[:, None], W, 1))
    assert np.array_equal(cl, np.repeat(ks[::-1].astype(dt)[:, None], W, 1))
    assert (cs == 9).all()


# ---------------------------------------------------------------------------
def _host_walk(host, td, kk, steps, alive, n_steps):
    keep, index = _index_args(td)
    dt = _np_dt(td)
    kk, steps = (np.ascontiguousarray(x, dt) for x in (kk, steps))
    alive = np.ascontiguousarray(alive, np.uint8)
    ko, so, ao = np.zeros_like(kk), np.zeros_like(steps), np.zeros_like(alive)
    rc = host.fm_inv_psi_walk_host(
        *index, kk.ctypes.data, steps.ctypes.data, alive.ctypes.data,
        n_steps, td.sa_intv - 1, ko.ctypes.data, so.ctypes.data,
        ao.ctypes.data, len(kk), int(td.dtype == torch.int64), None, 0,
        None)
    return rc, (ko, so, ao.astype(bool))


def _jax_walk(jd, kk, steps, alive, n_steps):
    """inv_psi_batch stepped as sa_batch_compact's run() steps it."""
    mask = jd.sa_intv - 1
    kk, steps, alive = (jnp.asarray(x) for x in (kk, steps, alive))
    for _ in range(n_steps):
        kk2 = jnp.where(alive, jfm.inv_psi_batch(jd, kk), kk)
        steps = steps + alive.astype(steps.dtype)
        alive = alive & ((kk2 & mask) != 0)
        kk = kk2
    return np.asarray(kk), np.asarray(steps), np.asarray(alive)


@pytest.mark.parametrize("mult", [0, 1, 2], ids=["1", "sa_intv",
                                                 "2sa_intv"])
def test_inv_psi_walk_three_ways(host, idx, mult):
    """Kernel lane code == ops/fm._walk on CPU tensors == inv_psi_batch
    stepped as in JAX, for n_steps in {1, sa_intv, 2 sa_intv}: lanes on
    sampled rows (dead from the start), primary and its neighbours, dead
    lanes on unsampled rows, and carried step counts."""
    jd, td = idx
    n_steps = max(1, mult * td.sa_intv)
    rng = np.random.default_rng(47 + mult)
    kk, steps, alive = sa_lanes(td, rng, 445)
    got = tfm._walk(td, _t(kk), _t(steps), _t(alive), n_steps)
    want = _jax_walk(jd, kk, steps, alive, n_steps)
    rc, out = _host_walk(host, td, kk, steps, alive, n_steps)
    assert rc == 0
    for name, g, w, h in zip(("kk", "steps", "alive"), got, want, out):
        assert np.array_equal(g.numpy(), w), name
        assert np.array_equal(h, w), name
    # some lanes finish inside the segment, and with n_steps = 1 some
    # are still walking
    done_now = alive & ~out[2]
    assert done_now.any()
    if n_steps == 1:
        assert out[2].any()


def test_inv_psi_walk_garbage_lanes(host, idx):
    """Garbage rows under fill_oob read all-ones words, as JAX's gather
    does; without it the lane faults."""
    jd, td = idx
    ks = garbage(td)
    ks = ks[ks >= 0]                    # inv_psi_batch requires k >= 0
    dt = _np_dt(td)
    kk = (ks | 1).astype(dt)
    steps = np.zeros(len(kk), dt)
    alive = np.ones(len(kk), bool)
    oob = dataclasses.replace(td, fill_oob=True)
    want = _jax_walk(jd, kk, steps, alive, 3)
    got = tfm._walk(oob, _t(kk), _t(steps), _t(alive), 3)
    rc, out = _host_walk(host, oob, kk, steps, alive, 3)
    assert rc == 0
    for g, w, h in zip(got, want, out):
        assert np.array_equal(g.numpy(), w)
        assert np.array_equal(h, w)
    big = np.array([td.n_rows * 128 + 5], dt)
    assert _host_walk(host, td, big, big * 0, np.ones(1, bool), 1)[0] == -1


# ---------------------------------------------------------------------------
def _cases(td):
    ik = torch.zeros((4, 3), dtype=td.dtype)
    return dict(
        extend=lambda **kw: fm_cuda._launch_extend_sel(
            td, kw.get("ik", ik),
            kw.get("c", torch.zeros(4, dtype=torch.int32)), False),
        chain=lambda **kw: fm_cuda._launch_chain_walk(
            td, kw.get("wv", torch.zeros(4, dtype=torch.int64)),
            kw.get("W", 5), kw.get("k", ik[:, 0].contiguous()),
            ik[:, 1].contiguous(), ik[:, 2].contiguous(),
            kw.get("valid", torch.ones(4, dtype=torch.bool)), False, None),
        walk=lambda **kw: fm_cuda.inv_psi_walk(
            td, kw.get("kk", ik[:, 0].contiguous()), ik[:, 1].contiguous(),
            kw.get("alive", torch.ones(4, dtype=torch.bool)), 3))


@pytest.mark.parametrize("kernel", ["extend", "chain", "walk"])
def test_wrappers_check_inputs(idx, kernel):
    """The launchers raise on a dtype, shape or device they do not take,
    and on CPU tensors."""
    _, td = idx
    run = _cases(td)[kernel]
    other = torch.int32 if td.dtype == torch.int64 else torch.int64
    bad = {
        "extend": [dict(ik=torch.zeros((4, 3), dtype=other)),
                   dict(ik=torch.zeros((4, 4), dtype=td.dtype)),
                   dict(c=torch.zeros(4, dtype=torch.int64)),
                   dict(c=torch.zeros(4, dtype=torch.int32, device="meta"))],
        "chain": [dict(k=torch.zeros(4, dtype=other)),
                  dict(wv=torch.zeros(4, dtype=torch.int32)),
                  dict(valid=torch.ones(3, dtype=torch.bool)),
                  dict(valid=torch.ones(4, dtype=torch.bool, device="meta")),
                  dict(W=11), dict(W=0)],
        "walk": [dict(kk=torch.zeros(4, dtype=other)),
                 dict(alive=torch.ones(4, dtype=torch.uint8)),
                 dict(kk=torch.zeros((4, 1), dtype=td.dtype)),
                 dict(alive=torch.ones(4, dtype=torch.bool, device="meta"))],
    }[kernel]
    for kw in bad:
        with pytest.raises((TypeError, ValueError)):
            run(**kw)
    with pytest.raises(ValueError, match="CUDA"):
        run()


def test_dispatch_rejects_other_devices(idx):
    """The port's entry points take the plain version for CPU tensors only;
    any other device goes to the launcher, which launches the kernel or
    raises.  The launchers raise on CPU tensors too."""
    _, td = idx
    for dev in ("meta", "cpu"):
        m = torch.zeros((4, 3), dtype=td.dtype, device=dev)
        b = torch.ones(4, dtype=torch.bool, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            fm_cuda.extend_sel_batch(td, m, m[:, 0], False)
        with pytest.raises(ValueError, match="CUDA"):
            fm_cuda.chain_walk(td, m[:, 0], 5, m[:, 0], m[:, 1], m[:, 2], b)
        with pytest.raises(ValueError, match="CUDA"):
            fm_cuda.inv_psi_walk(td, m[:, 0], m[:, 1], b, 1)
    m = torch.zeros((4, 3), dtype=td.dtype, device="meta")
    b = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfm.extend_sel_batch(td, m, m[:, 0], False)
    with pytest.raises(ValueError, match="CUDA"):
        tss._chain_walk(td, m[:, 0], 5, m[:, 0], m[:, 1], m[:, 2], b)
    with pytest.raises(ValueError, match="CUDA"):
        tfm._walk(td, m[:, 0], m[:, 1], b, 1)


def test_plain_versions_only_for_cpu_tensors():
    """Source scan: each entry point (ops/fm.py's extend_sel_batch and
    _walk, ops/seedscan.py's _chain_walk) reaches its plain version only
    under ``if <tensor>.device.type == "cpu":``, and each route (the
    lockstep loops' _scan_route, _walk_route and _fwd_route, the round
    loops' _chain_round and _walk_round, ops/fm.py's _sa_loop and
    _sa_compact) only under ``if dev.type == "cpu":``; ops/fm_cuda.py,
    ops/lockstep_cuda.py and ops/cuda_lib.py never reach a plain version,
    no ``try`` wraps a launch, and no environment knob selects a path."""
    from compseed_tpu_torch.ops import cuda_lib, lockstep_cuda
    for mod in (fm_cuda, lockstep_cuda, cuda_lib):
        src = inspect.getsource(mod)
        nodes = list(ast.walk(ast.parse(src)))
        names = [n.id if isinstance(n, ast.Name) else n.attr for n in nodes
                 if isinstance(n, (ast.Name, ast.Attribute))] + \
            [a.name for n in nodes if isinstance(n, ast.ImportFrom)
             for a in n.names]
        assert not [x for x in names if x.endswith("_plain")], mod.__name__
        assert "environ" not in src, mod.__name__
        assert not any(isinstance(n, ast.Try) for n in nodes), mod.__name__

    def cpu_test(node):
        return isinstance(node, ast.If) and re.fullmatch(
            r"\w+\.device\.type == 'cpu'", ast.unparse(node.test))

    for fn in (tfm.extend_sel_batch, tfm._walk, tss._chain_walk):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name)
                 and n.func.id.endswith("_plain")]
        assert len(calls) == 1, fn.__name__
        assert any(cpu_test(n) and any(x is calls[0] for x in ast.walk(n))
                   for n in ast.walk(tree)), fn.__name__
    for fn in (fm_cuda._launch_extend_sel, fm_cuda._launch_chain_walk,
               fm_cuda.inv_psi_walk):
        assert "_cuda_device(" in inspect.getsource(fn), fn.__name__
    for fn in (tss._scan_route, tss._walk_route, tss._fwd_route,
               tss._chain_round, tss._walk_round, tfm._sa_loop,
               tfm._sa_compact):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        plain = [n for n in ast.walk(tree) if isinstance(n, ast.Name)
                 and n.id.endswith("_plain")]
        assert len(plain) == 1, fn.__name__
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
        assert any(isinstance(n, ast.If) and ast.unparse(n.test) ==
                   "dev.type == 'cpu'" and any(x is plain[0] for x in
                                               ast.walk(n.body[0]))
                   for n in ast.walk(tree)), fn.__name__


def test_port_entry_points_dispatch_through_fm_cuda():
    """extend_sel_batch, _walk (and so sa_batch's and sa_batch_compact's
    plain versions), the kernel routes of sa_batch's loop and of
    sa_batch_compact (fm_cuda.SaLoop) and _chain_walk go through
    ops/fm_cuda.py."""
    assert "fm_cuda.extend_sel_batch(" in inspect.getsource(
        tfm.extend_sel_batch)
    assert "fm_cuda.inv_psi_walk(" in inspect.getsource(tfm._walk)
    assert "_sa_loop(" in inspect.getsource(tfm.sa_batch)
    assert "_walk(" in inspect.getsource(tfm._sa_loop_plain)
    assert "fm_cuda.SaLoop(" in inspect.getsource(tfm._sa_loop_kernels)
    assert "_walk(" in inspect.getsource(tfm._sa_batch_compact_plain)
    assert "fm_cuda.SaLoop(" in inspect.getsource(
        tfm._sa_batch_compact_kernels)
    assert "fm_cuda.chain_walk(" in inspect.getsource(tss._chain_walk)
    # the staged forward walk: its plain version's extensions go through
    # extend_sel_batch, its kernel route through ops/lockstep_cuda.py
    assert "extend_sel_batch(" in inspect.getsource(
        tss._fwd_stage_walk_plain)
    assert "lockstep_cuda.fwd_stage(" in inspect.getsource(
        tss._fwd_stage_walk_kernel)
    assert "_fwd_route(" in inspect.getsource(tss._fwd_stage_walk)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["lep", "r3"])
def test_chain_scan_report_rounds_vs_jax(tiny_fm, mode):
    """chain_scan(report_rounds=True): the round count and the per-round
    live-lane histogram equal the JAX package's, and the scan's own
    outputs are the same as without the report."""
    from tests.test_torch_seeder import _queries
    queries = _queries("reads.fq", 48)
    R, L = len(queries), 128
    qarr = np.full((R, L), 4, np.uint8)
    rl = np.zeros(R, np.int32)
    for i, q in enumerate(queries):
        qarr[i, :len(q)] = q
        rl[i] = len(q)
    GP = 48 * R
    kw = dict(mode="r3", min_len=20, max_intv=20) if mode == "r3" else {}
    jd = jax_to_device(tiny_fm)
    td = to_device(convert.fmindex_from_jax_package(tiny_fm), CPU)
    want = jss.chain_scan(jd, jnp.asarray(qarr), jnp.asarray(rl), GP,
                          jss.make_chain_memo(256, 128, 5, jd.dtype), W=5,
                          report_rounds=True, **kw)
    got = tss.chain_scan(td, _t(qarr), _t(rl), GP,
                         tss.make_chain_memo(256, 128, 5, td.dtype, CPU),
                         W=5, report_rounds=True, **kw)
    plain = tss.chain_scan(td, _t(qarr), _t(rl), GP,
                           tss.make_chain_memo(256, 128, 5, td.dtype, CPU),
                           W=5, **kw)
    assert len(got) == 8 and len(plain) == 6
    rnd, hist = int(got[6]), got[7].numpy()
    assert rnd == int(want[6])
    assert hist.dtype == np.int32 and hist.shape == (3 * L + 16,)
    assert np.array_equal(hist, np.asarray(want[7]))
    assert rnd > 2 and (hist[:rnd] > 0).all() and not hist[rnd:].any()
    assert hist[0] == R
    for g, p, nm in zip(got[:5], plain[:5], ("pool", "n", "ovf", "fq",
                                               "fc")):
        assert torch.equal(g, p), nm
    for kk in tss.MEMO_KEYS:
        assert torch.equal(got[5][kk], plain[5][kk]), kk
