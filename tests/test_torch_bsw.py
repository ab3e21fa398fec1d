"""compseed_tpu_torch's banded-SW DP vs compseed_tpu's, exactly (mirrors
tests/test_ops_bsw.py): the plain version against JAX's _extend_core and
the Pallas kernel in interpret mode, the tile build against JAX's, the
runner's fused dual-round path against the JAX runner, and the CUDA
kernel's per-pair routine compiled for the host — each also with int16
H/E state (COMPSEED_BSW_I16=1) — plus the int16 gate against the JAX
gate and the probe kernel's plain version.  The kernels themselves are
held to their plain versions on the card in tests/test_torch_cuda.py."""

import ctypes as ct
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu_torch import convert
from compseed_tpu_torch.cpu import ksw
from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import BswRunner, _extend_core
from compseed_tpu_torch.pipeline.extension import SeqPair

from torch_dp_cases import GAP, MAT, OPT, dp_tiles

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(tiles, state16=False):
    out = bsw_cuda.bsw_extend_tiles(_t(MAT), *(_t(x) for x in tiles), **GAP,
                                    state16=state16)
    assert out.shape == (tiles[0].shape[0], 8) and out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("seed", [9, 10])
def test_extend_core_vs_jax_extend_core(seed):
    from compseed_tpu.ops.bsw import _extend_core as jax_core
    q, ql, t, tl, h0, ws = dp_tiles(seed)
    want = np.asarray(jax_core(
        *GAP.values(), jnp.asarray(MAT), jnp.asarray(ws[:, 0]),
        jnp.asarray(q.astype(np.uint8)), jnp.asarray(ql[:, 0]),
        jnp.asarray(t.astype(np.uint8)), jnp.asarray(tl[:, 0]),
        jnp.asarray(h0[:, 0])))
    got = _extend_core(*GAP.values(), _t(MAT), _t(ws[:, 0]), _t(q),
                       _t(ql[:, 0]), _t(t), _t(tl[:, 0]), _t(h0[:, 0]))
    assert np.array_equal(got.numpy(), want)
    # the corner cases really occur
    assert (want[2] < tl[:, 0]).sum() > 50            # broke before tlen
    assert (want[4] == -1).sum() > 10                 # never reached qend


def test_plain_vs_pallas_kernel_interpret():
    """bsw_extend_tiles: the port's CPU path equals the Pallas kernel run
    in interpret mode, all eight output columns."""
    from compseed_tpu.ops.bsw_pallas import bsw_extend_tiles as jax_tiles
    tiles = dp_tiles(11)
    q, ql, t, tl, h0, ws = tiles
    want = np.asarray(jax_tiles(
        jnp.asarray(MAT.reshape(1, 25)), jnp.asarray(q), jnp.asarray(ql),
        jnp.asarray(t), jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(ws),
        **GAP, interpret=True))
    assert np.array_equal(_plain(tiles), want)


@pytest.mark.parametrize("seed", [16, 17])
def test_extend_core_state16_vs_pallas_interpret_and_int32(seed):
    """The plain version with int16 H/E rows equals the Pallas kernel in
    interpret mode with state16=True, and the int32 plain version: the
    storage type changes no result while the stored values fit."""
    from compseed_tpu.ops.bsw_pallas import bsw_extend_tiles as jax_tiles
    tiles = dp_tiles(seed)
    q, ql, t, tl, h0, ws = tiles
    want = np.asarray(jax_tiles(
        jnp.asarray(MAT.reshape(1, 25)), jnp.asarray(q), jnp.asarray(ql),
        jnp.asarray(t), jnp.asarray(tl), jnp.asarray(h0), jnp.asarray(ws),
        **GAP, interpret=True, state16=True))
    got = _plain(tiles, state16=True)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _plain(tiles))
    assert int(h0.max()) > 10000             # large h0 lanes are in there


def test_extend_core_state16_rows_are_int16():
    """state16 really narrows the rows: a stored value beyond 16 bits
    wraps (so the gate matters), while int32 rows keep it."""
    q, ql, t, tl, h0, ws = dp_tiles(18, P=8)
    h0[:] = 40000
    tiles = (q, ql, t, tl, h0, ws)
    wide, narrow = _plain(tiles), _plain(tiles, state16=True)
    assert (wide[:, 0] >= 40000).all()
    assert not np.array_equal(wide, narrow)


def _host_lib(tmp_path, *defines):
    so = str(tmp_path / "libbsw_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", *defines, "-o", so, bsw_cuda._SRC], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    p, i, ll = ct.c_void_p, ct.c_int, ct.c_longlong
    for fn in (lib.bsw_extend_host, lib.bsw_extend_host_i16,
               lib.bsw_extend_host_staged, lib.bsw_extend_host_staged_i16):
        fn.argtypes = [p] * 10 + [i] * 8
        fn.restype = None
    for fn in (lib.bsw_meta_dual_host, lib.bsw_meta_dual_host_i16):
        fn.argtypes = [p, p, ll, p, ll, p, p, i, i, i, i, ll] + [i] * 7
        fn.restype = None
    lib.bsw_pair_bytes.argtypes = [i, i]
    lib.bsw_pair_bytes.restype = ll
    return lib


def _host_run(fn, sdt, tiles, T):
    q, ql, t, tl, h0, ws = tiles
    P, Q = q.shape
    out = np.zeros((P, 8), np.int32)
    hb = np.zeros((Q + 1) * P, sdt)
    eb = np.zeros_like(hb)
    mat = np.ascontiguousarray(MAT.reshape(-1))
    fn(*(a.ctypes.data for a in (mat, q, ql, t, tl, h0, ws, out, hb, eb)),
       P, Q, T, *GAP.values())
    return out


def test_kernel_source_host_build(tmp_path):
    """csrc/bsw_extend.cu compiled as plain C++ exposes the kernel's
    per-pair routine through a host loop; it must equal the plain version
    on the DP corner cases (the card itself runs it in chip_smoke.py and
    tests/test_torch_cuda.py)."""
    lib = _host_lib(tmp_path)
    for seed, T in ((12, 256), (13, 128)):
        tiles = [np.ascontiguousarray(x) for x in dp_tiles(seed, T=T)]
        out = _host_run(lib.bsw_extend_host, np.int32, tiles, T)
        assert np.array_equal(out, _plain(tiles)), seed


def test_kernel_source_host_build_int16(tmp_path):
    """The templated routine's int16 entry: equal to the plain int16
    version and to the int32 entry under the gate, and equal to the plain
    int16 version where stored values wrap (h0 beyond 16 bits)."""
    lib = _host_lib(tmp_path)
    for seed, T in ((12, 256), (13, 128)):
        tiles = [np.ascontiguousarray(x) for x in dp_tiles(seed, T=T)]
        out = _host_run(lib.bsw_extend_host_i16, np.int16, tiles, T)
        assert np.array_equal(out, _plain(tiles, state16=True)), seed
        assert np.array_equal(
            out, _host_run(lib.bsw_extend_host, np.int32, tiles, T)), seed
    tiles[4][::3] = 40000
    out = _host_run(lib.bsw_extend_host_i16, np.int16, tiles, T)
    assert np.array_equal(out, _plain(tiles, state16=True))
    assert not np.array_equal(out, _plain(tiles))


@pytest.mark.parametrize("hoist", [0, 1])
def test_kernel_source_host_build_scratch_loop_bodies(tmp_path, hoist):
    """The scratch variant's inner loop with a cell's inputs read at the
    cell (BSW_SCRATCH_HOIST=0) and ahead of the previous cell's stores (1):
    both equal the plain version, int32 and int16 rows."""
    lib = _host_lib(tmp_path, f"-DBSW_SCRATCH_HOIST={hoist}")
    tiles = [np.ascontiguousarray(x) for x in dp_tiles(12, T=256)]
    assert np.array_equal(_host_run(lib.bsw_extend_host, np.int32, tiles,
                                    256), _plain(tiles))
    assert np.array_equal(_host_run(lib.bsw_extend_host_i16, np.int16, tiles,
                                    256), _plain(tiles, state16=True))


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
def test_kernel_source_host_build_staged_query(tmp_path, state16):
    """The shared-memory kernel's route through the per-pair routine (the
    query staged as 3-bit codes, eight to a word, rows at the block's
    stride) equals the plain version and the tile route."""
    lib = _host_lib(tmp_path)
    sdt = np.int16 if state16 else np.int32
    staged = lib.bsw_extend_host_staged_i16 if state16 else \
        lib.bsw_extend_host_staged
    tiled = lib.bsw_extend_host_i16 if state16 else lib.bsw_extend_host
    for seed, Q, T in ((12, 128, 256), (13, 128, 128), (19, 256, 128)):
        tiles = [np.ascontiguousarray(x) for x in dp_tiles(seed, Q=Q, T=T)]
        out = _host_run(staged, sdt, tiles, T)
        assert np.array_equal(out, _plain(tiles, state16=state16)), seed
        assert np.array_equal(out, _host_run(tiled, sdt, tiles, T)), seed


def _dual_meta(micro, seed, w0, n=300, P=512):
    """A (P, 12) pair table as BswRunner.run_meta_dual packs it, over a
    numpy-seeded read matrix and the micro reference: forward and reverse
    lanes, pairs that cross l_pac on both strands, off-diagonal pairs that
    the narrow band rejects, a tlen=0 lane, pad lanes, and prev scores
    that hit the score-unchanged clause on every fifth lane."""
    _, _, fm = micro
    qarr, qmeta, rmeta, h0, _ = _meta_pairs(micro, seed, n)
    l_pac = fm.l_pac
    rng = np.random.default_rng(seed + 1)
    for p in range(0, n, 6):                 # straddle the strand mirror
        tl = int(rmeta[p, 1])
        k = int(rng.integers(0, tl + 1))
        rmeta[p, 0] = l_pac - k if qmeta[p, 3] == 0 else l_pac + k - 1
    runner = BswRunner(OPT, np.array(OPT.mat), CPU)
    qlens = qmeta[:, 2].astype(np.int32)
    meta = np.zeros((P, 12), np.int32)
    meta[:n, 0:4] = qmeta
    meta[:n, 4] = (rmeta[:, 0] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    meta[:n, 5] = (rmeta[:, 0] >> 32).astype(np.int32)
    meta[:n, 6] = rmeta[:, 1]
    meta[:, 7] = 1
    meta[:n, 7] = h0
    meta[:, 8] = -2
    meta[:n, 8] = -1
    meta[:n, 9] = runner._bands(qlens, w0, OPT.pen_clip5)
    meta[:n, 10] = runner._bands(qlens, 2 * w0, OPT.pen_clip5)
    return qarr, meta


_DUAL_KW = dict(Q=256, T=256, **GAP)


@pytest.mark.parametrize("state16,w0,wide,pallas", [
    (False, 8, False, True), (True, 8, False, True), (False, 1, False, False),
    (False, 8, True, False), (True, 1, True, False)],
    ids=["int32-w8", "int16-w8", "int32-w1", "int32-w8-wide", "int16-w1-wide"])
def test_meta_dual_host_build_vs_plain_and_jax(micro, tmp_path, state16, w0,
                                               wide, pallas):
    """The fused per-pair routine (decode from the read matrix and the
    packed reference, round 0, acceptance, round 1) built for the host
    equals the plain _meta_dual_core and the JAX _meta_dual_core (its Pallas
    kernel in interpret mode, or its plain DP), all eight columns;
    tolerance 0, the results are integers.  The JAX call takes narrow r0
    (this reference is far below 2**31, so the high word is 0)."""
    from compseed_tpu.ops.bsw import _meta_dual_core as jax_dual
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    from compseed_tpu_torch.ops.bsw import _meta_dual_core
    from compseed_tpu_torch.ops.device_index import to_device

    _, _, fm = micro
    qarr, meta = _dual_meta(micro, 200 + w0, w0)
    R, L = qarr.shape
    td = to_device(convert.fmindex_from_jax_package(fm), CPU)
    kw = dict(_DUAL_KW, L=L, l_pac=fm.l_pac, w0=w0)

    def plain(m):
        return _meta_dual_core(_t(MAT), _t(qarr.reshape(-1)), td.pac_words,
                               _t(m), **kw, wide_r0=wide,
                               state16=state16).numpy()

    first = plain(meta)
    n = int((meta[:, 8] == -1).sum())
    meta[:n:5, 8] = first[:n:5, 0]           # score-unchanged acceptance
    want = plain(meta)
    assert 0 < int(want[:n, 6].sum()) < n    # both rounds are used
    assert (want[:n:5, 6] == 0).all()
    # pad lanes: rejected only where the acceptance is 0 < 0
    assert (want[n:, 6] == (1 if w0 == 1 else 0)).all()
    assert (want[n:, 0] == 1).all()

    lib = _host_lib(tmp_path)
    fn = lib.bsw_meta_dual_host_i16 if state16 else lib.bsw_meta_dual_host
    pac = np.ascontiguousarray(td.pac_words.numpy())
    qflat = np.ascontiguousarray(qarr.reshape(-1))
    mat = np.ascontiguousarray(MAT.reshape(-1))
    meta = np.ascontiguousarray(meta)
    out = np.full((len(meta), 8), -7, np.int32)
    fn(mat.ctypes.data, qflat.ctypes.data, R, pac.ctypes.data, len(pac),
       meta.ctypes.data, out.ctypes.data, len(meta), kw["Q"], kw["T"], L,
       fm.l_pac, *GAP.values(), w0, int(wide))
    assert np.array_equal(out, want)

    jd = jax_to_device(fm)
    jmat = jnp.asarray(MAT.reshape(1, 25) if pallas else MAT)
    jout = np.asarray(jax_dual(
        jmat, jnp.asarray(qflat), jd.pac_words, jnp.asarray(meta), **kw,
        use_pallas=pallas, interpret=pallas, state16=state16))
    assert np.array_equal(out, jout)


@pytest.mark.parametrize("state16,w0,wide", [(False, 5, False),
                                             (True, 100, True)],
                         ids=["int32-w5", "int16-w100-wide"])
def test_meta_dual_host_build_on_seeded_extension_pairs(micro, tmp_path,
                                                        state16, w0, wide):
    """The pair tables that the card's checks use (ops/bsw_cases.py: seed
    extensions on both strands, reads across l_pac, insertions) through
    the fused routine's host build and the plain version."""
    from compseed_tpu_torch.index.build import unpack_pac
    from compseed_tpu_torch.ops.bsw import _meta_dual_core
    from compseed_tpu_torch.ops.bsw_cases import dual_meta_case
    from compseed_tpu_torch.ops.device_index import to_device
    _, _, fm = micro
    ref = unpack_pac(fm.pac, fm.l_pac)
    qarr, meta = dual_meta_case(np.random.default_rng(w0), ref, n=200, P=256,
                                Q=128, T=256, w0=w0, opt=OPT, wide_r0=wide)
    R, L = qarr.shape
    td = to_device(convert.fmindex_from_jax_package(fm), CPU)
    kw = dict(Q=128, T=256, L=L, l_pac=fm.l_pac, **GAP, w0=w0)
    want = _meta_dual_core(_t(MAT), _t(qarr.reshape(-1)), td.pac_words,
                           _t(meta), **kw, wide_r0=wide,
                           state16=state16).numpy()
    assert (want[:200, 0] > 40).sum() > 100           # real alignments
    if w0 == 5:
        assert 0 < int(want[:200, 6].sum()) < 200     # both rounds
    lib = _host_lib(tmp_path)
    fn = lib.bsw_meta_dual_host_i16 if state16 else lib.bsw_meta_dual_host
    pac = np.ascontiguousarray(td.pac_words.numpy())
    qflat = np.ascontiguousarray(qarr.reshape(-1))
    mat = np.ascontiguousarray(MAT.reshape(-1))
    out = np.full((len(meta), 8), -7, np.int32)
    fn(mat.ctypes.data, qflat.ctypes.data, R, pac.ctypes.data, len(pac),
       meta.ctypes.data, out.ctypes.data, len(meta), 128, 256, L, fm.l_pac,
       *GAP.values(), w0, int(wide))
    assert np.array_equal(out, want)


def test_meta_dual_plain_dp_switch(micro):
    """The tile route's two DPs on CPU tensors: _meta_dual_plain (the DP
    as _extend_core, what the card's comparisons run) equals the route
    through the tile wrapper, and _meta_dual_core runs the plain version
    there."""
    from compseed_tpu_torch.ops.bsw import (_meta_dual_core,
                                            _meta_dual_plain,
                                            _meta_dual_tiles)
    from compseed_tpu_torch.ops.device_index import to_device
    _, _, fm = micro
    qarr, meta = _dual_meta(micro, 300, 8, n=100, P=128)
    td = to_device(convert.fmindex_from_jax_package(fm), CPU)
    args = (_t(MAT), _t(qarr.reshape(-1)), td.pac_words, _t(meta))
    kw = dict(_DUAL_KW, L=qarr.shape[1], l_pac=fm.l_pac, w0=8)
    want = _meta_dual_plain(*args, **kw)
    assert torch.equal(want, _meta_dual_core(*args, **kw))
    assert torch.equal(want, _meta_dual_tiles(bsw_cuda.bsw_extend_tiles,
                                              *args, **kw))
    with pytest.raises(ValueError, match="unsupported device"):
        bsw_cuda.bsw_meta_dual(*args, **kw)


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("Q", [128, 256, 512])
def test_block_threads_fit_shared_memory(tmp_path, Q, state16):
    """The threads-per-block choice is a whole number of warps whose rows
    fit a block's 232,448 bytes of shared memory with the kernels' static
    part, and the pair size equals the kernel source's."""
    t = bsw_cuda.block_threads(Q, state16)
    b = bsw_cuda.pair_bytes(Q, state16)
    assert t in (32, 64, 128, 256)
    assert t * b + bsw_cuda._SMEM_STATIC <= 232448 == bsw_cuda.SMEM_PER_BLOCK
    assert b == _host_lib(tmp_path).bsw_pair_bytes(Q, int(state16))
    assert b == (Q + 1) * 2 * (2 if state16 else 4) + Q // 8 * 4


def test_block_threads_names_the_gmem_class():
    """Where even 32 pairs' rows do not fit, the choice is 0: the class of
    the device-memory-scratch kernel (bsw_extend_kernel_gmem).  That is
    Q >= 1024 with int32 rows and Q >= 2048 with int16 rows."""
    got = {(Q, s): bsw_cuda.block_threads(Q, s)
           for Q in (128, 256, 512, 1024, 2048, 4096) for s in (False, True)}
    gmem = sorted(k for k, v in got.items() if v == 0)
    assert gmem == [(1024, False), (2048, False), (2048, True),
                    (4096, False), (4096, True)]
    assert got[(128, False)] == 32 and got[(128, True)] == 64
    assert "bsw_extend_kernel_gmem" in bsw_cuda.LAUNCHES
    for (Q, s), t in got.items():
        if t == 0:
            assert 32 * bsw_cuda.pair_bytes(Q, s) > bsw_cuda.SMEM_PER_BLOCK


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of running somewhere else."""
    tiles = [_t(x).to("meta") for x in dp_tiles(15, P=8)]
    with pytest.raises(ValueError, match="unsupported device"):
        bsw_cuda.bsw_extend_tiles(_t(MAT).to("meta"), *tiles, **GAP)


def test_build_tiles_vs_jax(micro):
    """Packed-word tile build vs JAX's build_tiles and the per-element
    build_tiles_ref oracle: forward/reverse pairs on both strands,
    windows straddling the strand mirror, row-end padding, Ns."""
    from compseed_tpu.ops.bsw_pallas import build_tiles, build_tiles_ref
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    from compseed_tpu_torch.ops.device_index import to_device

    _, _, fm = micro
    jd = jax_to_device(fm)
    td = to_device(fm, CPU)
    l_pac = fm.l_pac
    rng = np.random.default_rng(31)
    R, L = 24, 128
    qarr = np.full((R, L), 4, np.uint8)
    for i in range(R):
        ln = int(rng.integers(40, L - 1))
        qarr[i, :ln] = rng.integers(0, 5, ln)
    Q, T, n = 128, 256, 257
    qmeta = np.zeros((n, 4), np.int32)
    r0 = np.zeros(n, np.int64)
    rlen = np.zeros(n, np.int32)
    for p in range(n):
        rid, rev = int(rng.integers(0, R)), int(rng.integers(0, 2))
        ql = int(rng.integers(1, 120))
        q0 = int(rng.integers(0, L - ql)) if rev == 0 else \
            int(rng.integers(ql - 1, L))
        tl = int(rng.integers(0, 180))
        if p % 5 == 0:                       # straddle the strand mirror
            r0[p] = l_pac - int(rng.integers(0, tl + 1)) if rev == 0 else \
                l_pac + int(rng.integers(0, tl + 1)) - 1
        elif rev == 0:
            r0[p] = int(rng.integers(0, max(2 * l_pac - tl, 1)))
        else:
            r0[p] = int(rng.integers(max(tl - 1, 0), 2 * l_pac))
        qmeta[p] = (rid, q0, ql, rev)
        rlen[p] = tl
    kw = dict(Q=Q, T=T, L=L, l_pac=l_pac)
    jargs = (jnp.asarray(qarr.reshape(-1)), jd.pac_words, jnp.asarray(qmeta),
             jnp.asarray(r0.astype(np.int32)), jnp.asarray(rlen))
    ref = [np.asarray(x) for x in build_tiles_ref(*jargs, **kw)]
    jax_ = [np.asarray(x) for x in build_tiles(*jargs, **kw)]
    got = bsw_cuda.build_tiles(_t(qarr.reshape(-1)), td.pac_words,
                               _t(qmeta), _t(r0.astype(np.int32)), _t(rlen),
                               **kw)
    for j, name in enumerate(("qt", "ql", "tt")):
        assert np.array_equal(got[j].numpy(), ref[j]), name
        assert np.array_equal(got[j].numpy(), jax_[j]), name


def _meta_pairs(micro, seed, n, R=16, L=256):
    """Pair metadata over a random read matrix and the micro reference."""
    from compseed_tpu_torch.index.build import unpack_pac
    _, _, fm = micro
    pac = unpack_pac(fm.pac, fm.l_pac)
    l_pac = fm.l_pac
    rng = np.random.default_rng(seed)
    qarr = np.full((R, L), 4, np.uint8)
    starts = rng.integers(0, l_pac - 200, R)
    for i in range(R):
        if i % 2:
            rl = int(rng.integers(40, 200))
            qarr[i, :rl] = rng.integers(0, 4, rl)
        else:       # reference + a 7-base insertion: off-diagonal DP
            seg = pac[starts[i]:starts[i] + 180]
            qarr[i, :187] = np.concatenate(
                [seg[:60], rng.integers(0, 4, 7), seg[60:]])
    qmeta = np.zeros((n, 4), np.int32)
    rmeta = np.zeros((n, 2), np.int64)
    h0 = np.zeros(n, np.int32)
    for p in range(n):
        rid, rev = int(rng.integers(0, R)), int(rng.integers(0, 2))
        if p % 3 == 1:
            rid = 2 * int(rng.integers(0, R // 2))
            qmeta[p] = (rid, 0, 187, 0)
            rmeta[p] = (starts[rid], 180)
            h0[p] = 30
            continue
        qlen = int(rng.integers(129, 201)) if p % 4 == 0 else \
            int(rng.integers(1, 129))
        q0 = int(rng.integers(0, L - qlen + 1)) if rev == 0 else \
            int(rng.integers(qlen - 1, L))
        tlen = 0 if p == 11 else int(rng.integers(1, 180))
        if rev == 0:
            r0 = int(rng.integers(0, 2 * l_pac - tlen))
        else:
            r0 = int(rng.integers(tlen - 1, 2 * l_pac)) if tlen else 0
        qmeta[p] = (rid, q0, qlen, rev)
        rmeta[p] = (r0, tlen)
        h0[p] = int(rng.integers(1, 120))
    return qarr, qmeta, rmeta, h0, pac


def _dual_vs_jax(micro, force, h0_big=False):
    from compseed_tpu.ops.bsw import BswRunner as JaxRunner
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    from compseed_tpu_torch.ops.device_index import to_device

    _, _, fm = micro
    qarr, qmeta, rmeta, h0, _ = _meta_pairs(micro, 123, 160)
    if h0_big:                     # trips the int16 gate in the Q=128 class
        h0[np.nonzero(qmeta[:, 2] <= 128)[0][:3]] = 31900
    L = qarr.shape[1]
    w, pen = 8, OPT.pen_clip5      # narrow band => many round-1 retries
    prev = np.full(len(h0), -1, np.int32)
    jr = JaxRunner(OPT, np.array(OPT.mat), use_pallas=True,
                   dfi=jax_to_device(fm, force_dtype=force))
    jr.interpret = True
    jr.set_query_context(jnp.asarray(qarr), L)
    first = jr.run_meta_dual(qmeta, rmeta, h0, prev, w, pen)
    prev[::5] = first[0][::5]      # score-unchanged acceptance clause
    want = jr.run_meta_dual(qmeta, rmeta, h0, prev, w, pen)

    tr = BswRunner(OPT, np.array(OPT.mat), CPU,
                   dfi=to_device(convert.fmindex_from_jax_package(fm), CPU,
                                 force_dtype=force))
    assert tr.state16 == jr.state16
    assert not tr.supports_meta_dual
    tr.set_query_context(_t(qarr), L)
    assert tr.supports_meta_dual
    got = tr.run_meta_dual(qmeta, rmeta, h0, prev, w, pen)
    assert len(got) == 7
    for j in range(7):
        assert got[j].flags.c_contiguous and got[j].dtype == np.int32
        assert np.array_equal(got[j], want[j]), j
    assert 0 < int(got[6].sum()) < len(h0)            # both rounds used
    return tr


@pytest.mark.parametrize("force", [None, np.int64], ids=["int32", "int64"])
def test_run_meta_dual_vs_jax_runner(micro, force):
    """run_meta_dual (both band rounds + retry acceptance on the device)
    equals the JAX runner's Pallas path in interpret mode, all seven
    columns, over two query-length classes; int64 exercises wide_r0."""
    _dual_vs_jax(micro, force)


@pytest.mark.parametrize("h0_big", [False, True], ids=["gate-holds",
                                                       "gate-trips"])
def test_run_meta_dual_state16_vs_jax_runner(micro, monkeypatch, h0_big):
    """The same under COMPSEED_BSW_I16=1 in both packages: the gate picks
    int16 rows per query-length class (and int32 rows for a class whose
    h0 is too large), and the seven columns still equal the JAX runner's."""
    monkeypatch.setenv("COMPSEED_BSW_I16", "1")
    seen = []
    launch = bsw_cuda.bsw_extend_tiles

    def spy(*a, **kw):
        seen.append((a[1].shape[1], kw["state16"]))
        return launch(*a, **kw)

    monkeypatch.setattr(bsw_cuda, "bsw_extend_tiles", spy)
    tr = _dual_vs_jax(micro, None, h0_big=h0_big)
    assert tr.state16
    assert (256, True) in seen
    assert (128, not h0_big) in seen and (128, h0_big) not in seen


def test_use16_gate_vs_jax(monkeypatch):
    """BswRunner._use16 equals the JAX gate over a grid of (Q, h0max),
    for two gap settings, and is off without COMPSEED_BSW_I16=1."""
    from compseed_tpu.ops.bsw import BswRunner as JaxRunner
    from compseed_tpu.options import MemOptions as JaxOptions
    from compseed_tpu_torch.options import MemOptions
    assert not BswRunner(OPT, MAT, CPU)._use16(128, 10)
    monkeypatch.setenv("COMPSEED_BSW_I16", "1")
    n_true = 0
    for gaps in ({}, dict(e_ins=3, e_del=5)):
        jr = JaxRunner(JaxOptions(**gaps), MAT, use_pallas=False)
        tr = BswRunner(MemOptions(**gaps), MAT, CPU)
        for Q in (128, 256, 1024, 4096, 8192, 16384, 32768):
            for h0max in (0, 119, 4000, 16000, 27000, 31000, 31744, 31745,
                          31999, 40000):
                want = jr._use16(Q, h0max)
                assert tr._use16(Q, h0max) == want, (gaps, Q, h0max)
                n_true += want
    assert 20 < n_true < 120


def test_probe_plain_version():
    """The probe's plain version, through its wrapper on a CPU tensor;
    no launch is counted, and other shapes and devices are refused."""
    n0 = dict(bsw_cuda.LAUNCHES)
    x = torch.arange(8 * 128, dtype=torch.int32).reshape(bsw_cuda.PROBE_SHAPE)
    assert torch.equal(bsw_cuda.probe_add_one(x), x + 1)
    y = torch.zeros_like(x)
    assert bsw_cuda.probe_add_one(x, out=y) is y and torch.equal(y, x + 1)
    assert torch.equal(bsw_cuda._probe_plain(torch.zeros(3)), torch.ones(3))
    assert bsw_cuda.LAUNCHES == n0
    with pytest.raises(ValueError, match="unsupported device"):
        bsw_cuda.probe_add_one(x.to("meta"))


def test_run_meta_vs_run_flat(micro):
    """run_meta (metadata tiles on the device) equals run_flat on the
    same pairs given as flat host buffers."""
    from compseed_tpu_torch.ops.device_index import to_device
    qarr, qmeta, rmeta, h0, pac = _meta_pairs(micro, 77, 120)
    l_pac = len(pac)
    qbuf, rbuf = [], []
    for (rid, q0, qlen, rev), (r0, tlen) in zip(qmeta, rmeta):
        qbuf.append(qarr[rid, q0:q0 + qlen] if rev == 0 else
                    qarr[rid, q0 - qlen + 1:q0 + 1][::-1])
        gp = r0 + (np.arange(tlen) if rev == 0 else -np.arange(tlen))
        fwd = gp < l_pac
        pf = np.where(fwd, gp, 2 * l_pac - 1 - gp)
        rbuf.append(np.where(fwd, pac[pf], 3 - pac[pf]).astype(np.uint8))
    qoff = np.concatenate([[0], np.cumsum([len(x) for x in qbuf])])
    roff = np.concatenate([[0], np.cumsum([len(x) for x in rbuf])])
    tr = BswRunner(OPT, np.array(OPT.mat), CPU, dfi=to_device(
        convert.fmindex_from_jax_package(micro[2]), CPU))
    want = tr.run_flat(np.concatenate(qbuf), qoff, np.concatenate(rbuf),
                       roff, h0, OPT.w, OPT.pen_clip5)
    tr.set_query_context(_t(qarr), qarr.shape[1])
    got = tr.run_meta(qmeta, rmeta, h0, OPT.w, OPT.pen_clip5)
    for j in range(6):
        assert np.array_equal(got[j], want[j]), j


@pytest.mark.parametrize("w,pen_clip", [(100, 5), (10, 0)])
def test_runner_vs_ksw_oracle(w, pen_clip):
    """BswRunner.__call__ (flat pairs, Q-class split, tlen sort) against
    the scalar ksw_extend2 oracle, incl. degenerate shapes."""
    rng = np.random.default_rng(31 + w)
    pairs = []
    for _ in range(40):
        tl = int(rng.integers(1, 200))
        t = rng.integers(0, 4, size=tl).astype(np.uint8)
        ql = int(rng.integers(1, min(100, tl + 30)))
        q = np.concatenate([t[:ql], rng.integers(0, 4, max(ql - tl, 0))
                            .astype(np.uint8)])[:ql].copy()
        for _ in range(int(rng.integers(0, ql // 8 + 1))):
            q[int(rng.integers(0, ql))] = int(rng.integers(0, 4))
        pairs.append(SeqPair(qs=q, rs=t, h0=int(rng.integers(1, 120)),
                             seqid=0, regid=0))
    pairs.append(SeqPair(qs=np.zeros(1, np.uint8), rs=np.zeros(0, np.uint8),
                         h0=19, seqid=0, regid=0))
    pairs.append(SeqPair(qs=np.zeros(1, np.uint8),
                         rs=np.zeros(300, np.uint8), h0=5, seqid=0, regid=0))
    got = BswRunner(OPT, MAT, CPU)(pairs, w, pen_clip)
    for i, sp in enumerate(pairs):
        want = ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, MAT,
                          OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins,
                          w, pen_clip, OPT.zdrop, sp.h0)
        assert got[i] == tuple(want), i


def test_runner_state16_vs_ksw_oracle(monkeypatch):
    """COMPSEED_BSW_I16=1 through the flat-pair interface: still the
    scalar oracle's results."""
    monkeypatch.setenv("COMPSEED_BSW_I16", "1")
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(24):
        tl = int(rng.integers(1, 150))
        t = rng.integers(0, 4, size=tl).astype(np.uint8)
        ql = int(rng.integers(1, min(100, tl + 20)))
        q = np.resize(t, ql).copy()
        q[rng.random(ql) < 0.1] = 0
        pairs.append(SeqPair(qs=q, rs=t, h0=int(rng.integers(1, 120)),
                             seqid=0, regid=0))
    runner = BswRunner(OPT, MAT, CPU)
    assert runner._use16(128, 119)
    got = runner(pairs, 100, 5)
    for i, sp in enumerate(pairs):
        want = ksw.extend(len(sp.qs), sp.qs, len(sp.rs), sp.rs, MAT,
                          OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins,
                          100, 5, OPT.zdrop, sp.h0)
        assert got[i] == tuple(want), i


def test_build_library_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises; nothing falls back."""
    if bsw_cuda.shutil.which("nvcc"):
        pytest.skip("nvcc present")
    monkeypatch.setattr(bsw_cuda, "_SO", os.devnull + ".missing.so")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        bsw_cuda.build_library()
