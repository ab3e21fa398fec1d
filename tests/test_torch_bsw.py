"""compseed_tpu_torch's banded-SW DP vs compseed_tpu's, exactly (mirrors
tests/test_ops_bsw.py): the plain version against JAX's _extend_core and
the Pallas kernel in interpret mode, the tile build against JAX's, the
runner's fused dual-round path against the JAX runner, and the CUDA
kernel's per-pair routine compiled for the host.  The kernel itself is
held to the plain version on the card in tests/test_torch_cuda.py."""

import ctypes as ct
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.cpu import ksw
from compseed_tpu.pipeline.extension import SeqPair
from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import BswRunner, _extend_core

from torch_dp_cases import GAP, MAT, OPT, dp_tiles

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(tiles):
    out = bsw_cuda.bsw_extend_tiles(_t(MAT), *(_t(x) for x in tiles), **GAP)
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


def test_kernel_source_host_build(tmp_path):
    """csrc/bsw_extend.cu compiled as plain C++ exposes the kernel's
    per-pair routine through a host loop; it must equal the plain version
    on the DP corner cases (the card itself runs it in chip_smoke.py and
    tests/test_torch_cuda.py)."""
    so = str(tmp_path / "libbsw_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so, bsw_cuda._SRC], check=True,
                   capture_output=True)
    lib = ct.CDLL(so)
    lib.bsw_extend_host.argtypes = [ct.c_void_p] * 10 + [ct.c_int] * 8
    for seed, T in ((12, 256), (13, 128)):
        tiles = [np.ascontiguousarray(x) for x in dp_tiles(seed, T=T)]
        q, ql, t, tl, h0, ws = tiles
        P, Q = q.shape
        out = np.zeros((P, 8), np.int32)
        hb = np.zeros((Q + 1) * P, np.int32)
        eb = np.zeros_like(hb)
        mat = np.ascontiguousarray(MAT.reshape(-1))
        lib.bsw_extend_host(*(a.ctypes.data for a in
                              (mat, q, ql, t, tl, h0, ws, out, hb, eb)),
                            P, Q, T, *GAP.values())
        assert np.array_equal(out, _plain(tiles)), seed


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
    from compseed_tpu.index.build import unpack_pac
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


@pytest.mark.parametrize("force", [None, np.int64], ids=["int32", "int64"])
def test_run_meta_dual_vs_jax_runner(micro, force):
    """run_meta_dual (both band rounds + retry acceptance on the device)
    equals the JAX runner's Pallas path in interpret mode, all seven
    columns, over two query-length classes; int64 exercises wide_r0."""
    from compseed_tpu.ops.bsw import BswRunner as JaxRunner
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    from compseed_tpu_torch.ops.device_index import to_device

    _, _, fm = micro
    qarr, qmeta, rmeta, h0, _ = _meta_pairs(micro, 123, 160)
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
                   dfi=to_device(fm, CPU, force_dtype=force))
    assert not tr.supports_meta_dual
    tr.set_query_context(_t(qarr), L)
    assert tr.supports_meta_dual
    got = tr.run_meta_dual(qmeta, rmeta, h0, prev, w, pen)
    assert len(got) == 7
    for j in range(7):
        assert got[j].flags.c_contiguous and got[j].dtype == np.int32
        assert np.array_equal(got[j], want[j]), j
    assert 0 < int(got[6].sum()) < len(h0)            # both rounds used


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
    tr = BswRunner(OPT, np.array(OPT.mat), CPU, dfi=to_device(micro[2], CPU))
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


def test_int16_state_gate_raises(monkeypatch):
    monkeypatch.setenv("COMPSEED_BSW_I16", "1")
    r = BswRunner(OPT, MAT, CPU)
    with pytest.raises(NotImplementedError, match="int16"):
        r.run_flat(np.zeros(4, np.uint8), np.array([0, 4]),
                   np.zeros(4, np.uint8), np.array([0, 4]),
                   np.array([10], np.int32), 100, 5)


def test_build_library_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises; nothing falls back."""
    if bsw_cuda.shutil.which("nvcc"):
        pytest.skip("nvcc present")
    monkeypatch.setattr(bsw_cuda, "_SO", os.devnull + ".missing.so")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        bsw_cuda.build_library()
