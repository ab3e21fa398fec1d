"""The hand-written CUDA kernels (the DP with int32 and with int16 state
on shared-memory rows and on the device-memory scratch, the fused
decode + two-round DP, the launch probe) against their plain PyTorch
versions, on the card.
Every test here is marked ``cuda`` and skips without a card.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import (_extend_core, _meta_dual_core,
                                        _meta_dual_plain)

from torch_dp_cases import GAP, MAT, OPT, dp_tiles, dual_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _on(dev, arrays):
    return [torch.from_numpy(a.copy()).to(dev) for a in arrays]


@pytest.mark.parametrize("T", [128, 256])
def test_kernel_vs_plain_on_card(dev, T):
    """Exact equality, all six result columns, at the main path's shapes;
    one launch per call, counted."""
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(14 + T, P=4096, T=T))
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel=n0["bsw_extend_kernel"] + 1)
    assert got.shape == (4096, 8) and got.dtype == torch.int32
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0])
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert not got[:, 6:].any()


@pytest.mark.parametrize("T", [128, 256])
def test_int16_kernel_vs_plain_and_int32_kernel_on_card(dev, T):
    """int16 kernel == plain int16 version == int32 kernel, exactly,
    where the stored values fit 16 bits; one launch per call, counted
    under the int16 kernel's name."""
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(20 + T, P=4096, T=T))
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=True)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_i16=n0["bsw_extend_kernel_i16"] + 1)
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=True)
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert torch.equal(got, bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP))


def test_int16_kernel_wraps_like_its_plain_version_on_card(dev):
    """Beyond the gate (h0 past 16 bits) the int16 kernel still equals
    its plain version, and both differ from the int32 kernel: the rows
    really are 16 bits wide."""
    mat = torch.from_numpy(MAT).to(dev)
    q, ql, t, tl, h0, ws = dp_tiles(33, P=512)
    h0[::3] = 40000
    tiles = _on(dev, (q, ql, t, tl, h0, ws))
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=True)
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=True)
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert not torch.equal(got, bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP))


def test_probe_and_self_check_on_card(dev, monkeypatch):
    """The probe kernel equals x + 1; self_check passes, counts its
    launch, and raises when the expectation is corrupted."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    assert torch.equal(bsw_cuda.probe_add_one(x), bsw_cuda._probe_plain(x))
    bsw_cuda.self_check(dev)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 2
    with pytest.raises(ValueError):
        bsw_cuda.probe_add_one(x[:4].contiguous())
    monkeypatch.setattr(bsw_cuda, "_probe_plain", lambda v: v + 2)
    with pytest.raises(RuntimeError, match="self-check"):
        bsw_cuda.self_check(dev)


def test_engine_runs_self_check_on_card(dev):
    """Building a DP engine on a card launches the probe once: the
    self-check's only site."""
    from compseed_tpu_torch.ops.bsw import BswRunner
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    BswRunner(OPT, MAT, dev)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1


def test_wrapper_checks_inputs_on_card(dev):
    """Wrong dtype, shape or layout raises before any launch."""
    mat = torch.from_numpy(MAT).to(dev)
    q, ql, t, tl, h0, ws = _on(dev, dp_tiles(3, P=64))
    n0 = dict(bsw_cuda.LAUNCHES)
    for args, err in (
            ((mat, q.to(torch.int32), ql, t, tl, h0, ws), TypeError),
            ((mat, q, ql[:32], t, tl, h0, ws), ValueError),
            ((mat, q, ql, t.t().contiguous().t(), tl, h0, ws), ValueError),
            ((mat, q, ql.cpu(), t, tl, h0, ws), ValueError)):
        with pytest.raises(err):
            bsw_cuda.bsw_extend_tiles(*args, **GAP)
    assert bsw_cuda.LAUNCHES == n0


def _plain_tiles(mat, tiles, state16=False):
    q, ql, t, tl, h0, ws = tiles
    return _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=state16).T.cpu()


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("Q", [256, 512])
def test_kernel_longer_query_classes_on_card(dev, Q, state16):
    """Q = 256 and 512 still take the shared-memory rows (fewer pairs a
    block) and equal the plain version."""
    assert bsw_cuda.block_threads(Q, state16) > 0
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(40 + Q, P=1024, Q=Q, T=256))
    kernel = "bsw_extend_kernel_i16" if state16 else "bsw_extend_kernel"
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(n0, **{kernel: n0[kernel] + 1})
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles, state16))


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
def test_gmem_class_on_card(dev, state16):
    """A query-length class whose rows do not fit in shared memory takes
    the device-memory-scratch kernel, by shape alone, counted under its
    own name; the same kernel launched on a class that fits (0 pairs a
    block in the private launcher) equals the shared-memory one."""
    Q = 2048 if state16 else 1024
    assert bsw_cuda.block_threads(Q, state16) == 0
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(50, P=512, Q=Q, T=128))
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_gmem=n0["bsw_extend_kernel_gmem"] + 1)
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles, state16))
    small = _on(dev, dp_tiles(51, P=1024))
    a = bsw_cuda.bsw_extend_tiles(mat, *small, **GAP, state16=state16)
    b = bsw_cuda._launch_extend(mat, *small, **GAP, state16=state16,
                                threads=0)
    assert torch.equal(a, b)
    assert bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"] == \
        n0["bsw_extend_kernel_gmem"] + 2


def test_refused_shared_memory_raises_on_card(dev):
    """A block size whose rows exceed the card's shared memory is a
    launch error that reaches the caller; nothing is counted and the next
    launch is unaffected."""
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(60, P=2048))
    assert 1024 * bsw_cuda.pair_bytes(128) > bsw_cuda.SMEM_PER_BLOCK
    n0 = dict(bsw_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        bsw_cuda._launch_extend(mat, *tiles, **GAP, state16=False,
                                threads=1024)
    assert bsw_cuda.LAUNCHES == n0
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles))


def _dual_on(dev, seed, **kw):
    qarr, pac, l_pac, meta = dual_case(seed, **kw)
    args = (torch.from_numpy(MAT).to(dev),
            torch.from_numpy(qarr.reshape(-1).copy()).to(dev),
            torch.from_numpy(pac).to(dev), torch.from_numpy(meta).to(dev))
    return args, dict(Q=kw["Q"], T=kw["T"], L=qarr.shape[1], l_pac=l_pac,
                      w0=kw["w0"], wide_r0=kw.get("wide_r0", False), **GAP)


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("Q,w0,wide", [(128, 5, False), (128, 100, True),
                                       (128, 1, False), (256, 8, True)])
def test_fused_kernel_vs_plain_on_card(dev, Q, w0, wide, state16):
    """bsw_meta_dual_kernel == its plain version (build_tiles + the plain
    DP twice + acceptance), all eight columns: reverse lanes, reads across
    l_pac, lanes rejected at round 0, pad lanes (rejected at w0 = 1), both
    r0 widths; ONE launch, counted under the kernel's name, and no DP
    tile kernel."""
    args, kw = _dual_on(dev, 70 + Q + w0, n=3000, P=4096, Q=Q, T=256, w0=w0,
                        wide_r0=wide)
    kernel = "bsw_meta_dual_kernel_i16" if state16 else "bsw_meta_dual_kernel"
    n0 = dict(bsw_cuda.LAUNCHES)
    got = _meta_dual_core(*args, **kw, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(n0, **{kernel: n0[kernel] + 1})
    want = _meta_dual_plain(*args, **kw, state16=state16)
    assert bsw_cuda.LAUNCHES[kernel] == n0[kernel] + 1
    assert got.shape == (4096, 8) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want.cpu())
    rnd = got[:3000, 6]
    if w0 == 1:                  # the acceptance is 0 < 0: every lane
        assert int(rnd.sum()) == 3000
    elif w0 == 5:                # a band the 5-base insertions leave
        assert 0 < int(rnd.sum()) < 3000
    assert (got[3000:, 6] == (1 if w0 == 1 else 0)).all()


def test_fused_gmem_class_on_card(dev):
    """For a class whose rows do not fit, _meta_dual_core builds tiles and
    launches the device-memory-scratch kernel once per round."""
    args, kw = _dual_on(dev, 90, n=300, P=512, Q=1024, T=256, w0=8)
    n0 = dict(bsw_cuda.LAUNCHES)
    got = _meta_dual_core(*args, **kw)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_gmem=n0["bsw_extend_kernel_gmem"] + 2)
    assert torch.equal(got.cpu(), _meta_dual_plain(*args, **kw).cpu())
    with pytest.raises(ValueError, match="do not fit"):
        bsw_cuda.bsw_meta_dual(*args, **kw)


def test_fused_wrapper_checks_inputs_on_card(dev):
    """Wrong dtype, shape, layout or device raises before any launch."""
    (mat, qflat, pac, meta), kw = _dual_on(dev, 91, n=100, P=512, Q=128,
                                           T=128, w0=8)
    n0 = dict(bsw_cuda.LAUNCHES)
    for args, err in (
            ((mat, qflat.to(torch.int8), pac, meta), TypeError),
            ((mat, qflat, pac.to(torch.int32), meta), TypeError),
            ((mat, qflat, pac, meta[:, :8].contiguous()), ValueError),
            ((mat, qflat[:-1], pac, meta), ValueError),
            ((mat, qflat, pac, meta.t().contiguous().t()), ValueError),
            ((mat.cpu(), qflat, pac, meta), ValueError)):
        with pytest.raises(err):
            bsw_cuda.bsw_meta_dual(*args, **kw)
    assert bsw_cuda.LAUNCHES == n0


def test_probe_out_argument_on_card(dev):
    """probe_add_one(x, out=y) writes and returns y, allocating nothing;
    a misaligned or mistyped out raises."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    y = torch.zeros_like(x)
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    assert bsw_cuda.probe_add_one(x, out=y) is y
    torch.cuda.synchronize()
    assert torch.equal(y, x + 1)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1
    odd = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=dev)[1:] \
        .reshape(8, 128)
    with pytest.raises(ValueError, match="aligned"):
        bsw_cuda.probe_add_one(x, out=odd)
    with pytest.raises(TypeError):
        bsw_cuda.probe_add_one(x, out=y.to(torch.int64))
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1


@pytest.mark.parametrize("what", ["256 reads", "128 pairs"])
def test_cli_mem_on_card_equals_cpu(dev, tmp_path, what):
    """``mem`` at the CLI's defaults (device engine on the card) gives
    the SAM of the same command with ``--device cpu``, every line but
    @PG, and launches a DP kernel."""
    import os
    from compseed_tpu_torch import cli
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    names, n = (("reads.fq",), 256) if what == "256 reads" else \
        (("reads_1.fq", "reads_2.fq"), 128)
    inputs = []
    for name in names:
        inputs.append(str(tmp_path / name))
        with open(os.path.join(fx, name)) as f, open(inputs[-1], "w") as g:
            for _ in range(4 * n):
                g.write(f.readline())
    sams = {}
    for tag, device in (("card", []), ("cpu", ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.sam")
        for k in bsw_cuda.LAUNCHES:
            bsw_cuda.LAUNCHES[k] = 0
        assert cli.main(["mem", *device, "-v", "1", "-o", out,
                         os.path.join(fx, "tiny"), *inputs]) == 0
        dp = sum(v for k, v in bsw_cuda.LAUNCHES.items()
                 if k.startswith("bsw_"))
        assert (dp > 0) == (tag == "card"), bsw_cuda.LAUNCHES
        with open(out) as f:
            sams[tag] = [l for l in f if not l.startswith("@PG")]
    assert sams["card"] == sams["cpu"]
    assert len(sams["card"]) >= 2 + (n if len(names) == 1 else 2 * n)
