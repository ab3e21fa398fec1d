"""The hand-written CUDA kernels (the DP with int32 and with int16 state,
the launch probe) against their plain PyTorch versions, on the card.
Every test here is marked ``cuda`` and skips without a card.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import _extend_core

from torch_dp_cases import GAP, MAT, OPT, dp_tiles

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
