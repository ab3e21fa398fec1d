"""The hand-written CUDA DP kernel against its plain PyTorch version, on
the card.  Every test here is marked ``cuda`` and skips without a card.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import _extend_core

from torch_dp_cases import GAP, MAT, dp_tiles

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
    n0 = bsw_cuda.LAUNCHES
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == n0 + 1
    assert got.shape == (4096, 8) and got.dtype == torch.int32
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0])
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert not got[:, 6:].any()


def test_wrapper_checks_inputs_on_card(dev):
    """Wrong dtype, shape or layout raises before any launch."""
    mat = torch.from_numpy(MAT).to(dev)
    q, ql, t, tl, h0, ws = _on(dev, dp_tiles(3, P=64))
    n0 = bsw_cuda.LAUNCHES
    for args, err in (
            ((mat, q.to(torch.int32), ql, t, tl, h0, ws), TypeError),
            ((mat, q, ql[:32], t, tl, h0, ws), ValueError),
            ((mat, q, ql, t.t().contiguous().t(), tl, h0, ws), ValueError),
            ((mat, q, ql.cpu(), t, tl, h0, ws), ValueError)):
        with pytest.raises(err):
            bsw_cuda.bsw_extend_tiles(*args, **GAP)
    assert bsw_cuda.LAUNCHES == n0
