"""compseed_tpu_torch's device FM-index against compseed_tpu's, exactly:
the same arrays from one FMIndex at int32 and int64, and the JAX index
carried across by convert.from_jax_index (and back)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compseed_tpu.ops import device_index as jdi
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import device_index as tdi

CPU = torch.device("cpu")


def _jax_arrays(dfi):
    arrays = {k: np.asarray(getattr(dfi, k)) for k in convert.ARRAY_FIELDS}
    meta = {k: getattr(dfi, k) for k in convert.META_FIELDS}
    return arrays, meta


def _assert_same(port, arrays, meta):
    got, got_meta = convert.to_arrays(port)
    for k in convert.ARRAY_FIELDS:
        assert got[k].dtype == arrays[k].dtype, k
        assert np.array_equal(got[k], arrays[k]), k
    assert got_meta == meta
    assert port.dtype == (torch.int32 if meta["idx_dtype"] == np.int32
                          else torch.int64)


@pytest.mark.parametrize("force", [None, np.int64])
@pytest.mark.parametrize("which", ["tiny", "micro"])
def test_to_device_matches_jax(tiny_fm, micro, which, force):
    fm = tiny_fm if which == "tiny" else micro[2]
    jd = jdi.to_device(fm, force_dtype=force)
    td = tdi.to_device(fm, CPU, force_dtype=force)
    _assert_same(td, *_jax_arrays(jd))
    assert td.occ_rows.dtype == torch.int64          # uint32 words
    assert int(td.occ_rows.max()) < 2**32


@pytest.mark.parametrize("force", [None, np.int64])
def test_from_jax_index_roundtrip(tiny_fm, force):
    """The JAX index's fields, as numpy, load into the port unchanged and
    come back out bit-exactly."""
    arrays, meta = _jax_arrays(jdi.to_device(tiny_fm, force_dtype=force))
    port = convert.from_jax_index(arrays, meta, CPU)
    _assert_same(port, arrays, meta)
    direct = tdi.to_device(tiny_fm, CPU, force_dtype=force)
    for k in convert.ARRAY_FIELDS:
        assert torch.equal(getattr(port, k), getattr(direct, k)), k
    with pytest.raises(KeyError):
        convert.from_jax_index({k: arrays[k] for k in ("L2",)}, meta, CPU)


def test_pac_codes_at_matches_jax(micro):
    seq, _, fm = micro
    jd = jdi.to_device(fm)
    td = tdi.to_device(fm, CPU)
    rng = np.random.default_rng(5)
    pos = np.concatenate([[-5, 0, 1, fm.l_pac - 1, fm.l_pac + 40],
                          rng.integers(0, fm.l_pac, 500)]).astype(np.int64)
    want = np.asarray(jdi.pac_codes_at(jd.pac_words, jnp.asarray(pos)))
    got = tdi.pac_codes_at(td.pac_words, torch.from_numpy(pos)).numpy()
    assert np.array_equal(got, want)
    inside = (pos >= 0) & (pos < fm.l_pac)
    assert np.array_equal(got[inside], seq[pos[inside]])
