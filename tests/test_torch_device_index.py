"""compseed_tpu_torch's device FM-index against compseed_tpu's, exactly:
the same arrays from one FMIndex at int32 and int64, and the JAX index
carried across by convert.from_jax_index (and back).  The port holds one
occ table, packed 64 bytes a row; convert.to_arrays unpacks it to the JAX
layout bit for bit."""

import dataclasses

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
    td = tdi.to_device(convert.fmindex_from_jax_package(fm), CPU,
                       force_dtype=force)
    _assert_same(td, *_jax_arrays(jd))
    assert td.occ_packed.dtype == torch.int32        # uint32 words as int32
    assert td.occ_packed.shape == (jd.occ_rows.shape[0], 16)
    assert td.n_rows == jd.occ_rows.shape[0]


@pytest.mark.parametrize("force", [None, np.int64])
def test_from_jax_index_roundtrip(tiny_fm, force):
    """The JAX index's fields, as numpy, load into the port unchanged and
    come back out bit-exactly."""
    arrays, meta = _jax_arrays(jdi.to_device(tiny_fm, force_dtype=force))
    port = convert.from_jax_index(arrays, meta, CPU)
    _assert_same(port, arrays, meta)
    direct = tdi.to_device(convert.fmindex_from_jax_package(tiny_fm), CPU,
                           force_dtype=force)
    for k in ("occ_packed", "sa_sampled", "L2", "pac_words"):
        assert torch.equal(getattr(port, k), getattr(direct, k)), k
    with pytest.raises(KeyError):
        convert.from_jax_index({k: arrays[k] for k in ("L2",)}, meta, CPU)


@pytest.mark.parametrize("force", [None, np.int64])
@pytest.mark.parametrize("which", ["tiny", "micro"])
def test_to_arrays_occ_rows_byte_equal(tiny_fm, micro, which, force):
    """convert.to_arrays(from_jax_index(a))["occ_rows"] is a["occ_rows"]
    byte for byte: packing and unpacking lose no bit."""
    fm = tiny_fm if which == "tiny" else micro[2]
    arrays, meta = _jax_arrays(jdi.to_device(fm, force_dtype=force))
    back = convert.to_arrays(convert.from_jax_index(arrays, meta, CPU))[0]
    want = arrays["occ_rows"]
    assert back["occ_rows"].dtype == want.dtype == np.uint32
    assert back["occ_rows"].shape == want.shape
    assert back["occ_rows"].tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("how", ["to_device", "from_jax_index"])
def test_index_holds_one_occ_table(tiny_fm, how):
    """A built index has no occ_rows: its only occ tensor is occ_packed,
    (n_rows, 16) int32, 64 bytes a row."""
    if how == "to_device":
        td = tdi.to_device(convert.fmindex_from_jax_package(tiny_fm), CPU)
    else:
        td = convert.from_jax_index(*_jax_arrays(jdi.to_device(tiny_fm)), CPU)
    assert not hasattr(td, "occ_rows")
    tensors = {f.name for f in dataclasses.fields(td)
               if isinstance(getattr(td, f.name), torch.Tensor)}
    assert tensors == {"occ_packed", "sa_sampled", "L2", "pac_words"}
    assert td.occ_packed.dtype == torch.int32
    assert td.occ_packed.shape == (td.n_rows, 16)
    assert td.occ_packed.element_size() * td.occ_packed.shape[1] == 64
    assert td.n_rows == (td.seq_len + 127) // 128 + 1   # blocks + totals


def test_pac_codes_at_matches_jax(micro):
    seq, _, fm = micro
    jd = jdi.to_device(fm)
    td = tdi.to_device(convert.fmindex_from_jax_package(fm), CPU)
    rng = np.random.default_rng(5)
    pos = np.concatenate([[-5, 0, 1, fm.l_pac - 1, fm.l_pac + 40],
                          rng.integers(0, fm.l_pac, 500)]).astype(np.int64)
    want = np.asarray(jdi.pac_codes_at(jd.pac_words, jnp.asarray(pos)))
    got = tdi.pac_codes_at(td.pac_words, torch.from_numpy(pos)).numpy()
    assert np.array_equal(got, want)
    inside = (pos >= 0) & (pos < fm.l_pac)
    assert np.array_equal(got[inside], seq[pos[inside]])
