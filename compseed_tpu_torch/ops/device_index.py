"""Device-resident FM-index (port of compseed_tpu/ops/device_index.py).

Same layout as the JAX package: one occ query reads ONE fused row of 12
words per 128-base block — words 0-3 the A/C/G/T checkpoint counts at
the block start, 4-7 the "hi" bitplane and 8-11 the "lo" bitplane of the
2-bit BWT codes — and the forward reference stays 2-bit packed, 16
bases per word.  Words are int64 tensors holding uint32 values (the
convention of ``ops/bits.py``).  Counts and positions use int32 when
they fit (seq_len + 1 < 2**31), else int64 (``idx_dtype``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from compseed_tpu_torch.index.fmindex import FMIndex


@dataclass(frozen=True)
class DeviceFMIndex:
    occ_rows: torch.Tensor    # (n_blocks+1, 12) int64, uint32 words
    sa_sampled: torch.Tensor  # (n_sa,) idx dtype
    L2: torch.Tensor          # (5,) idx dtype
    pac_words: torch.Tensor   # (ceil(l_pac/16),) int64, uint32 words
    primary: int
    seq_len: int
    sa_intv: int
    l_pac: int
    idx_dtype: type           # np.int32 or np.int64
    # occ reads outside the index return what the JAX package's
    # ``jnp.take`` returns (ops/fm._row_fetch): set by the seeding engines
    # whose overflowed dedup groups hand their members garbage intervals
    fill_oob: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.idx_dtype == np.int32 else torch.int64

    @property
    def device(self) -> torch.device:
        return self.occ_rows.device


def expand_bwt_codes(bwt_words: np.ndarray) -> np.ndarray:
    """(n_blocks, 8) packed uint32 -> (n_blocks, 128) uint8 codes."""
    n_blocks = bwt_words.shape[0]
    shifts = np.array([(15 - j) << 1 for j in range(16)], dtype=np.uint32)
    expanded = (bwt_words[:, :, None] >> shifts[None, None, :]) & 3
    return expanded.reshape(n_blocks, 128).astype(np.uint8)


def build_occ_rows(cp_occ: np.ndarray, bwt_words: np.ndarray) -> np.ndarray:
    """Fuse checkpoints + BWT bitplanes into (n_blocks+1, 12) uint32."""
    n_blocks = bwt_words.shape[0]
    codes = expand_bwt_codes(bwt_words)              # (n_blocks, 128)
    hi = (codes >> 1).astype(np.uint32)
    lo = (codes & 1).astype(np.uint32)
    bit = (np.arange(128, dtype=np.uint32) & 31)
    hi_w = np.zeros((n_blocks, 4), np.uint32)
    lo_w = np.zeros((n_blocks, 4), np.uint32)
    for w in range(4):
        cols = slice(w * 32, (w + 1) * 32)
        hi_w[:, w] = (hi[:, cols] << bit[cols]).sum(axis=1, dtype=np.uint32)
        lo_w[:, w] = (lo[:, cols] << bit[cols]).sum(axis=1, dtype=np.uint32)
    rows = np.zeros((cp_occ.shape[0], 12), np.uint32)
    rows[:, 0:4] = cp_occ.astype(np.uint32)
    rows[:n_blocks, 4:8] = hi_w
    rows[:n_blocks, 8:12] = lo_w
    return rows


def pack_pac_words(pac: np.ndarray, l_pac: int) -> np.ndarray:
    """View the on-disk 2-bit pac (4 bases/byte, first base in the high
    bits — _set_pac, FM_index/bntseq.c:229) as little-endian uint32
    words of 16 bases each, padded to a whole word."""
    nb = (l_pac + 3) // 4
    pad = (-nb) % 4
    b = np.ascontiguousarray(pac[:nb])
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    return np.frombuffer(b.tobytes(), dtype="<u4")


def pac_codes_at(pac_words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """2-bit base codes at flat forward positions (uint8).

    pos is clipped into the packed range; out-of-range reads are garbage
    codes the callers mask.  Base i lives in word i>>4, byte (i>>2)&3
    (little-endian), bits (3-(i&3))*2 within the byte."""
    n = pac_words.shape[0]
    p = pos.to(torch.int64).clamp(0, n * 16 - 1)
    w = pac_words[p >> 4]
    sh = 8 * ((p >> 2) & 3) + 2 * (3 - (p & 3))
    return ((w >> sh) & 3).to(torch.uint8)


def from_arrays(occ_rows: np.ndarray, sa_sampled: np.ndarray,
                L2: np.ndarray, pac_words: np.ndarray, *, primary: int,
                seq_len: int, sa_intv: int, l_pac: int, idx_dtype,
                device: torch.device) -> DeviceFMIndex:
    """Upload host arrays (uint32 words, index-dtype columns)."""
    idx_dtype = np.dtype(idx_dtype).type

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(device)

    return DeviceFMIndex(
        occ_rows=up(occ_rows, np.int64),
        sa_sampled=up(sa_sampled, idx_dtype),
        L2=up(L2, idx_dtype),
        pac_words=up(pac_words, np.int64),
        primary=int(primary), seq_len=int(seq_len), sa_intv=int(sa_intv),
        l_pac=int(l_pac), idx_dtype=idx_dtype)


def to_device(fm: FMIndex, device: torch.device,
              force_dtype=None) -> DeviceFMIndex:
    """force_dtype overrides the int32/int64 choice (testing the
    hg19-scale int64 path on small genomes)."""
    idx_dtype = force_dtype or (
        np.int32 if fm.seq_len + 1 < 2**31 else np.int64)
    if fm.cp_occ.max() >= 2**32:
        raise ValueError("per-base counts exceed uint32")
    return from_arrays(
        build_occ_rows(fm.cp_occ, fm.bwt_words), fm.sa_sampled, fm.L2,
        pack_pac_words(fm.pac, fm.l_pac), primary=fm.primary,
        seq_len=fm.seq_len, sa_intv=fm.sa_intv, l_pac=fm.l_pac,
        idx_dtype=idx_dtype, device=device)


def densify_sa(dfi: DeviceFMIndex, new_intv: int,
               chunk: int = 1 << 21) -> DeviceFMIndex:
    """Resample the suffix array to a DENSER interval on the device.

    The reference ships `.sa` at intv 32 (FM_index/bwt.c:218 via bwtsw);
    a denser sample trades device memory for SAL walk depth, and
    retrofits a loaded intv-32 index without touching the on-disk files.

    Each new sample SA[j*new_intv] is computed by the same masked
    inverse-Psi walk SAL uses (`sa_batch`), ``chunk`` lanes at a time.
    The walked values are EXACTLY the directly-built denser sample,
    including the -1 sentinel at [0]: a walk that passes the primary row
    picks up SA[primary]=0 via invPsi(primary)=0 and then terminates at
    row 0 adding the stored -1 — the same wrap arithmetic
    bwt_cal_sa/bwt_sa rely on (FM_index/bwt.c:86-96).  The chunks stay on
    the device; a last chunk narrower than the others needs no padding.
    """
    import dataclasses

    from compseed_tpu_torch.ops.fm import sa_batch
    old = dfi.sa_intv
    if not (0 < new_intv < old and old % new_intv == 0
            and new_intv & (new_intv - 1) == 0):
        raise ValueError(
            f"densify_sa: new interval {new_intv} must be a power of two "
            f"that divides and is smaller than the index's interval {old}")
    n_new = dfi.seq_len // new_intv + 1
    parts = []
    for s in range(0, n_new, chunk):
        k = torch.arange(s, min(s + chunk, n_new), dtype=torch.int64,
                         device=dfi.device) * new_intv
        parts.append(sa_batch(dfi, k))
    return dataclasses.replace(dfi, sa_sampled=torch.cat(parts),
                               sa_intv=new_intv)
