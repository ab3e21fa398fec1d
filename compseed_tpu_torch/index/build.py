"""FASTA → FM-index construction.

Produces the exact on-disk artifacts of the reference ``bwaidx`` binary
(.pac/.ann/.amb/.bwt/.sa — byte-identical), via the 5-stage recipe of
``bwa_idx_build`` (FM_index/index_main.c:257-325):

  1. pack FASTA, both strands, ambiguous bases filled deterministically
     (bns_fasta2bntseq, FM_index/bntseq.c:232-333)
  2. BWT of the doubled sequence (we build a full suffix array with
     vectorized prefix doubling instead of SA-IS/BWT-SW — same result)
  3. interleave Occ checkpoints every 128 bases (bwt_bwtupdate_core,
     FM_index/index_main.c:152-174)
  4. re-pack forward-only .pac
  5. sample the suffix array at interval 32 (bwt_cal_sa, FM_index/bwt.c:62-84)

Because we hold the full suffix array, stages 2 and 5 read it directly.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from compseed_tpu_torch.utils import NT4_TABLE, Lrand48

OCC_INTV_SHIFT = 7
OCC_INTERVAL = 1 << OCC_INTV_SHIFT  # 128
SA_INTV_DEFAULT = 32


@dataclass
class SeqAnn:
    """Per-contig metadata (bntann1_t, FM_index/bntseq.h:41-48)."""
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: int = 0


@dataclass
class AmbHole:
    """Ambiguous-base run (bntamb1_t, FM_index/bntseq.h:50-54)."""
    offset: int
    length: int
    amb: str


@dataclass
class BntSeq:
    """Reference metadata bundle (bntseq_t, FM_index/bntseq.h:56-64)."""
    l_pac: int
    seed: int
    anns: list[SeqAnn] = field(default_factory=list)
    ambs: list[AmbHole] = field(default_factory=list)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    @property
    def n_holes(self) -> int:
        return len(self.ambs)


def read_fasta(path: str) -> list[tuple[str, str, bytes]]:
    """Minimal FASTA reader: list of (name, comment, sequence-bytes)."""
    opener = gzip.open if path.endswith(".gz") else open
    seqs: list[tuple[str, str, bytes]] = []
    name, comment, chunks = None, "", []
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs.append((name, comment, b"".join(chunks)))
                hdr = line[1:].decode()
                parts = hdr.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif name is not None and line:
                chunks.append(line)
    if name is not None:
        seqs.append((name, comment, b"".join(chunks)))
    return seqs


def pack_sequences(seqs: list[tuple[str, str, bytes]]) -> tuple[BntSeq, np.ndarray]:
    """Encode contigs to nt4 codes with deterministic N-filling.

    Returns (bns, codes) where codes is the forward-strand nt4 array.
    Contract: add1 (FM_index/bntseq.c:232-278) — holes merge only when the
    raw character repeats; each ambiguous base consumes one lrand48() draw
    seeded with srand48(11) (bntseq.c:295-296).
    """
    bns = BntSeq(l_pac=0, seed=11)
    rng = Lrand48(11)
    parts: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in seqs:
        arr = np.frombuffer(seq, dtype=np.uint8)
        codes = NT4_TABLE[arr].copy()
        ambi = codes >= 4
        n_ambs = 0
        if ambi.any():
            idx = np.nonzero(ambi)[0]
            # A hole extends only while the *raw* character repeats at
            # consecutive positions within this sequence (add1's `lasts`
            # tracking, bntseq.c:246-264); it never spans contigs.
            prev_i = -2
            for i in idx:
                i = int(i)
                ch = int(arr[i])
                if prev_i == i - 1 and int(arr[i - 1]) == ch:
                    bns.ambs[-1].length += 1
                else:
                    bns.ambs.append(AmbHole(offset + i, 1, chr(ch)))
                    n_ambs += 1
                prev_i = i
                codes[i] = rng.lrand48() & 3
        bns.anns.append(SeqAnn(name=name, anno=comment if comment else "(null)",
                               offset=offset, length=len(seq), n_ambs=n_ambs))
        offset += len(seq)
        parts.append(codes)
    bns.l_pac = offset
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return bns, codes


def pack_pac(codes: np.ndarray) -> np.ndarray:
    """2-bit pack, 4 bases per byte, first base in the high bits.

    Contract: _set_pac (FM_index/bntseq.c:229).
    """
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    g = padded.reshape(-1, 4)
    return (g[:, 0] << 6 | g[:, 1] << 4 | g[:, 2] << 2 | g[:, 3]).astype(np.uint8)


def unpack_pac(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_pac for the first n bases."""
    b = pac[: (n + 3) // 4]
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = b >> 6
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


def pack_bwt_words(bwt_codes: np.ndarray) -> np.ndarray:
    """Pack the BWT string 16 bases per uint32, first base in high bits.

    Contract: bwt_pac2bwt packing (FM_index/index_main.c:124-125).
    Chunked: a whole-genome uint32 staging copy would cost 4x the BWT.
    """
    n = len(bwt_codes)
    n_words = (n + 15) >> 4
    words = np.zeros(n_words, dtype=np.uint32)
    CW = 1 << 24                      # words per chunk (256 MB staging)
    for w0 in range(0, n_words, CW):
        w1 = min(w0 + CW, n_words)
        seg = np.zeros((w1 - w0) * 16, dtype=np.uint32)
        src = bwt_codes[w0 * 16: min(w1 * 16, n)]
        seg[: len(src)] = src
        g = seg.reshape(-1, 16)
        acc = words[w0:w1]
        for j in range(16):
            acc |= g[:, j] << np.uint32((15 - j) << 1)
    return words


def occ_checkpoints(bwt_codes: np.ndarray) -> np.ndarray:
    """Cumulative base counts at every OCC_INTERVAL boundary, plus final.

    cp[b, c] = #occurrences of c in bwt_codes[: b*128]; one extra row holds
    the totals (bwt_bwtupdate_core appends a final checkpoint,
    FM_index/index_main.c:169-171).
    """
    n = len(bwt_codes)
    n_data_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    cp = np.zeros((n_data_blocks + 1, 4), dtype=np.uint64)
    per_block = np.zeros((n_data_blocks, 4), dtype=np.int64)
    chunk_blocks = 1 << 17  # 16M bases per chunk to bound memory
    for b0 in range(0, n_data_blocks, chunk_blocks):
        b1 = min(b0 + chunk_blocks, n_data_blocks)
        seg = np.zeros((b1 - b0) * OCC_INTERVAL, dtype=np.uint8)
        src = bwt_codes[b0 * OCC_INTERVAL: min(b1 * OCC_INTERVAL, n)]
        seg[: len(src)] = src
        if len(src) < len(seg):
            seg[len(src):] = 255  # padding counts as no base
        g = seg.reshape(-1, OCC_INTERVAL)
        for c in range(4):
            per_block[b0:b1, c] = (g == c).sum(axis=1)
    cp[1:, :] = np.cumsum(per_block, axis=0)
    return cp


@dataclass
class BuiltIndex:
    """All artifacts of a full index build, in memory."""
    bns: BntSeq
    pac: np.ndarray          # forward-only packed reference
    primary: int
    L2: np.ndarray           # int64[5] cumulative counts
    seq_len: int             # 2 * l_pac
    bwt_codes: np.ndarray    # uint8 BWT string ($-removed)
    cp_occ: np.ndarray       # uint64[n_blocks, 4]
    sa_intv: int
    sa_sampled: np.ndarray   # uint64[n_sa], sa[0] == 2**64-1


def build_index_blocked(fa_path: str, sa_intv: int = SA_INTV_DEFAULT,
                        first_block: int = 768 << 20,
                        block_size: int = 192 << 20) -> BuiltIndex:
    """Low-memory twin of build_index: identical artifacts, bounded RSS.

    The in-core path materializes the full 64-bit suffix array (~8
    bytes/char — 50 GB at hg19's 6.2 G positions, 79.7 GB peak RSS).
    This path covers the reference's large-genome capability
    (bwt_bwtgen2 / BWTIncConstruct, FM_index/bwt_gen.c:1598,1299, the
    `-a bwtsw` algorithm, ~10 GB for hg19) with a different algorithm:
    SA-IS on the text's TAIL (first_block chars, in-core), then
    rank-anchored block-prepend merges (csrc/bwtinc.cpp) for the rest,
    and the reference's own inverse-Psi walk for the sampled SA
    (bwt_cal_sa, FM_index/bwt.c:62-84).  Peak RSS ~= 9 x first_block
    + ~6 bytes/char of merge state (~18 GB at hg19 defaults).

    Byte-identical to build_index (differential tests; hg19 SHA256
    manifest in EVIDENCE/hg19_index_manifest.md).
    """
    from compseed_tpu_torch.native import (bwt_cal_sa_native,
                                     bwt_merge_block_native,
                                     suffix_array_native)

    seqs = read_fasta(fa_path)
    bns, fwd = pack_sequences(seqs)
    del seqs                      # ~1 B/base of raw FASTA bytes
    l_pac = len(fwd)
    seq_len = 2 * l_pac
    pac = pack_pac(fwd)
    cnt_f = np.bincount(fwd, minlength=4)[:4].astype(np.int64)

    def both_slice(lo: int, hi: int) -> np.ndarray:
        """codes of (fwd ++ revcomp(fwd))[lo:hi] without materializing
        the doubled text."""
        out = np.empty(hi - lo, np.uint8)
        a = min(max(l_pac - lo, 0), hi - lo)
        if a > 0:
            out[:a] = fwd[lo:lo + a]
        if hi > l_pac:
            r0 = max(lo, l_pac)
            i_hi = 2 * l_pac - 1 - r0
            i_lo = 2 * l_pac - hi
            out[a:] = 3 - fwd[i_lo:i_hi + 1][::-1]
        return out

    # ---- tail block, in-core SA-IS
    S0 = min(first_block, seq_len)
    tail = both_slice(seq_len - S0, seq_len)
    sa0 = suffix_array_native(tail)          # len S0+1, sa0[0] == S0
    primary = int(np.argmin(sa0))
    bwt0 = np.empty(S0, dtype=np.uint8)
    out = 0
    CH = 1 << 26
    for i0 in range(0, len(sa0), CH):
        blk = sa0[i0: i0 + CH]
        nz = blk[blk != 0]
        bwt0[out: out + len(nz)] = tail[nz - 1]
        out += len(nz)
    assert out == S0
    del sa0
    packed = pack_pac(bwt0)
    del bwt0, tail
    n = S0

    # ---- prepend remaining blocks, back to front
    lo = seq_len - S0
    while lo > 0:
        b0 = max(0, lo - block_size)
        block = both_slice(b0, lo)
        packed, primary = bwt_merge_block_native(packed, n, primary,
                                                 block)
        n += len(block)
        lo = b0
    assert n == seq_len
    del fwd                       # 1 B/base, dead once the text is consumed

    sa_sampled = bwt_cal_sa_native(packed, seq_len, primary, sa_intv)
    bwt_codes = unpack_pac(packed, seq_len)
    del packed

    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(cnt_f + cnt_f[::-1])  # both-strand counts

    cp = occ_checkpoints(bwt_codes)
    return BuiltIndex(
        bns=bns, pac=pac, primary=primary, L2=L2, seq_len=seq_len,
        bwt_codes=bwt_codes, cp_occ=cp, sa_intv=sa_intv,
        sa_sampled=sa_sampled,
    )


def build_index(fa_path: str, sa_intv: int = SA_INTV_DEFAULT) -> BuiltIndex:
    seqs = read_fasta(fa_path)
    bns, fwd = pack_sequences(seqs)
    # doubled sequence: forward + reverse complement (bntseq.c:307-312)
    both = np.concatenate([fwd, 3 - fwd[::-1]])
    seq_len = len(both)

    # native SA-IS (linear time, 64-bit — whole-genome scale); a failed
    # g++ build of the native library raises here.  The numpy
    # prefix-doubling build (index.suffix) is the differential oracle
    from compseed_tpu_torch.native import suffix_array_native
    sa_full = suffix_array_native(both)
    # length seq_len+1, sa_full[0] == seq_len
    # chunked passes: at hg19 scale sa_full is ~50 GB, so boolean masks /
    # fancy-index copies of it would transiently double peak RSS; the
    # big arrays are also freed as soon as they are consumed
    primary = int(np.argmin(sa_full))       # the single 0 entry
    n_sa = (seq_len + sa_intv) // sa_intv
    sa_sampled = sa_full[: n_sa * sa_intv : sa_intv].astype(np.uint64)
    assert len(sa_sampled) == n_sa
    sa_sampled[0] = np.uint64(0xFFFFFFFFFFFFFFFF)  # bwt_cal_sa sets sa[0] = -1

    bwt_codes = np.empty(seq_len, dtype=np.uint8)
    out = 0
    CH = 1 << 26
    for i0 in range(0, len(sa_full), CH):
        blk = sa_full[i0: i0 + CH]
        nz = blk[blk != 0]
        bwt_codes[out: out + len(nz)] = both[nz - 1]
        out += len(nz)
    assert out == seq_len
    del sa_full, blk, nz                    # ~8 bytes/position

    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(np.bincount(both, minlength=4)[:4])
    del both

    cp = occ_checkpoints(bwt_codes)

    return BuiltIndex(
        bns=bns, pac=pack_pac(fwd), primary=primary, L2=L2, seq_len=seq_len,
        bwt_codes=bwt_codes, cp_occ=cp, sa_intv=sa_intv, sa_sampled=sa_sampled,
    )
