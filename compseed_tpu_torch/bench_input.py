"""The seeded benchmark input: genome, index and reads.

The port's own copy of the JAX package's benchmark set-up (bench.py:
``_make_genome``, ``_simulate_reads``, ``_setup``), with the same seeds
and sizes, so both packages align byte-identical input:

  * genome: 2 Mbp with real repeat structure (tandem repeats + a
    segmental duplication), not a pure random string — seed 2024;
  * reads: 32,768 of 101 bp at 30x coverage of a contiguous window, with
    substitution and indel errors and occasional Ns, ordered by layout
    position (what an overlap-clustering read compressor recovers) —
    seed 7;
  * index: sa_intv=8 (4x denser than the reference's on-disk 32: device
    memory traded for inverse-Psi walk depth).

``pe_pairs`` simulates proper paired-end reads over the same genome
(the pair simulator of the JAX package's scripts/pe_bench.py, seed 77
there).

The index and the reads are built with the port's own ``index/`` and
cached under build/compseed_tpu_torch/bench_cache/.
"""

from __future__ import annotations

import os

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(_ROOT, "build", "compseed_tpu_torch", "bench_cache")
GENOME_LEN = 2_000_000
N_READS = 32768
READ_LEN = 101
COVERAGE = 30.0
GENOME_SEED = 2024
READS_SEED = 7
PE_SEED = 77
INS_MEAN, INS_SD = 400, 50


def _make_genome(rng) -> np.ndarray:
    """Random backbone + the repeat features real genomes have."""
    seq = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    # tandem repeat arrays (unit x copies)
    for pos, unit_len, copies in ((300_000, 150, 12), (900_000, 60, 25),
                                  (1_700_000, 2_000, 4)):
        unit = seq[pos: pos + unit_len].copy()
        tile = np.tile(unit, copies)[: unit_len * copies]
        seq[pos: pos + len(tile)] = tile
    # a diverged segmental duplication (1.5% divergence)
    src = seq[500_000: 530_000].copy()
    mut = rng.random(len(src)) < 0.015
    src[mut] = rng.integers(0, 4, size=mut.sum())
    seq[1_400_000: 1_430_000] = src
    return seq


def _simulate_reads(rng, genome: np.ndarray) -> np.ndarray:
    """30x-coverage reads over a contiguous window, with subs + indels,
    ordered by canonical layout position (overlap-cluster order)."""
    span = int(N_READS * READ_LEN / COVERAGE)
    base = (GENOME_LEN - span) // 2
    positions = rng.integers(base, base + span - READ_LEN - 8,
                             size=N_READS)
    positions.sort()                      # layout order
    reads = np.empty((N_READS, READ_LEN), dtype=np.uint8)
    for i, pos in enumerate(positions):
        r = genome[pos: pos + READ_LEN + 8].copy()
        # indels: ~8% of reads carry one 1-4 bp insertion or deletion
        u = rng.random()
        if u < 0.04:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            r = np.concatenate([r[:j], r[j + n:]])          # deletion
        elif u < 0.08:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            ins = rng.integers(0, 4, size=n).astype(np.uint8)
            r = np.concatenate([r[:j], ins, r[j:]])         # insertion
        r = r[:READ_LEN]
        err = rng.random(READ_LEN) < 0.008                  # substitutions
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        if rng.random() < 0.01:                             # stray N
            r[int(rng.integers(0, READ_LEN))] = 4
        if rng.random() < 0.5:
            r = r[::-1].copy()
            m = r < 4
            r[m] = 3 - r[m]
        reads[i] = r
    return reads


def pe_pairs(n_pairs: int, seed: int = PE_SEED, genome=None):
    """(r1, r2), each (n_pairs, READ_LEN) uint8: proper FR pairs at ~30x
    over the bench genome.  Fragment ~N(400, 50), R1 forward at the
    fragment start, R2 reverse-complement at the fragment end; the
    reads' error model without the stray Ns.  Pairs are ordered by
    fragment position (layout order).  ``genome``: the bench genome's
    codes when the caller has them already."""
    if genome is None:
        genome = _make_genome(np.random.default_rng(GENOME_SEED))
    rng = np.random.default_rng(seed)
    span = int(n_pairs * 2 * READ_LEN / COVERAGE)
    base = (len(genome) - span - 800) // 2
    frag0 = rng.integers(base, base + span, size=n_pairs)
    frag0.sort()
    flen = np.clip(rng.normal(INS_MEAN, INS_SD, n_pairs).astype(int),
                   2 * READ_LEN + 10, 700)
    r1 = np.empty((n_pairs, READ_LEN), np.uint8)
    r2 = np.empty((n_pairs, READ_LEN), np.uint8)

    def noisy(r):
        u = rng.random()
        if u < 0.04:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            r = np.concatenate([r[:j], r[j + n:]])
        elif u < 0.08:
            j = int(rng.integers(10, READ_LEN - 10))
            n = int(rng.integers(1, 5))
            ins = rng.integers(0, 4, size=n).astype(np.uint8)
            r = np.concatenate([r[:j], ins, r[j:]])
        r = r[:READ_LEN]
        err = rng.random(len(r)) < 0.008
        r[err] = rng.integers(0, 4, size=int(err.sum()))
        return r

    for i in range(n_pairs):
        a = genome[frag0[i]: frag0[i] + READ_LEN + 8].copy()
        b = genome[frag0[i] + flen[i] - READ_LEN - 8:
                   frag0[i] + flen[i]].copy()
        r1[i] = noisy(a)[:READ_LEN]
        bb = noisy(b)[-READ_LEN:]
        bb = bb[::-1].copy()
        m = bb < 4
        bb[m] = 3 - bb[m]
        r2[i] = bb
    return r1, r2


def index_prefix(sa_intv: int = 8) -> str:
    """Path prefix of the bench genome's index files at this suffix-array
    interval (what ``mem`` takes), built and cached on first use."""
    from compseed_tpu_torch.index.build import build_index
    from compseed_tpu_torch.index.io import save_index
    from compseed_tpu_torch.utils import NT4_TO_ASCII

    os.makedirs(CACHE, exist_ok=True)
    prefix = os.path.join(CACHE, f"bench_{GENOME_LEN}_rep_sa{sa_intv}")
    fa = prefix + ".fa"
    if not os.path.exists(prefix + ".bwt"):
        rng = np.random.default_rng(GENOME_SEED)
        seq = _make_genome(rng)
        with open(fa, "w") as f:
            f.write(">bench_chr\n")
            s = bytes(NT4_TO_ASCII[seq]).decode()
            for i in range(0, len(s), 80):
                f.write(s[i: i + 80] + "\n")
        save_index(prefix, build_index(fa, sa_intv=sa_intv))
    return prefix


def setup():
    """(FMIndex, reads (N_READS, READ_LEN) uint8), built once and cached."""
    from compseed_tpu_torch.index.fmindex import FMIndex, unpack_pac_range

    fm = FMIndex.load(index_prefix(8))

    reads_path = os.path.join(CACHE, f"reads_{N_READS}_cov30.npy")
    if os.path.exists(reads_path):
        reads = np.load(reads_path)
    else:
        rng = np.random.default_rng(READS_SEED)
        genome = unpack_pac_range(fm.pac, 0, fm.l_pac)
        reads = _simulate_reads(rng, genome)
        np.save(reads_path, reads)
    return fm, reads
