"""compseed_tpu_torch's library API (SMEM iterator + single-read
alignment) over the port's own host layers: mirrors tests/test_api.py,
and holds the iterator to the JAX package's on the same queries."""

import os

import pytest

from compseed_tpu import api as jax_api
from compseed_tpu_torch import convert
from compseed_tpu_torch.api import Smem, SmemIterator, align1
from compseed_tpu_torch.cpu import fm_oracle as fo
from compseed_tpu_torch.io.fastq import read_fastq_chunks
from compseed_tpu_torch.options import MemOptions

from tests.conftest import FIXTURES
from tests.test_ops_smem import _fixture_queries


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


def _rows(batches):
    return [[(m.k, m.l, m.s, m.qbeg, m.qend) for m in b] for b in batches]


def test_smem_iterator_matches_collect(port_fm):
    """With min_intv=1/max_intv=0 the iterator reproduces the round-1
    pivot walk of collect_mem (same SMEM sets, same pivot sequence)."""
    it = SmemIterator(port_fm)
    for q in _fixture_queries(12):
        it.set_query(q)
        got = [m for b in _rows(it) for m in b]
        want = []
        j = 0
        while j < len(q):
            mems, j = fo.collect_mem(port_fm, q, j, 1)
            want.extend(mems)
        assert got == want


def test_smem_iterator_max_intv(port_fm):
    """max_intv > 0 terminates forward extension early (bwt.c:305-308)."""
    q = _fixture_queries(1)[0]
    it = SmemIterator(port_fm)
    it.config(min_intv=1, max_intv=20)
    it.set_query(q)
    batches = list(it)
    assert batches and all(len(b) >= 1 for b in batches)
    assert all(isinstance(m, Smem) for b in batches for m in b)
    mems, _ = fo.smem1a(port_fm, q, 0, 1, 20)
    assert _rows(batches)[0] == mems


@pytest.mark.parametrize("cfg", [dict(), dict(min_intv=2),
                                 dict(min_intv=1, max_intv=20)],
                         ids=["default", "min_intv=2", "max_intv=20"])
def test_smem_iterator_vs_jax_package(tiny_fm, port_fm, cfg):
    """Batch for batch equal to compseed_tpu.api.SmemIterator, for code
    arrays and for strings (Ns included)."""
    mine, theirs = SmemIterator(port_fm), jax_api.SmemIterator(tiny_fm)
    mine.config(**cfg)
    theirs.config(**cfg)
    queries = list(_fixture_queries(6))
    queries.append("ACGTNNACGTTGCA" + "N" + "GATTACA" * 4)
    queries.append("NNNN")
    for q in queries:
        mine.set_query(q)
        theirs.set_query(q)
        assert _rows(mine) == _rows(theirs)
        assert mine.next() is None


def test_align1(tiny_fm, port_fm):
    with open(os.path.join(FIXTURES, "golden_bwamem.sam")) as f:
        gold = [l for l in f if not l.startswith("@")]
    reads = next(read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000))
    r = reads[0]
    sam = align1(MemOptions(), port_fm, r.seq, name=r.name, qual=r.qual)
    # with id 0 it matches the batch pipeline's first record exactly
    assert sam == gold[0]
    from compseed_tpu.options import MemOptions as JaxOptions
    for r in reads[1:4]:
        assert align1(MemOptions(), port_fm, r.seq, name=r.name,
                      qual=r.qual) == jax_api.align1(
            JaxOptions(), tiny_fm, r.seq, name=r.name, qual=r.qual)
