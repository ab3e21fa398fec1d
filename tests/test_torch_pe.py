"""Paired-end, smart pairing (-p) and ALT contigs on compseed_tpu_torch's
seeder, DP engine and native tail: a leading subset of each fixture
through align_chunk / align_chunk_smart equals the JAX package's device
path on the same reads record for record (tolerance 0), and equals the
golden where a leading subset keeps the golden's records (SE and -j;
for PE the insert-size inference sees the whole file, so both sides get
one ``pes_override``).  Then each full file as one chunk against its
golden, on the port alone: a few seconds each on its CPU programs
(mirrors tests/test_pe.py and tests/test_alt.py)."""

import os

import pytest
import torch

import compseed_tpu.native as jax_native
import compseed_tpu.pipeline.align as jax_align
from compseed_tpu.index.fmindex import FMIndex as JaxFMIndex
from compseed_tpu.io import fastq as jax_fastq
from compseed_tpu.ops.engine import device_engine as jax_engine
from compseed_tpu.ops.engine import device_seeder as jax_seeder
from compseed_tpu.options import MemOptions as JaxOptions
import compseed_tpu_torch.native as port_native
import compseed_tpu_torch.pipeline.align as port_align
from compseed_tpu_torch.index.fmindex import FMIndex
from compseed_tpu_torch.io import fastq as port_fastq
from compseed_tpu_torch.ops.engine import device_engine, device_seeder
from compseed_tpu_torch.options import (MEM_F_PE, MEM_F_SMARTPE,
                                        MemOptions)

from tests.conftest import FIXTURES

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
# FR only: (failed, low, high, avg, std) per orientation, the -I layout
PES = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 150.0, 650.0, 400.0, 50.0,
       1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0]


def _fx(name):
    return os.path.join(FIXTURES, name)


def _load(mod, names, n):
    """The first n reads of a fixture (two names: pairs interleaved),
    parsed by ``mod``'s readers."""
    if len(names) == 2:
        gen = mod.read_fastq_pair_chunks(_fx(names[0]), _fx(names[1]),
                                         10_000_000)
    else:
        gen = mod.read_fastq_chunks(_fx(names[0]), 10_000_000)
    reads = []
    for chunk in gen:
        reads.extend(chunk)
    return reads[:n] if n else reads


def _golden(name):
    with open(_fx(name)) as f:
        return [line for line in f if not line.startswith("@")]


def _lines(reads):
    assert all(r.sam for r in reads)
    return "".join(r.sam for r in reads).splitlines(keepends=True)


def _golden_of(name, reads):
    """The golden's records of these leading reads (a read may own
    several lines: supplementary alignments)."""
    names = [r.name for r in reads]
    out = []
    it = iter(_golden(name))
    line = next(it, None)
    for nm in names:
        while line is not None and line.split("\t", 1)[0] == nm:
            out.append(line)
            line = next(it, None)
    return out


class Side:
    """One package's seeder, engine and tail over one index; ``flag``
    and ``ignore_alt`` as the CLI would set them."""

    def __init__(self, jax_side: bool, prefix: str):
        self.jax = jax_side
        if jax_side:
            self.fm = JaxFMIndex.load(_fx(prefix))
            self.opt = JaxOptions()
            self.seeder = jax_seeder(self.opt, self.fm, dedup=True)
            self.engine = jax_engine(self.opt, self.fm, dfi=self.seeder.dfi)
        else:
            self.fm = FMIndex.load(_fx(prefix))
            self.opt = MemOptions()
            self.seeder = device_seeder(self.opt, self.fm, dedup=True,
                                        device=CPU)
            self.engine = device_engine(self.opt, self.fm,
                                        dfi=self.seeder.dfi, device=CPU)
        self.alt = [a.is_alt for a in self.fm.bns.anns]

    def run(self, names, n, flag=0, ignore_alt=False, pes=None):
        for a, is_alt in zip(self.fm.bns.anns, self.alt):
            a.is_alt = 0 if ignore_alt else is_alt
        self.opt.flag = flag
        reads = _load(jax_fastq if self.jax else port_fastq, names, n)
        # a tail per run: it snapshots the options and the ALT flags
        tail = (jax_native if self.jax else port_native).NativeTail(
            self.opt, self.fm)
        al = jax_align if self.jax else port_align
        caps0 = self.caps()
        if flag & MEM_F_SMARTPE:
            al.align_chunk_smart(self.opt, self.fm, reads, 0,
                                 engine=self.engine, seeder=self.seeder,
                                 tail=tail, pes_override=pes, verbose=0)
        else:
            al.align_chunk(self.opt, self.fm, reads, 0, engine=self.engine,
                           seeder=self.seeder, tail=tail, pes_override=pes)
        return reads, _lines(reads), (caps0, self.caps())

    def caps(self):
        s = self.seeder
        return (s.GP_F, s.CAPU_F, s.T2L_F, s.GP2_F, s.MEM_F, s.SEED_F,
                s.U_F, s.MEM3_F, s._cap_raises)


@pytest.fixture(scope="module")
def tiny_sides():
    return Side(False, "tiny"), Side(True, "tiny")


@pytest.fixture(scope="module")
def alt_sides():
    return Side(False, "tiny_alt"), Side(True, "tiny_alt")


def _both(sides, *a, **kw):
    port, jx = sides
    reads, mine, caps = port.run(*a, **kw)
    _, theirs, jcaps = jx.run(*a, **kw)
    assert len(mine) == len(theirs)
    for i, (m, t) in enumerate(zip(mine, theirs)):
        assert m == t, f"record {i}:\nPORT: {m}\nJAX:  {t}"
    # the caps moved (or did not) exactly as in the JAX seeder
    assert caps == jcaps
    return reads, mine, caps


def test_pe_subset_vs_jax_device_path(tiny_sides):
    """64 pairs, one insert-size override on both sides: both extension
    sides through run_meta_dual, then the paired finalize with mate
    rescue."""
    reads, mine, _ = _both(tiny_sides, ("reads_1.fq", "reads_2.fq"), 128,
                           flag=MEM_F_PE, pes=PES)
    flags = [int(l.split("\t")[1]) for l in mine]
    assert all(f & 0x1 for f in flags) and any(f & 0x2 for f in flags)
    assert tiny_sides[0].engine.prof.get("engine_fetch")


def test_smartpe_subset_vs_jax_device_path(tiny_sides):
    """-p on the first 256 mixed reads: an SE group and a PE group of
    different sizes through one seeder and engine, two read matrices; a
    cap raised by one group carries to the next as in the JAX seeder."""
    reads, mine, (caps0, caps1) = _both(
        tiny_sides, ("reads_mixed.fq",), 256,
        flag=MEM_F_PE | MEM_F_SMARTPE, pes=PES)
    se, pe = port_align.bseq_classify(reads)
    assert se and pe and len(se) != len(pe)
    by_name = {}
    for l in mine:
        by_name.setdefault(l.split("\t", 1)[0], []).append(
            int(l.split("\t")[1]))
    assert all(not f & 0x1 for r in se for f in by_name[r.name])
    assert all(f & 0x1 for r in pe for f in by_name[r.name])


def test_alt_se_subset_vs_jax_and_golden(alt_sides):
    reads, mine, _ = _both(alt_sides, ("reads_alt.fq",), 160)
    assert mine == _golden_of("golden_alt_se.sam", reads)
    assert any("XR:" in l or "\tpchr_alt\t" in l for l in mine)
    assert any(int(l.split("\t")[1]) & 0x800 for l in mine)


def test_alt_ignore_j_subset_vs_jax_and_golden(alt_sides):
    """-j clears is_alt before alignment (fastmap.c:387-390)."""
    reads, mine, _ = _both(alt_sides, ("reads_alt.fq",), 160,
                           ignore_alt=True)
    assert mine == _golden_of("golden_alt_j.sam", reads)


def test_alt_pe_subset_vs_jax_device_path(alt_sides):
    reads, mine, _ = _both(alt_sides, ("reads_alt_1.fq", "reads_alt_2.fq"),
                           128, flag=MEM_F_PE, pes=PES)
    assert any("\tpchr_alt\t" in l for l in mine)


# ---- the full files against their goldens, the port alone

def _port_full(prefix, names, flag=0, ignore_alt=False):
    fm = FMIndex.load(_fx(prefix))
    if ignore_alt:
        for a in fm.bns.anns:
            a.is_alt = 0
    opt = MemOptions()
    opt.flag = flag
    seeder = device_seeder(opt, fm, dedup=True, device=CPU)
    engine = device_engine(opt, fm, dfi=seeder.dfi, device=CPU)
    tail = port_native.NativeTail(opt, fm)
    reads = _load(port_fastq, names, 0)          # the file as one chunk
    if flag & MEM_F_SMARTPE:
        port_align.align_chunk_smart(opt, fm, reads, 0, engine=engine,
                                     seeder=seeder, tail=tail, verbose=0)
    else:
        port_align.align_chunk(opt, fm, reads, 0, engine=engine,
                               seeder=seeder, tail=tail)
    return _lines(reads)


@pytest.mark.parametrize("prefix,names,gold,kw", [
    ("tiny", ("reads_1.fq", "reads_2.fq"), "golden_bwamem_pe.sam",
     dict(flag=MEM_F_PE)),
    ("tiny", ("reads_mixed.fq",), "golden_bwamem_smartpe.sam",
     dict(flag=MEM_F_PE | MEM_F_SMARTPE)),
    ("tiny_alt", ("reads_alt.fq",), "golden_alt_se.sam", dict()),
    ("tiny_alt", ("reads_alt.fq",), "golden_alt_j.sam",
     dict(ignore_alt=True)),
    ("tiny_alt", ("reads_alt_1.fq", "reads_alt_2.fq"), "golden_alt_pe.sam",
     dict(flag=MEM_F_PE)),
], ids=["pe", "smartpe", "alt_se", "alt_j", "alt_pe"])
def test_full_file_golden_parity(prefix, names, gold, kw):
    mine = _port_full(prefix, names, **kw)
    want = _golden(gold)
    assert len(mine) == len(want)
    for i, (m, g) in enumerate(zip(mine, want)):
        assert m == g, f"record {i}:\n{m}\n{g}"
