"""The exact rerun's kernels of compseed_tpu_torch/csrc/smem_seed.cu,
held three ways on the CPU, exactly (everything is integer, tolerance 0):
the kernels' own lane code (the source compiled with g++ into its host
loops, ops/smem_cases.HostTwin), the plain versions (ops/smem.py::
_collect_plain, _seed_strategy_plain) and the JAX package's vmapped,
jitted per-read programs (compseed_tpu/ops/smem.py::_collect_one,
_seed_strategy_one), at int32 and int64 index types:

  smem_collect_kernel   round-1 lanes (min_hits 1) and round-2 lanes
                        (min_hits > 1), pivot 0 (the fast path), pivots
                        on an ambiguous base and at the read's last base,
                        inactive pad lanes; MLEP and MMEM forced to 2 and
                        1 so the overflows are hit; and on a repeat
                        family's index, whose LEP frontiers reach 32
                        slots, MLEP and MMEM on each side of every slot
                        boundary of the kernel's groups (a lane's 8 or
                        32 threads, slot j in thread j % group), every
                        output byte poisoned first;
  smem_strategy_kernel  the round-3 scan with hits, MMEM3 forced to 1,
                        its rows ranked as the kernel ranks them
                        (row_read, row_pc) and by occ_row;
                        row_read / row_pc against occ_row at the table's
                        edges.

Also: a whole BatchSeeder.run_flat over tests/fixtures/reads.fq (2,000
reads as one chunk) with the dispatch sent to the host loops, equal to the
JAX BatchSeeder's; that the dispatchers take the plain version for CPU
tensors only; the host loops' record of a call (smem_cases.work).  The
kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compseed_tpu.io.fastq import read_fastq_chunks
from compseed_tpu.ops import smem as jsmem
from compseed_tpu.ops.device_index import to_device as jax_to_device
from compseed_tpu.options import MemOptions
from compseed_tpu.pipeline.align import encode_read
from compseed_tpu_torch import convert
from compseed_tpu_torch.ops import smem as tsmem
from compseed_tpu_torch.ops import smem_cases, smem_cuda
from compseed_tpu_torch.ops.device_index import to_device

from tests.conftest import FIXTURES, _index_from_codes

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
L = 128
P = 96


def _reads(n=None):
    reads = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10_000_000):
        reads.extend(chunk)
    return [encode_read(r.seq) for r in reads[:n]]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """csrc/smem_seed.cu built with g++ into its host loops."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernels' lane code")
    return smem_cases.HostTwin(
        str(tmp_path_factory.mktemp("smem_seed") / "libsmem_seed_host.so"))


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


@pytest.fixture(scope="module", params=[None, np.int64],
                ids=["int32", "int64"])
def idx(request, tiny_fm, port_fm):
    """(JAX index, port index on the CPU) at one dtype."""
    return (jax_to_device(tiny_fm, force_dtype=request.param),
            to_device(port_fm, CPU, force_dtype=request.param))


@pytest.fixture(scope="module")
def lanes():
    """Seeded lanes over the fixture reads with Ns sprinkled in: lanes
    0-7 pivot 0, lane 8 at the read's last base, lane 9 on an N, the rest
    anywhere; min_hits 1 on lanes below 48 (round 1), 2-40 above (round
    2); the last 5 lanes inactive pads (all N, pivot 0, min_hits 1)."""
    rng = np.random.default_rng(20)
    qs = _reads(P)
    qarr = np.full((P, L), 4, np.uint8)
    for i, q in enumerate(qs):
        qarr[i, :len(q)] = q
    qarr[rng.random((P, L)) < 0.01] = 4
    lens = np.array([len(q) for q in qs], np.int32)
    piv = rng.integers(0, 101, P).astype(np.int32)
    piv[:8] = 0
    piv[8] = lens[8] - 1
    qarr[9, piv[9]] = 4
    mh = np.ones(P, np.int32)
    mh[48:] = rng.integers(2, 41, P - 48)
    act = np.ones(P, bool)
    act[-5:] = False
    qarr[-5:] = 4
    piv[-5:] = 0
    mh[-5:] = 1
    return qarr, piv, mh, act


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


UNIT = 120          # the repeat family's unit
COPIES = 40         # its copies with one substitution each


@pytest.fixture(scope="module")
def family():
    """A genome of COPIES copies of a random UNIT-base unit, copy c with one
    substitution at 2 + 3c, between random 25-base spacers, then the exact
    unit: a sweep along the unit loses one copy at a time, so its LEP
    frontier grows past 32 slots (pivot 0) or to 26-31 (pivot 40).  ->
    (JAX index at int32, {dtype: port index on the CPU}, lanes (q, pivot,
    min_hits, active): 0-23 over the unit and four copies, pivots 0 to
    100, min_hits 1, 2 and 5, lane 23 inactive; 24-29 over the unit at
    pivots 50-70 with min_hits 10-30, where the backward shrink loses one
    copy at a time and slot after slot fails and is emitted: lane 26
    (pivot 60, min_hits 22) emits 20 rows, so frontier slots up to 19
    reach slot 0)."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, UNIT).astype(np.uint8)
    parts, copies = [], []
    for c in range(COPIES):
        cp = unit.copy()
        cp[2 + 3 * c] = (cp[2 + 3 * c] + 1) % 4
        copies.append(cp)
        parts += [rng.integers(0, 4, 25).astype(np.uint8), cp]
    _, _, jfm = _index_from_codes(np.concatenate(parts + [unit]))
    fm = convert.fmindex_from_jax_package(jfm)
    deep = [(60, 10), (60, 16), (60, 22), (50, 20), (70, 25), (62, 30)]
    reads = [unit] * 12 + [copies[c] for c in (2, 13, 25, 39)] * 3 + \
        [unit] * len(deep)
    P = len(reads)
    q = np.full((P, L), 4, np.uint8)
    for i, r in enumerate(reads):
        q[i, :UNIT] = r
    piv = np.array([0, 20, 40, 60, 80, 100] * 4 + [p for p, _ in deep],
                   np.int32)
    mh = np.array(([1] * 6 + [2] * 3 + [5] * 3) * 2 + [h for _, h in deep],
                  np.int32)
    act = np.ones(P, bool)
    act[23] = False
    return jax_to_device(jfm), {
        n: to_device(fm, CPU, force_dtype=d)
        for n, d in (("int32", None), ("int64", np.int64))}, \
        (q, piv, mh, act)


_FAMILY_JAX: dict = {}


def _jax_collect(dfi, qarr, piv, mh, act):
    f = jax.jit(jax.vmap(lambda fm_, q, p, h, a: jsmem._collect_one(
        fm_, L, q, p, h, a), in_axes=(None, 0, 0, 0, 0)))
    return np.asarray(f(dfi, jnp.asarray(qarr), jnp.asarray(piv),
                        jnp.asarray(mh), jnp.asarray(act)))


def _jax_round3(dfi, qarr, act, min_len, max_intv):
    f = jax.jit(jax.vmap(lambda fm_, q, a: jsmem._seed_strategy_one(
        fm_, L, min_len, max_intv, q, a), in_axes=(None, 0, 0)))
    return np.asarray(f(dfi, jnp.asarray(qarr), jnp.asarray(act)))


def _set_caps(monkeypatch, **caps):
    for name, val in caps.items():
        monkeypatch.setattr(jsmem, name, val)
        monkeypatch.setattr(tsmem, name, val)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("caps", [{}, {"MLEP": 2, "MMEM": 1}],
                         ids=["caps", "caps-2-1"])
def test_collect_host_vs_plain_and_jax(twin, idx, lanes, monkeypatch, caps):
    """smem_collect_kernel's lane code == _collect_plain == JAX
    _collect_one, every packed word, round-1 and round-2 lanes, the fast
    path, pads; with the caps forced small the overflow is really hit."""
    jd, td = idx
    _set_caps(monkeypatch, **caps)
    qarr, piv, mh, act = lanes
    want = _jax_collect(jd, *lanes)
    plain = tsmem._collect_plain(td, L, _t(qarr), _t(piv), _t(mh),
                                 _t(act)).numpy()
    got = twin.collect(td, L, _t(qarr), _t(piv), _t(mh), _t(act),
                       tsmem.MLEP, tsmem.MMEM).numpy()
    assert got.dtype == plain.dtype == want.dtype
    assert np.array_equal(plain, want)
    assert np.array_equal(got, want)
    n = got[:, tsmem.MMEM * 5]
    first_ok = qarr[:8, 0] < 4       # pivot 0: one SMEM, none on an N
    assert (n[:8] == first_ok).all() and first_ok.sum() >= 6
    assert (n[-5:] == 0).all() and (got[-5:, -2] == 1).all()   # pads
    assert not got[-5:, :tsmem.MMEM * 5].any()
    assert bool(got[:, -1].any()) == bool(caps)   # overflow only if forced
    if not caps:
        assert (n > 1).any() and (n[48:] > 0).any()


# (MLEP, MMEM) on each side of the groups' slot boundaries: slot j in
# thread j % group, so with 8 threads a thread's second slot starts at 8,
# its fourth at 24; with 32 every slot is a thread's first
SLOT_CAPS = [(1, 1), (4, 5), (8, 9), (9, 8), (16, 17), (17, 16), (24, 25),
             (25, 24), (31, 32), (32, 31)]


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("caps", SLOT_CAPS,
                         ids=[f"{a}-{b}" for a, b in SLOT_CAPS])
def test_collect_host_at_slot_boundaries(twin, family, monkeypatch, caps,
                                         dtype, group):
    """On the repeat family's lanes, whose frontiers cross every slot
    boundary of the kernel's groups, smem_collect_kernel's lane code at
    each group size == _collect_plain == JAX _collect_one (run once a cap
    pair, at int32; the int64 index's words equal it as integers), every
    word written over poison; a lane whose frontier reaches more slots
    than MLEP
    overflows (pivot 40's reaches 26 to 31: its last thread-slot segment,
    slots 24-31, at MLEP 32); lane 26 emits 20 rows where its frontier
    fits (slot 19 reaches slot 0), at most MMEM."""
    jd, tds, lanes = family
    td = tds[dtype]
    mlep, mmem = caps
    _set_caps(monkeypatch, MLEP=mlep, MMEM=mmem)
    qarr, piv, mh, act = lanes
    if caps not in _FAMILY_JAX:
        _FAMILY_JAX[caps] = _jax_collect(jd, *lanes).astype(np.int64)
    want = _FAMILY_JAX[caps]
    args = (_t(qarr), _t(piv), _t(mh), _t(act))
    plain = tsmem._collect_plain(td, L, *args).numpy()
    got = twin.collect(td, L, *args, mlep, mmem, group=group).numpy()
    assert np.array_equal(plain.astype(np.int64), want)
    assert np.array_equal(got.astype(np.int64), want)
    ovf = got[:, -1].astype(bool)
    assert ovf[0] and not ovf[23]                 # pivot 0: > 32 slots
    assert bool(ovf[2]) == (mlep <= 25)           # pivot 40: 26 to 31
    n_mems = got[:, mmem * 5]
    assert (n_mems[:23] >= 1).all() and (n_mems[24:] >= 1).all()
    if mlep >= 25:
        assert n_mems[26] == min(mmem, 20)


def test_collect_host_int64_hits(twin, idx, lanes):
    """min_hits as int64 (cast into the index type as .to does) gives what
    int32 min_hits give."""
    _, td = idx
    qarr, piv, mh, act = lanes
    a = twin.collect(td, L, _t(qarr), _t(piv), _t(mh), _t(act), 32, 32)
    b = twin.collect(td, L, _t(qarr), _t(piv), _t(mh.astype(np.int64)),
                     _t(act), 32, 32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mmem3", [32, 1])
def test_strategy_host_vs_plain_and_jax(twin, idx, lanes, monkeypatch,
                                        mmem3):
    """smem_strategy_kernel's lane code == _seed_strategy_plain == JAX
    _seed_strategy_one (max_intv raised so that hits occur); with MMEM3
    forced to 1 the overflow flag is set; inactive lanes give zeros."""
    jd, td = idx
    _set_caps(monkeypatch, MMEM3=mmem3)
    qarr, _, _, act = lanes
    want = _jax_round3(jd, qarr, act, 19, 200)
    plain = tsmem._seed_strategy_plain(td, L, 19, 200, _t(qarr),
                                       _t(act)).numpy()
    got = twin.strategy(td, L, 19, 200, _t(qarr), _t(act), mmem3).numpy()
    assert np.array_equal(plain, want)
    assert np.array_equal(got, want)
    assert got[:, mmem3 * 5].any()
    assert bool(got[:, -1].any()) == (mmem3 == 1)
    assert not got[~act].any()


def test_strategy_host_defaults_vs_jax(twin, idx, lanes):
    """Round 3 at the default options (min_seed_len 19, max_mem_intv 20)."""
    jd, td = idx
    qarr, _, _, act = lanes
    opt = MemOptions()
    want = _jax_round3(jd, qarr, act, opt.min_seed_len,
                       int(opt.max_mem_intv))
    got = twin.strategy(td, L, opt.min_seed_len, int(opt.max_mem_intv),
                        _t(qarr), _t(act), tsmem.MMEM3).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows", [False, True],
                         ids=["thread-ranks", "row-reads"])
@pytest.mark.parametrize("case", ["hits", "hits-mmem3-1", "defaults"])
def test_strategy_host_by_both_ranks_vs_plain_and_jax(twin, idx, lanes,
                                                      monkeypatch, case,
                                                      rows):
    """strategy_lane ranked by ThreadRanks (occ_row: a row's quarters one
    after another) and by ThreadRowRanks (row_read and row_pc: a row's
    three quarters read, then ranked, as the kernel's pair ranks each
    row) == _seed_strategy_plain == JAX _seed_strategy_one on the
    fixture lanes (Ns in the reads, inactive pads): with hits (max_intv
    raised), with MMEM3 forced to 1 (the overflow), and at the default
    options; int32 and int64 positions."""
    jd, td = idx
    qarr, _, _, act = lanes
    opt = MemOptions()
    mmem3 = 1 if case == "hits-mmem3-1" else tsmem.MMEM3
    _set_caps(monkeypatch, MMEM3=mmem3)
    min_len, max_intv = (opt.min_seed_len, int(opt.max_mem_intv)) \
        if case == "defaults" else (19, 200)
    want = _jax_round3(jd, qarr, act, min_len, max_intv)
    plain = tsmem._seed_strategy_plain(td, L, min_len, max_intv, _t(qarr),
                                       _t(act)).numpy()
    got = twin.strategy(td, L, min_len, max_intv, _t(qarr), _t(act), mmem3,
                        rows=rows).numpy()
    assert np.array_equal(plain, want)
    assert np.array_equal(got, want)
    assert got[:, mmem3 * 5].any() and not got[~act].any()
    assert bool(got[:, -1].any()) == (case == "hits-mmem3-1")


def test_row_read_equals_occ_row(twin, idx):
    """row_pc(row_read(k)) (the round-3 kernel's reads and ranks of a
    row) == occ_row (ThreadRanks') at k = -1 (zero), at the primary and
    beside it, at block offsets 63 and 64 (the last rank of plane quarter 1, the first
    of quarter 2), at the table's last position, and under fill_oob at the
    blocks n_rows and -n_rows - 1 (the all-ones row; a position past the
    primary counts one less) and -n_rows (row 0 again); without
    fill_oob a block outside the table is a fault, as on the card."""
    import dataclasses
    _, td = idx
    n, pr = int(td.n_rows), int(td.primary)
    k = [-1, pr - 1, pr, pr + 1, 63, 64, 128 * 5 + 63, 128 * 5 + 64,
         128 * 7 + 127, 128 * (n - 1) + 64, 128 * (n - 1) + 127]
    got, want = twin.row_reads(td, np.array(k))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not got[0][0].any() and not got[1][0]          # k = -1
    oob = dataclasses.replace(td, fill_oob=True)
    ko = [128 * n + 1, 128 * n + 64, -128 * n - 1, -128 * n, -128 * n + 63]
    got, want = twin.row_reads(oob, np.array(ko))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert (got[0][:3] == 0xFFFFFFFF).all()              # the all-ones row
    row0 = twin.row_reads(td, np.array([0]))[0][0][0]
    assert np.array_equal(got[0][3], row0)
    with pytest.raises(RuntimeError):
        twin.row_reads(td, np.array([128 * n + 1]))


def test_host_loops_refuse_bad_caps(twin, idx, lanes):
    _, td = idx
    qarr, piv, mh, act = lanes
    for mlep, mmem in ((0, 32), (33, 32), (32, 0)):
        with pytest.raises(RuntimeError):
            twin.collect(td, L, _t(qarr), _t(piv), _t(mh), _t(act), mlep,
                         mmem)
    with pytest.raises(RuntimeError):            # no such group
        twin.collect(td, L, _t(qarr), _t(piv), _t(mh), _t(act), 32, 32,
                     group=4)
    with pytest.raises(RuntimeError):
        twin.strategy(td, L, 19, 20, _t(qarr), _t(act), 33)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run_flat_pair(tiny_fm, port_fm, twin):
    """BatchSeeder.run_flat over reads.fq (2,000 reads, one chunk): the
    JAX package's, and the port's with _collect_one / _seed_strategy_one
    sent to the host loops (the calls recorded)."""
    queries = _reads()
    opt = MemOptions()
    want = jsmem.BatchSeeder(opt, tiny_fm).run_flat(queries)
    mp = pytest.MonkeyPatch()
    mp.setattr(tsmem, "_collect_one",
               lambda fm, L_, q, p, h, a: twin.collect(
                   fm, L_, q, p, h, a, tsmem.MLEP, tsmem.MMEM))
    mp.setattr(tsmem, "_seed_strategy_one",
               lambda fm, L_, ml, mi, q, a: twin.strategy(
                   fm, L_, ml, mi, q, a, tsmem.MMEM3))
    try:
        with smem_cases.Capture() as cap:
            got = tsmem.BatchSeeder(opt, port_fm, CPU).run_flat(queries)
    finally:
        mp.undo()
    return want, got, cap


def test_batch_seeder_on_host_loops_vs_jax(run_flat_pair):
    """The whole exact seeder with every collect and round-3 call by the
    kernels' lane code equals the JAX BatchSeeder: lrep, seeds, offsets."""
    want, got, cap = run_flat_pair
    for g, w, nm in zip(got, want, ("lrep", "sflat", "soff")):
        assert g.dtype == w.dtype and np.array_equal(g, w), nm
    assert cap.counts["collect"] >= 5 and cap.counts["strategy"] == 1


def test_captured_calls_host_vs_plain(run_flat_pair, twin):
    """Every captured call of that run (round-1 iterations at shrinking
    widths, round 2, round 3) through the host loops and the plain
    version: equal."""
    _, _, cap = run_flat_pair
    widths = [c.lanes for c in cap.calls if c.kind == "collect"]
    assert widths[0] == 2048 and min(widths) == 64
    for call in cap.calls[::2] + cap.calls[-2:]:
        assert torch.equal(smem_cases.run(call, "host", twin),
                           smem_cases.run(call, "plain")), call.lanes


def test_work_counts_of_captured_calls(run_flat_pair, twin):
    """smem_cases.work on the run's calls: two ranks an extension, rows
    within the table, every lane's steps at most its forward and backward
    columns, the first round-1 call (pivot 0: the forward sweep alone) at
    most L steps a lane, and the record leaves the output as it was."""
    _, _, cap = run_flat_pair
    for call in (cap.calls[0], cap.calls[1], cap.calls[-1]):
        w = smem_cases.work(call, twin)
        assert w["ranks"] <= 2 * w["extensions"] and w["extensions"] > 0
        assert 0 < w["rows"] <= int(call.fm.n_rows)
        assert w["row_bytes"] >= 32 * w["rows"]
        assert w["bytes"] == w["row_bytes"] + w["lane_bytes"]
        assert w["max_steps"] <= 2 * call.L
        assert w["lanes"] == call.lanes
        fn = twin.collect if call.kind == "collect" else twin.strategy
        out, _ = fn(call.fm, call.L, *call.args, *call.caps.values(),
                    trace=True)
        assert torch.equal(out, smem_cases.run(call, "host", twin))
    first = smem_cases.work(cap.calls[0], twin)
    assert first["max_steps"] <= cap.calls[0].L


# ---------------------------------------------------------------------------
def test_dispatch_takes_plain_for_cpu_tensors_only(idx, lanes, monkeypatch):
    """CPU tensors go to the plain versions and never to the launchers;
    any other device goes to the launchers, which refuse what is not a
    CUDA tensor: nothing falls back to the plain version."""
    _, td = idx
    qarr, piv, mh, act = lanes

    def refuse(*a, **kw):
        raise AssertionError("a launcher was called for CPU tensors")
    monkeypatch.setattr(smem_cuda, "collect", refuse)
    monkeypatch.setattr(smem_cuda, "strategy", refuse)
    want = tsmem._collect_plain(td, L, _t(qarr), _t(piv), _t(mh), _t(act))
    assert torch.equal(tsmem._collect_one(td, L, _t(qarr), _t(piv), _t(mh),
                                          _t(act)), want)
    tsmem._seed_strategy_one(td, L, 19, 20, _t(qarr), _t(act))
    monkeypatch.undo()

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for non-CPU tensors")
    monkeypatch.setattr(tsmem, "_collect_plain", no_plain)
    monkeypatch.setattr(tsmem, "_seed_strategy_plain", no_plain)
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in (_t(qarr), _t(piv), _t(mh), _t(act))]
    with pytest.raises(ValueError, match="CUDA"):
        tsmem._collect_one(td, L, *meta)
    with pytest.raises(ValueError, match="CUDA"):
        tsmem._seed_strategy_one(td, L, 19, 20, meta[0], meta[3])
