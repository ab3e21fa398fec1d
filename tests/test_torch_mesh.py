"""compseed_tpu_torch's multi-device path (parallel/mesh.py,
parallel/sharded.py) on the CPU, where a mesh of S entries is S shards on
the one CPU device (the counterpart of the JAX package's virtual CPU
mesh; tests/conftest.py forces 8 JAX devices).  Mirrors
tests/test_parallel.py: the sharded pipeline's SAM is byte-identical for
S in {1, 2, 4, 8} and equal to the single-device run; at S = 4 every
shard's head (flags, counters, per-read words) and seed matrix, and the
run's SeedingStats, equal the JAX package's ShardedSeeder's, and so do
the caps after a forced overflow; empty and ragged shards; the sharded
DP engine's three pair interfaces against the single-device engine;
data_parallel_step; make_mesh without a card.  Tolerance 0 everywhere:
the system is integer and bit-exact.  Also the JAX constants that
``chip_smoke.py`` phase 7 holds the card's sharded heads to; regenerate
them (the JAX package on the CPU, a few minutes) with
    JAX_PLATFORMS=cpu python -m tests.test_torch_mesh --write-heads
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compseed_tpu.options import MemOptions as JaxOptions
from compseed_tpu.parallel.mesh import make_mesh as jax_mesh
from compseed_tpu.pipeline.align import encode_read as jax_encode
from compseed_tpu.pipeline.seeding import SeedingStats as JaxStats
from compseed_tpu_torch import convert
from compseed_tpu_torch.io.fastq import read_fastq_chunks
from compseed_tpu_torch.native import NativeTail
from compseed_tpu_torch.ops import fm as dfm
from compseed_tpu_torch.ops.bsw import BswRunner
from compseed_tpu_torch.ops.bsw_cases import dual_meta_case
from compseed_tpu_torch.ops.device_index import to_device
from compseed_tpu_torch.ops.engine import device_engine, device_seeder
from compseed_tpu_torch.options import MemOptions
from compseed_tpu_torch.parallel import mesh as tmesh
from compseed_tpu_torch.parallel.sharded import (ShardedBswRunner,
                                                 ShardedSeeder)
from compseed_tpu_torch.pipeline.align import align_chunk
from compseed_tpu_torch.pipeline.seeding import SeedingStats

from tests.conftest import FIXTURES

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
N_READS = 240             # tests/test_parallel.py's production read count
SHARDS = (1, 2, 4, 8)
FORCED_GP_F = 4           # a round-1 pool too small for 60 reads a shard
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS_JSON = os.path.join(ROOT, "compseed_tpu_torch", "mesh_heads.json")
HEAD_READS = 16384        # chip_smoke.py phase 7's first chunk ...
HEAD_SHARDS = 4           # ... cut into four shards
CAPS = ("GP_F", "CAPU_F", "T2L_F", "GP2_F", "MEM_F", "SEED_F", "U_F",
        "MEM3_F", "_cap_raises", "fwd_disabled", "bwd_disabled", "r2_dedup")


@pytest.fixture(scope="module")
def port_fm(tiny_fm):
    return convert.fmindex_from_jax_package(tiny_fm)


@pytest.fixture(scope="module")
def reads():
    out = []
    for chunk in read_fastq_chunks(os.path.join(FIXTURES, "reads.fq"),
                                   10**9):
        out.extend(chunk)
    return out[:N_READS]


def _align(fm, reads, seeder, engine, stats=None):
    """One chunk through align_chunk with the native tail -> SAM."""
    opt = MemOptions()
    rs = [r.__class__(**r.__dict__) for r in reads]     # fresh copies
    align_chunk(opt, fm, rs, 0, engine=engine, seeder=seeder,
                tail=NativeTail(opt, fm), stats=stats)
    return "".join(r.sam for r in rs)


def _single(fm, reads):
    opt = MemOptions()
    sd = device_seeder(opt, fm, dedup=True, device=CPU)
    return _align(fm, reads, sd, device_engine(opt, fm, dfi=sd.dfi,
                                               device=CPU))


def _sharded(fm, S, dfi=None, **caps):
    opt = MemOptions()
    sd = ShardedSeeder(opt, fm, mesh=[CPU] * S, dfi=dfi, dedup=True)
    for k, v in caps.items():
        setattr(sd, k, v)
    return sd, ShardedBswRunner(opt, np.array(opt.mat), mesh=[CPU] * S,
                                dfi=sd.dfi)


def _capture(sd):
    """Record every chunk's shard layout, heads and seed matrices."""
    seen = []
    run = sd._run_shards

    def wrapped(R, L, qarr, rlens):
        shards, fns = run(R, L, qarr, rlens)
        seen.append(dict(R=R, L=L, qarr=qarr, rlens=rlens,
                         heads=np.stack([x[0] for x in shards]),
                         seeds=[x[1].numpy() for x in shards]))
        return shards, fns

    sd._run_shards = wrapped
    return seen


def _stats(st):
    return (st.bwt_queries, st.bwt_calls, st.sal_queries, st.sal_calls,
            dict(st.rounds))


@pytest.fixture(scope="module")
def single_sam(port_fm, reads):
    return _single(port_fm, reads)


@pytest.fixture(scope="module")
def runs(port_fm, reads):
    """The sharded pipeline at every shard count: (SAM, stats, the
    captured chunk, the seeder)."""
    out = {}
    for S in SHARDS:
        sd, eng = _sharded(port_fm, S)
        seen = _capture(sd)
        st = SeedingStats()
        out[S] = (_align(port_fm, reads, sd, eng, st), st, seen[0], sd)
    return out


def _jax_seeder(tiny_fm, S, gp_f=None):
    from compseed_tpu.parallel.sharded import ShardedSeeder as JaxSharded
    js = JaxSharded(JaxOptions(), tiny_fm, mesh=jax_mesh(jax.devices()[:S]),
                    dedup=True)
    if gp_f is not None:
        js.GP_F = gp_f
    return js


def _jax_heads(js, chunk):
    """The JAX package's per-shard heads and seed matrices for the port's
    shard layout of the same reads."""
    from compseed_tpu.ops.seeder2 import result_dims
    R, L = chunk["R"], chunk["L"]
    step = js._build_sharded(R, L)
    head_all, seed_all = step(js.dfi, jnp.asarray(chunk["qarr"]),
                              jnp.asarray(chunk["rlens"]))
    fns = js._jits[(R, L)]
    HL, ROWS = result_dims(R, fns["packed"])
    return (np.asarray(head_all).reshape(js.S, HL),
            np.asarray(seed_all).reshape(js.S, ROWS, -1))


def _assert_shards_equal(chunk, jheads, jseeds):
    assert np.array_equal(chunk["heads"], jheads)
    for s, pk in enumerate(chunk["seeds"]):
        if jheads[s, 3:14].any():
            continue                     # an overflowed shard's seeds
        k = int(jheads[s, 1])            # are never read
        assert np.array_equal(pk[:, :k], jseeds[s, :, :k]), s


@pytest.mark.parametrize("S", SHARDS)
def test_sam_identical_across_shard_counts(runs, single_sam, S):
    """tests/test_parallel.py::test_production_sam_identical_across_mesh_
    shapes: byte-identical SAM for every shard count, equal to the
    single-device pipeline."""
    sam, _, chunk, sd = runs[S]
    assert sam == single_sam and sam.count("\n") >= N_READS
    assert chunk["heads"].shape[0] == S
    assert chunk["R"] == 256 and chunk["qarr"].shape[0] == S * 256
    per = -(-N_READS // S)
    assert list(sd.last_row_map[[0, per - 1, N_READS - 1]]) == \
        [0, per - 1, (S - 1) * 256 + N_READS - 1 - (S - 1) * per]
    # a shard of 240 reads in a 256-row bucket overflows the seed caps on
    # this index and reruns (the engine then takes the flat pairs);
    # shards of <= 120 reads do not, and the engine slices the pairs from
    # the shards' read matrices (the metadata interface)
    assert sd.last_overflow == (S == 1)
    assert sd.last_qd is None if S == 1 else len(sd.last_qd) == S


def test_heads_and_counters_equal_jax_sharded_seeder(tiny_fm, runs, reads):
    """At S = 4 each shard's head and seed matrix equal the JAX package's
    ShardedSeeder's on the 4-device virtual mesh, bit for bit, and so do
    the run's counters (SeedingStats) and the caps after it."""
    _, st, chunk, sd = runs[4]
    js = _jax_seeder(tiny_fm, 4)
    _assert_shards_equal(chunk, *_jax_heads(js, chunk))
    assert not chunk["heads"][:, 3:14].any()
    jst = JaxStats()
    js.run_flat([jax_encode(r.seq) for r in reads], jst)
    assert _stats(st) == _stats(jst)
    assert st.bwt_queries > st.bwt_calls > 0          # real reuse
    assert [getattr(sd, c) for c in CAPS] == [getattr(js, c) for c in CAPS]


def test_forced_overflow_caps_equal_jax(tiny_fm, port_fm, reads,
                                        single_sam):
    """GP_F = 4 at S = 4: every shard overflows its round-1 pool, reruns
    its own reads on the lockstep seeder and doubles the cap (four times
    in one chunk, as in the JAX package); SAM unchanged; heads, counters
    and the caps after the run equal the JAX ShardedSeeder's."""
    sd, eng = _sharded(port_fm, 4, GP_F=FORCED_GP_F)
    seen = _capture(sd)
    st = SeedingStats()
    assert _align(port_fm, reads, sd, eng, st) == single_sam
    assert sd.last_overflow and sd.last_qd is None
    js = _jax_seeder(tiny_fm, 4, FORCED_GP_F)
    _assert_shards_equal(seen[0], *_jax_heads(js, seen[0]))
    jst = JaxStats()
    js.run_flat([jax_encode(r.seq) for r in reads], jst)
    assert js.last_overflow
    assert [getattr(sd, c) for c in CAPS] == [getattr(js, c) for c in CAPS]
    assert sd.GP_F == FORCED_GP_F << 4 and sd._cap_raises == 4
    assert _stats(st) == _stats(jst)
    assert sd.prof["rerun_s"] > 0 and not sd._progs


@pytest.mark.parametrize("n,S", [(3, 4), (10, 4), (5, 8)])
def test_empty_and_ragged_shards(port_fm, reads, n, S):
    """n < S leaves shards empty; n not a multiple of S leaves the last
    shard short: SAM equal to the single-device run on the same reads."""
    sub = reads[:n]
    sd, eng = _sharded(port_fm, S)
    seen = _capture(sd)
    assert _align(port_fm, sub, sd, eng) == _single(port_fm, sub)
    per = -(-n // S)
    used = -(-n // per)
    assert used < S or n % S
    lens = seen[0]["rlens"].reshape(S, -1)
    assert [int((x > 0).sum()) for x in lens] == \
        [min(per, max(n - s * per, 0)) for s in range(S)]


def test_int64_index_sharded(port_fm, reads, single_sam):
    """An int64 index replicated over two shards: the DP's reference
    positions cross as two int32 words; SAM equal to the int32 run."""
    dfi = to_device(port_fm, CPU, force_dtype=np.int64)
    sd, eng = _sharded(port_fm, 2, dfi=dfi)
    assert sd.dfi.dtype == eng.dfi.dtype == torch.int64
    assert _align(port_fm, reads, sd, eng) == single_sam


def _flat(qarr, qmeta, rmeta, pac):
    """The pairs' sequences as flat host buffers (run_flat's input)."""
    l_pac = len(pac)
    qbuf, rbuf = [], []
    for (rid, q0, qlen, rev), (r0, tlen) in zip(qmeta, rmeta):
        qbuf.append(qarr[rid, q0:q0 + qlen] if rev == 0 else
                    qarr[rid, q0 - qlen + 1:q0 + 1][::-1])
        gp = r0 + (np.arange(tlen) if rev == 0 else -np.arange(tlen))
        fwd = gp < l_pac
        pf = np.where(fwd, gp, 2 * l_pac - 1 - gp)
        rbuf.append(np.where(fwd, pac[pf], 3 - pac[pf]).astype(np.uint8))
    qoff = np.concatenate([[0], np.cumsum([len(x) for x in qbuf])])
    roff = np.concatenate([[0], np.cumsum([len(x) for x in rbuf])])
    return np.concatenate(qbuf), qoff, np.concatenate(rbuf), roff


def test_sharded_engine_interfaces_vs_single(micro):
    """tests/test_parallel.py::test_sharded_meta_path_sam_identical at
    the engine's interfaces: run_meta_dual and run_meta route each pair
    to the shard owning its read (16 reads, 4 shards of 4 rows, shard 2
    owns no pair) and run_flat cuts the pairs into contiguous shards (the
    last one short); all equal the single-device engine on the same
    pairs."""
    opt = MemOptions()
    ref = micro[0]
    w = 5                    # a band that rejects some lanes at round 0
    qarr, meta = dual_meta_case(np.random.default_rng(91), ref, n=62, P=62,
                                Q=128, T=128, w0=w, opt=opt, R=16,
                                read_len=80)
    rid = meta[:, 0]
    meta[:, 0] = np.where((rid >= 8) & (rid < 12), rid - 8, rid)
    qmeta = np.ascontiguousarray(meta[:, 0:4])
    rmeta = np.stack([meta[:, 4].view(np.uint32).astype(np.int64),
                      meta[:, 6].astype(np.int64)], axis=1)
    h0, prev = meta[:, 7].copy(), meta[:, 8].copy()
    dfi = to_device(convert.fmindex_from_jax_package(micro[2]), CPU)
    one = BswRunner(opt, np.array(opt.mat), CPU, dfi=dfi)
    one.set_query_context(torch.from_numpy(qarr), qarr.shape[1])
    eng = ShardedBswRunner(opt, np.array(opt.mat), mesh=[CPU] * 4, dfi=dfi)
    assert not eng.supports_meta_dual
    eng.set_query_context(tuple(torch.from_numpy(qarr[4 * s:4 * s + 4])
                                for s in range(4)), qarr.shape[1])
    assert eng.supports_meta_dual and eng._R_rows == 4
    groups, local = eng._by_shard(qmeta)
    assert [s for s, _ in groups] == [0, 1, 3]
    assert (local[:, 0] == qmeta[:, 0] % 4).all()
    args = (w, opt.pen_clip5)
    want = one.run_meta_dual(qmeta, rmeta, h0, prev, *args)
    got = eng.run_meta_dual(qmeta, rmeta, h0, prev, *args)
    assert len(got) == 7 and all(g.flags.c_contiguous for g in got)
    assert 0 < want[6].sum() < len(h0)      # both band rounds were used
    for j in range(7):
        assert np.array_equal(got[j], want[j]), j
    want = one.run_meta(qmeta, rmeta, h0, *args)
    got = eng.run_meta(qmeta, rmeta, h0, *args)
    for j in range(6):
        assert np.array_equal(got[j], want[j]), j
    flat = _flat(qarr, qmeta, rmeta, ref)
    want = one.run_flat(*flat, h0, *args)
    got = eng.run_flat(*flat, h0, *args)
    for j in range(6):
        assert np.array_equal(got[j], want[j]), j
    assert all(len(x) == 0 for x in eng.run_meta_dual(
        qmeta[:0], rmeta[:0], h0[:0], prev[:0], *args))


def test_data_parallel_step_vs_unsharded(port_fm):
    """data_parallel_step cuts the batch into contiguous shards (ragged
    here), runs fn per shard and returns the rows in order: equal to one
    call on the whole batch, for a tensor and a tuple result."""
    dfi = to_device(port_fm, CPU)
    k = torch.from_numpy(np.random.default_rng(3).integers(
        0, port_fm.seq_len + 1, 50)).to(torch.int64)
    want = dfm.sa_batch(dfi, k)
    run = tmesh.data_parallel_step([CPU] * 3, dfm.sa_batch, dfi)
    assert torch.equal(run(k), want)
    run2 = tmesh.data_parallel_step(
        [CPU] * 4, lambda d, b: (dfm.sa_batch(d, b), b * 2), dfi)
    got, twice = run2(k)
    assert torch.equal(got, want) and torch.equal(twice, k * 2)


def test_launch_counts_lose_no_update_across_threads():
    """The sharded path's worker threads count their launches side by
    side: many threads, a short switch interval, no lost increment."""
    import concurrent.futures as cf
    from compseed_tpu_torch.ops import bsw_cuda
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(max_workers=32) as ex:
            for f in [ex.submit(lambda: [bsw_cuda.LIB.launched(
                    "probe_add_one_kernel") for _ in range(2000)])
                    for _ in range(32)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 32 * 2000
    bsw_cuda.LAUNCHES["probe_add_one_kernel"] = n0


def test_make_mesh_and_replicate_index(port_fm, monkeypatch):
    """make_mesh: the given devices (cuda taken as cuda:0), by default
    every card, and an error without one, never the CPU; one index
    replica per distinct device, the given one where it already lies."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedSeeder(MemOptions(), port_fm)
    with pytest.raises(ValueError, match="empty"):
        tmesh.make_mesh([])
    assert tmesh.make_mesh(["cuda", "cpu", "cuda:1"]) == [
        torch.device("cuda", 0), CPU, torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_mesh() == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    dfi = to_device(port_fm, CPU)
    reps = tmesh.replicate_index([CPU] * 3, dfi)
    assert list(reps) == [CPU] and reps[CPU] is dfi
    assert tmesh.distinct(["a", "b", "a"]) == ["a", "b"]


# ----------------------------------------------------------------------
# the constants chip_smoke.py holds the card's sharded heads to
# ----------------------------------------------------------------------

def jax_mesh_heads(n: int = HEAD_READS, S: int = HEAD_SHARDS) -> dict:
    """Each shard's head record for the first ``n`` bench reads cut into
    ``S`` shards, from the JAX package's ShardedSeeder on ``S`` virtual
    CPU devices, over the index with int32 and with int64 positions."""
    from compseed_tpu.index.fmindex import FMIndex as JaxFMIndex
    from compseed_tpu.ops.device_index import to_device as jax_to_device
    from compseed_tpu_torch import bench_input
    from compseed_tpu_torch.parallel.sharded import shard_layout
    from tests.test_torch_engines import head_record
    _, reads = bench_input.setup()
    fm = JaxFMIndex.load(bench_input.index_prefix(8))
    _, R, L, qarr, rlens, _ = shard_layout(list(reads[:n]), S)
    out = {}
    for name, dt in (("int32", np.int32), ("int64", np.int64)):
        from compseed_tpu.parallel.sharded import ShardedSeeder as JaxSharded
        js = JaxSharded(JaxOptions(), fm, mesh=jax_mesh(jax.devices()[:S]),
                        dfi=jax_to_device(fm, force_dtype=dt), dedup=True)
        heads, seeds = _jax_heads(js, dict(R=R, L=L, qarr=qarr, rlens=rlens))
        out[name] = [head_record(h, p) for h, p in zip(heads, seeds)]
    return out


def test_mesh_heads_json_matches_the_layout():
    """The stored constants are per shard of phase 7's first chunk: four
    clean shards of 4,096 reads, int32 and int64 positions."""
    with open(HEADS_JSON) as f:
        stored = json.load(f)
    chunk = stored["chunk"]
    assert (chunk["reads"], chunk["shards"]) == (HEAD_READS, HEAD_SHARDS)
    assert chunk["R_shard"] == HEAD_READS // HEAD_SHARDS
    assert set(stored["heads"]) == {"int32", "int64"}
    for recs in stored["heads"].values():
        assert len(recs) == HEAD_SHARDS
        for rec in recs:
            assert len(rec["scalars"]) == 28 and rec["scalars"][1] > 0
            assert not any(rec["scalars"][3:14])


if __name__ == "__main__" and sys.argv[1:] == ["--write-heads"]:
    heads = jax_mesh_heads()
    with open(HEADS_JSON, "w") as f:
        json.dump(dict(
            source="compseed_tpu.parallel.sharded.ShardedSeeder on "
                   f"{HEAD_SHARDS} virtual CPU devices, each shard's head "
                   "and seed matrix, over the index with int32 and with "
                   "int64 positions",
            command="JAX_PLATFORMS=cpu python -m tests.test_torch_mesh "
                    "--write-heads",
            chunk=dict(reads=HEAD_READS, shards=HEAD_SHARDS,
                       R_shard=HEAD_READS // HEAD_SHARDS, L=128,
                       input="the first reads of "
                             "compseed_tpu_torch.bench_input.setup()"),
            heads=heads), f, indent=1)
        f.write("\n")
