"""The hand-written CUDA kernels (the DP with int32 and with int16 state
on shared-memory rows and on the device-memory scratch, the fused
decode + two-round DP, the launch probe; the FM kernels of
csrc/fm_walk.cu on the bench index with int32 and int64 positions, and
the walks on a random 2^24-base table at ragged lane counts, the
extension on the random 2^30-base table)
against their plain PyTorch versions, on the card; launches from worker
threads and on a second card (that test skips unless two are visible);
the seeder's first bench chunk with the FM kernels against the same with
their plain versions; chain_scan's round on the kernels of
csrc/chain_scan.cu against the plain round (the first bench chunk, int32
and int64 positions; its captured rounds kernel by kernel, round 2's also
cut to a ragged width and padded; the probe at every round-1 width, round
2's and one block, through a segment's first round and the next; from
worker threads); walk_pool_chain's round on the kernels of csrc/walk_chain.cu
the same ways (its captured rounds also with few representatives and in
forced forms); the sharded pipeline on one card against the unsharded
one; the round loops as CUDA graphs (each segment one graph with a WHILE
node): every chain_scan and walk_pool_chain call of the first bench
chunk against the plain loop and each round's sort against torch.sort,
no host sync inside a call, the capture guard, a sharded worker
capturing beside the main thread's DP, graphs kept across chunks; a
segment's graph, whose rounds end with the apply's folded loop test,
against the plain loop; the segment entry kernels and the suffix-array
walk's stage entry kernel at every boundary of the first bench chunk
against their plain versions, and sa_batch_compact by its kernels (its
loop's test in the walk's last block) against its plain version, its
last stage's loop over three rounds and more too; the lockstep engines'
kernels (csrc/lockstep.cu: the scan, a walk stage's segment and entry)
on every scan and stage call of all_off's and bwd_win's first bench
chunk against their plain versions, and the forward stage kernel on every
stage of fwd_staged's; each engine that takes the call graph since
against its eager _run, and sa_batch's loop graph against the
host-tested loop.
Every test here is marked ``cuda`` and skips without a card.
The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from compseed_tpu_torch.ops import bsw_cuda
from compseed_tpu_torch.ops.bsw import (_extend_core, _meta_dual_core,
                                        _meta_dual_plain)

from torch_dp_cases import GAP, MAT, OPT, dp_tiles, dual_case

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
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel=n0["bsw_extend_kernel"] + 1)
    assert got.shape == (4096, 8) and got.dtype == torch.int32
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0])
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert not got[:, 6:].any()


@pytest.mark.parametrize("T", [128, 256])
def test_int16_kernel_vs_plain_and_int32_kernel_on_card(dev, T):
    """int16 kernel == plain int16 version == int32 kernel, exactly,
    where the stored values fit 16 bits; one launch per call, counted
    under the int16 kernel's name."""
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(20 + T, P=4096, T=T))
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=True)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_i16=n0["bsw_extend_kernel_i16"] + 1)
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=True)
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert torch.equal(got, bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP))


def test_int16_kernel_wraps_like_its_plain_version_on_card(dev):
    """Beyond the gate (h0 past 16 bits) the int16 kernel still equals
    its plain version, and both differ from the int32 kernel: the rows
    really are 16 bits wide."""
    mat = torch.from_numpy(MAT).to(dev)
    q, ql, t, tl, h0, ws = dp_tiles(33, P=512)
    h0[::3] = 40000
    tiles = _on(dev, (q, ql, t, tl, h0, ws))
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=True)
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=True)
    assert torch.equal(got[:, :6].cpu(), want.T.cpu())
    assert not torch.equal(got, bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP))


def test_probe_and_self_check_on_card(dev, monkeypatch):
    """The probe kernel equals x + 1; self_check passes, counts its
    launch, and raises when the expectation is corrupted."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    assert torch.equal(bsw_cuda.probe_add_one(x), bsw_cuda._probe_plain(x))
    bsw_cuda.self_check(dev)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 2
    with pytest.raises(ValueError):
        bsw_cuda.probe_add_one(x[:4].contiguous())
    monkeypatch.setattr(bsw_cuda, "_probe_plain", lambda v: v + 2)
    with pytest.raises(RuntimeError, match="self-check"):
        bsw_cuda.self_check(dev)


def test_engine_runs_self_check_on_card(dev):
    """Building a DP engine on a card launches the probe once: the
    self-check's only site."""
    from compseed_tpu_torch.ops.bsw import BswRunner
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    BswRunner(OPT, MAT, dev)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1


def test_wrapper_checks_inputs_on_card(dev):
    """Wrong dtype, shape or layout raises before any launch."""
    mat = torch.from_numpy(MAT).to(dev)
    q, ql, t, tl, h0, ws = _on(dev, dp_tiles(3, P=64))
    n0 = dict(bsw_cuda.LAUNCHES)
    for args, err in (
            ((mat, q.to(torch.int32), ql, t, tl, h0, ws), TypeError),
            ((mat, q, ql[:32], t, tl, h0, ws), ValueError),
            ((mat, q, ql, t.t().contiguous().t(), tl, h0, ws), ValueError),
            ((mat, q, ql.cpu(), t, tl, h0, ws), ValueError)):
        with pytest.raises(err):
            bsw_cuda.bsw_extend_tiles(*args, **GAP)
    assert bsw_cuda.LAUNCHES == n0


def _plain_tiles(mat, tiles, state16=False):
    q, ql, t, tl, h0, ws = tiles
    return _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0], state16=state16).T.cpu()


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("Q", [256, 512])
def test_kernel_longer_query_classes_on_card(dev, Q, state16):
    """Q = 256 and 512 still take the shared-memory rows (fewer pairs a
    block) and equal the plain version."""
    assert bsw_cuda.block_threads(Q, state16) > 0
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(40 + Q, P=1024, Q=Q, T=256))
    kernel = "bsw_extend_kernel_i16" if state16 else "bsw_extend_kernel"
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(n0, **{kernel: n0[kernel] + 1})
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles, state16))


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
def test_gmem_class_on_card(dev, state16):
    """A query-length class whose rows do not fit in shared memory takes
    the device-memory-scratch kernel, by shape alone, counted under its
    own name; the same kernel launched on a class that fits (0 pairs a
    block in the private launcher) equals the shared-memory one."""
    Q = 2048 if state16 else 1024
    assert bsw_cuda.block_threads(Q, state16) == 0
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(50, P=512, Q=Q, T=128))
    n0 = dict(bsw_cuda.LAUNCHES)
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_gmem=n0["bsw_extend_kernel_gmem"] + 1)
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles, state16))
    small = _on(dev, dp_tiles(51, P=1024))
    a = bsw_cuda.bsw_extend_tiles(mat, *small, **GAP, state16=state16)
    b = bsw_cuda._launch_extend(mat, *small, **GAP, state16=state16,
                                threads=0)
    assert torch.equal(a, b)
    assert bsw_cuda.LAUNCHES["bsw_extend_kernel_gmem"] == \
        n0["bsw_extend_kernel_gmem"] + 2


def test_refused_shared_memory_raises_on_card(dev):
    """A block size whose rows exceed the card's shared memory is a
    launch error that reaches the caller; nothing is counted and the next
    launch is unaffected."""
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(60, P=2048))
    assert 1024 * bsw_cuda.pair_bytes(128) > bsw_cuda.SMEM_PER_BLOCK
    n0 = dict(bsw_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        bsw_cuda._launch_extend(mat, *tiles, **GAP, state16=False,
                                threads=1024)
    assert bsw_cuda.LAUNCHES == n0
    got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :6].cpu(), _plain_tiles(mat, tiles))


def _dual_on(dev, seed, **kw):
    qarr, pac, l_pac, meta = dual_case(seed, **kw)
    args = (torch.from_numpy(MAT).to(dev),
            torch.from_numpy(qarr.reshape(-1).copy()).to(dev),
            torch.from_numpy(pac).to(dev), torch.from_numpy(meta).to(dev))
    return args, dict(Q=kw["Q"], T=kw["T"], L=qarr.shape[1], l_pac=l_pac,
                      w0=kw["w0"], wide_r0=kw.get("wide_r0", False), **GAP)


@pytest.mark.parametrize("state16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("Q,w0,wide", [(128, 5, False), (128, 100, True),
                                       (128, 1, False), (256, 8, True)])
def test_fused_kernel_vs_plain_on_card(dev, Q, w0, wide, state16):
    """bsw_meta_dual_kernel == its plain version (build_tiles + the plain
    DP twice + acceptance), all eight columns: reverse lanes, reads across
    l_pac, lanes rejected at round 0, pad lanes (rejected at w0 = 1), both
    r0 widths; ONE launch, counted under the kernel's name, and no DP
    tile kernel."""
    args, kw = _dual_on(dev, 70 + Q + w0, n=3000, P=4096, Q=Q, T=256, w0=w0,
                        wide_r0=wide)
    kernel = "bsw_meta_dual_kernel_i16" if state16 else "bsw_meta_dual_kernel"
    n0 = dict(bsw_cuda.LAUNCHES)
    got = _meta_dual_core(*args, **kw, state16=state16)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(n0, **{kernel: n0[kernel] + 1})
    want = _meta_dual_plain(*args, **kw, state16=state16)
    assert bsw_cuda.LAUNCHES[kernel] == n0[kernel] + 1
    assert got.shape == (4096, 8) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want.cpu())
    rnd = got[:3000, 6]
    if w0 == 1:                  # the acceptance is 0 < 0: every lane
        assert int(rnd.sum()) == 3000
    elif w0 == 5:                # a band the 5-base insertions leave
        assert 0 < int(rnd.sum()) < 3000
    assert (got[3000:, 6] == (1 if w0 == 1 else 0)).all()


def test_fused_gmem_class_on_card(dev):
    """For a class whose rows do not fit, _meta_dual_core builds tiles and
    launches the device-memory-scratch kernel once per round."""
    args, kw = _dual_on(dev, 90, n=300, P=512, Q=1024, T=256, w0=8)
    n0 = dict(bsw_cuda.LAUNCHES)
    got = _meta_dual_core(*args, **kw)
    torch.cuda.synchronize()
    assert bsw_cuda.LAUNCHES == dict(
        n0, bsw_extend_kernel_gmem=n0["bsw_extend_kernel_gmem"] + 2)
    assert torch.equal(got.cpu(), _meta_dual_plain(*args, **kw).cpu())
    with pytest.raises(ValueError, match="do not fit"):
        bsw_cuda.bsw_meta_dual(*args, **kw)


def test_fused_wrapper_checks_inputs_on_card(dev):
    """Wrong dtype, shape, layout or device raises before any launch."""
    (mat, qflat, pac, meta), kw = _dual_on(dev, 91, n=100, P=512, Q=128,
                                           T=128, w0=8)
    n0 = dict(bsw_cuda.LAUNCHES)
    for args, err in (
            ((mat, qflat.to(torch.int8), pac, meta), TypeError),
            ((mat, qflat, pac.to(torch.int32), meta), TypeError),
            ((mat, qflat, pac, meta[:, :8].contiguous()), ValueError),
            ((mat, qflat[:-1], pac, meta), ValueError),
            ((mat, qflat, pac, meta.t().contiguous().t()), ValueError),
            ((mat.cpu(), qflat, pac, meta), ValueError)):
        with pytest.raises(err):
            bsw_cuda.bsw_meta_dual(*args, **kw)
    assert bsw_cuda.LAUNCHES == n0


def test_probe_out_argument_on_card(dev):
    """probe_add_one(x, out=y) writes and returns y, allocating nothing;
    a misaligned or mistyped out raises."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    y = torch.zeros_like(x)
    n0 = bsw_cuda.LAUNCHES["probe_add_one_kernel"]
    assert bsw_cuda.probe_add_one(x, out=y) is y
    torch.cuda.synchronize()
    assert torch.equal(y, x + 1)
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1
    odd = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=dev)[1:] \
        .reshape(8, 128)
    with pytest.raises(ValueError, match="aligned"):
        bsw_cuda.probe_add_one(x, out=odd)
    with pytest.raises(TypeError):
        bsw_cuda.probe_add_one(x, out=y.to(torch.int64))
    assert bsw_cuda.LAUNCHES["probe_add_one_kernel"] == n0 + 1


@pytest.mark.parametrize("what", ["256 reads", "128 pairs"])
def test_cli_mem_on_card_equals_cpu(dev, tmp_path, what):
    """``mem`` at the CLI's defaults (device engine on the card) gives
    the SAM of the same command with ``--device cpu``, every line but
    @PG, and launches a DP kernel."""
    import os
    from compseed_tpu_torch import cli
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    names, n = (("reads.fq",), 256) if what == "256 reads" else \
        (("reads_1.fq", "reads_2.fq"), 128)
    inputs = []
    for name in names:
        inputs.append(str(tmp_path / name))
        with open(os.path.join(fx, name)) as f, open(inputs[-1], "w") as g:
            for _ in range(4 * n):
                g.write(f.readline())
    sams = {}
    for tag, device in (("card", []), ("cpu", ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.sam")
        for k in bsw_cuda.LAUNCHES:
            bsw_cuda.LAUNCHES[k] = 0
        assert cli.main(["mem", *device, "-v", "1", "-o", out,
                         os.path.join(fx, "tiny"), *inputs]) == 0
        dp = sum(v for k, v in bsw_cuda.LAUNCHES.items()
                 if k.startswith("bsw_"))
        assert (dp > 0) == (tag == "card"), bsw_cuda.LAUNCHES
        with open(out) as f:
            sams[tag] = [l for l in f if not l.startswith("@PG")]
    assert sams["card"] == sams["cpu"]
    assert len(sams["card"]) >= 2 + (n if len(names) == 1 else 2 * n)


def _shared_case(dev, seed, Q=256):
    """A fused-kernel table whose block needs more than 48 KiB of dynamic
    shared memory (the per-device grant)."""
    assert bsw_cuda.block_threads(Q) * bsw_cuda.pair_bytes(Q) > 48 * 1024
    return _dual_on(dev, seed, n=900, P=1024, Q=Q, T=256, w0=8)


def test_shared_memory_grant_from_worker_threads_on_card(dev):
    """Blocks over 48 KiB (Q = 256 and 512) launched from worker threads,
    two classes side by side, then again from this thread: every launch
    runs on the tensors' card and equals the plain version."""
    import concurrent.futures as cf
    cases = [_shared_case(dev, 120 + i, Q) for i, Q in
             enumerate((256, 512, 256, 512))]

    def launch(case):
        args, kw = case
        got = _meta_dual_core(*args, **kw)
        torch.cuda.synchronize(args[0].device)
        return got.cpu()

    n0 = bsw_cuda.LAUNCHES["bsw_meta_dual_kernel"]
    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(launch, cases))
    got += [launch(c) for c in cases]
    assert bsw_cuda.LAUNCHES["bsw_meta_dual_kernel"] == n0 + 8
    for i, (args, kw) in enumerate(cases * 2):
        assert torch.equal(got[i], _meta_dual_plain(*args, **kw).cpu()), i


def test_dp_on_a_second_card_first(dev):
    """Skips unless two cards are visible (one H100 runs none of it).
    The DP with blocks over 48 KiB on cuda:1 while cuda:0 is current,
    then on cuda:0: each launch goes to its tensors' card, and the
    shared-memory grant of one card does not stand in for the other's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    d1 = torch.device("cuda", 1)
    for d in (d1, dev):
        with torch.cuda.device(0):
            args, kw = _shared_case(d, 140)
            got = _meta_dual_core(*args, **kw)
            tiles = _on(d, dp_tiles(141, P=1024, Q=256, T=256))
            mat = torch.from_numpy(MAT).to(d)
            tl = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
        torch.cuda.synchronize(d)
        assert got.device == tl.device == d
        assert torch.equal(got.cpu(), _meta_dual_plain(*args, **kw).cpu())
        assert torch.equal(tl[:, :6].cpu(), _plain_tiles(mat, tiles))
        bsw_cuda.self_check(d)


def test_sharded_pipeline_on_one_card_equals_unsharded(dev, tmp_path):
    """The sharded pipeline on [cuda:0, cuda:0] (two shards in turn on one
    card): SAM equal to the single-device pipeline on the card, with the
    fused kernel launched for both shards."""
    import os

    import numpy as np

    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import read_fastq_chunks
    from compseed_tpu_torch.native import NativeTail
    from compseed_tpu_torch.ops.engine import device_engine, device_seeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.parallel.sharded import (ShardedBswRunner,
                                                     ShardedSeeder)
    from compseed_tpu_torch.pipeline.align import align_chunk
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    fm = FMIndex.load(os.path.join(fx, "tiny"))
    reads = []
    for chunk in read_fastq_chunks(os.path.join(fx, "reads.fq"), 10**9):
        reads.extend(chunk)
    reads = reads[:240]
    opt = MemOptions()

    def run(seeder, engine):
        rs = [r.__class__(**r.__dict__) for r in reads]
        align_chunk(opt, fm, rs, 0, engine=engine, seeder=seeder,
                    tail=NativeTail(opt, fm))
        return "".join(r.sam for r in rs)

    sd = device_seeder(opt, fm, dedup=True, device=dev)
    want = run(sd, device_engine(opt, fm, dfi=sd.dfi, device=dev))
    sd = ShardedSeeder(opt, fm, mesh=[dev, dev], dedup=True)
    eng = ShardedBswRunner(opt, np.array(opt.mat), mesh=[dev, dev],
                           dfi=sd.dfi)
    n0 = bsw_cuda.LAUNCHES["bsw_meta_dual_kernel"]
    assert run(sd, eng) == want
    assert not sd.last_overflow and len(sd.last_qd) == 2
    assert bsw_cuda.LAUNCHES["bsw_meta_dual_kernel"] >= n0 + 2


# ---------------------------------------------------------------------------
# The FM kernels (csrc/fm_walk.cu) over the bench index.

@pytest.fixture(scope="module")
def bench():
    """The bench input (2 Mbp genome at sa_intv 8 and its reads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from compseed_tpu_torch import bench_input
    return bench_input.setup()


def _bench_index(bench, dev, dtype):
    import numpy as np

    from compseed_tpu_torch.ops.device_index import to_device
    return to_device(bench[0], dev,
                     force_dtype=np.int64 if dtype == "int64" else None)


def _fm_calls(dfi, rng, n=16384):
    """(kernel, plain, args, kwargs) for every FM kernel on n seeded lanes:
    the extension both ways and as a (P, MLEP, 3) batch, the chain walk at
    W = 5 forward and W = 8 backward with stop_s, the inverse-Psi walk
    over one and two sa_intv."""
    import numpy as np

    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.fm_cases import (intervals, pack, sa_lanes,
                                                 windows)
    from compseed_tpu_torch.ops.smem import MLEP
    dev = dfi.device

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ik = intervals(dfi, rng, n, depth=14)
    c = on(rng.integers(0, 4, n).astype(np.int32))
    ikb = intervals(dfi, rng, 512 * MLEP, depth=14).reshape(512, MLEP, 3)
    cb = on(rng.integers(0, 4, 512).astype(np.int32))[:, None].expand(
        512, MLEP)
    U = n // 2
    iku = intervals(dfi, rng, U, depth=14)
    k, l, s = (iku[:, i].contiguous() for i in range(3))
    valid = on(rng.random(U) < 0.9)
    stop = on(rng.integers(1, 40, U)).to(dfi.dtype)
    kk, steps, alive = (on(x) for x in sa_lanes(dfi, rng, n))
    calls = []
    for is_back in (False, True):
        calls.append((fm_cuda.extend_sel_batch, tfm._extend_sel_plain,
                      (dfi, ik, c, is_back), {}))
    calls.append((fm_cuda.extend_sel_batch, tfm._extend_sel_plain,
                  (dfi, ikb, cb, True), {}))
    for W, is_back, stop_s in ((5, False, None), (8, True, stop)):
        wv = on(pack(windows(rng, U, W)))
        calls.append((fm_cuda.chain_walk, tss._chain_walk_plain,
                      (dfi, wv, W, k, l, s, valid),
                      dict(is_back=is_back, stop_s=stop_s)))
    for n_steps in (dfi.sa_intv, 2 * dfi.sa_intv):
        calls.append((fm_cuda.inv_psi_walk, tfm._walk_plain,
                      (dfi, kk, steps, alive, n_steps), {}))
    return calls


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _kernel_name(fn):
    return {"extend_sel_batch": "fm_extend_sel_kernel",
            "chain_walk": "fm_chain_walk_kernel",
            "inv_psi_walk": "fm_inv_psi_walk_kernel"}[fn.__name__]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_fm_kernels_vs_plain_on_bench_index(dev, bench, dtype):
    """Every FM kernel equals its plain version exactly on 16,384 seeded
    lanes over the bench index; one launch per call, counted."""
    import numpy as np

    from compseed_tpu_torch.ops import fm_cuda
    dfi = _bench_index(bench, dev, dtype)
    assert dfi.dtype == getattr(torch, dtype)
    for kernel, plain, a, kw in _fm_calls(dfi, np.random.default_rng(61)):
        n0 = dict(fm_cuda.LAUNCHES)
        got = _as_tuple(kernel(*a, **kw))
        torch.cuda.synchronize()
        name = _kernel_name(kernel)
        assert fm_cuda.LAUNCHES == dict(n0, **{name: n0[name] + 1})
        want = _as_tuple(plain(*a, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device == dev and g.dtype == w.dtype
            assert torch.equal(g, w), (name, kw)


def test_fm_kernels_fill_oob_lanes_on_card(dev, bench):
    """Garbage lanes under fill_oob (a block in [-n, 0) wraps, one outside
    [-n, n) reads all-ones words): each kernel equals its plain version."""
    import dataclasses

    import numpy as np

    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.fm_cases import garbage, pack, windows
    rng = np.random.default_rng(62)
    for dtype in ("int32", "int64"):
        oob = dataclasses.replace(_bench_index(bench, dev, dtype),
                                  fill_oob=True)
        g = torch.from_numpy(garbage(oob, 4096)).to(dev).to(oob.dtype)
        ik = torch.stack([g, g.flip(0), torch.full_like(g, 9)], dim=1)
        c = torch.from_numpy(rng.integers(0, 4, 4096).astype(np.int32)) \
            .to(dev)
        for is_back in (False, True):
            assert torch.equal(fm_cuda.extend_sel_batch(oob, ik, c, is_back),
                               tfm._extend_sel_plain(oob, ik, c, is_back))
        wv = torch.from_numpy(pack(windows(rng, 4096, 8))).to(dev)
        on = torch.ones(4096, dtype=torch.bool, device=dev)
        a = (oob, wv, 8, ik[:, 0].contiguous(), ik[:, 1].contiguous(),
             ik[:, 2].contiguous(), on)
        for got, want in zip(fm_cuda.chain_walk(*a, is_back=True),
                             tss._chain_walk_plain(*a, is_back=True)):
            assert torch.equal(got, want)
        gg = g.abs() | 1
        for got, want in zip(fm_cuda.inv_psi_walk(oob, gg, gg * 0, on, 3),
                             tfm._walk_plain(oob, gg, gg * 0, on, 3)):
            assert torch.equal(got, want)


def test_fm_kernel_out_of_range_row_traps_on_card(tmp_path):
    """Without fill_oob a row outside the table is no input: the kernel
    traps (as the plain version's index check fails) and never reads past
    the table.  Run in a child process, since a trap ends its context."""
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "from compseed_tpu_torch.index.fmindex import FMIndex\n"
        "from compseed_tpu_torch.ops import fm\n"
        "from compseed_tpu_torch.ops.device_index import to_device\n"
        "d = to_device(FMIndex.load(sys.argv[1]), torch.device('cuda', 0))\n"
        "big = d.n_rows * 128 + 7\n"
        "ik = torch.tensor([[big, big, 3]], dtype=d.dtype, device='cuda:0')\n"
        "c = torch.zeros(1, dtype=torch.int32, device='cuda:0')\n"
        "out = fm.extend_sel_batch(d, ik, c, False)\n"
        "torch.cuda.synchronize()\n"
        "print('NO FAULT', out.tolist())\n")
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(root, "tests", "fixtures", "tiny")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "NO FAULT" not in r.stdout, r.stdout


def test_fm_extend_child_out_of_range_traps_on_card():
    """A child outside [0, 3] is no input of the extension: its lane traps
    before it reads a row or L2 past its four bases.  In a child process,
    as above."""
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "from compseed_tpu_torch.index.fmindex import FMIndex\n"
        "from compseed_tpu_torch.ops import fm\n"
        "from compseed_tpu_torch.ops.device_index import to_device\n"
        "d = to_device(FMIndex.load(sys.argv[1]), torch.device('cuda', 0))\n"
        "ik = torch.tensor([[1, 1, 1]] * 64, dtype=d.dtype, device='cuda:0')\n"
        "c = torch.zeros(64, dtype=torch.int32, device='cuda:0')\n"
        "c[37] = 4\n"
        "out = fm.extend_sel_batch(d, ik, c, False)\n"
        "torch.cuda.synchronize()\n"
        "print('NO FAULT', out.tolist())\n")
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(root, "tests", "fixtures", "tiny")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "NO FAULT" not in r.stdout, r.stdout


def test_fm_kernels_from_a_worker_thread_on_card(dev, bench):
    """FM kernels launched from worker threads on cuda:0 (the sharded
    path's rule): each equals its plain version."""
    import concurrent.futures as cf

    import numpy as np
    dfi = _bench_index(bench, dev, "int32")
    calls = _fm_calls(dfi, np.random.default_rng(63), n=4096)

    def launch(call):
        kernel, _, a, kw = call
        out = _as_tuple(kernel(*a, **kw))
        torch.cuda.synchronize(dev)
        return out

    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(launch, calls))
    for (kernel, plain, a, kw), g in zip(calls, got):
        for x, w in zip(g, _as_tuple(plain(*a, **kw))):
            assert torch.equal(x, w), _kernel_name(kernel)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_fm_walks_vs_plain_on_random_table_on_card(dev, dtype):
    """The walks (a pair of threads a lane over the packed table) equal
    their plain versions on a random 2^24-base table: one lane, a lane
    count that fills no whole block, W in {1, 5, 8, 10} both ways with and
    without stop_s; the inverse-Psi walk at 1 and 1,001 lanes over 1, 8
    and 16 steps; one counted launch per call."""
    import dataclasses

    import numpy as np

    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.fm_cases import (random_chain_lanes,
                                                 random_index,
                                                 random_sa_lanes)
    dfi = random_index(1 << 24, 71, dev)
    if dtype == "int64":
        dfi = dataclasses.replace(dfi, idx_dtype=np.int64,
                                  L2=dfi.L2.to(torch.int64))
    gen = torch.Generator(device=dev).manual_seed(72)
    n0 = dict(fm_cuda.LAUNCHES)
    calls = 0
    for U in (1, 1001):
        for W in (1, 5, 8, 10):
            for is_back in (False, True):
                for stop in (False, True):
                    a, kw = random_chain_lanes(dfi, gen, U, W, is_back, stop)
                    got = fm_cuda.chain_walk(*a, **kw)
                    want = tss._chain_walk_plain(*a, **kw)
                    calls += 1
                    for name, g, w in zip(("ck", "cl", "cs", "ln"), got,
                                          want):
                        assert torch.equal(g, w), (U, W, is_back, stop, name)
        for n in (1, 8, 16):
            a, _ = random_sa_lanes(dfi, gen, U, n)
            for g, w in zip(fm_cuda.inv_psi_walk(*a), tfm._walk_plain(*a)):
                assert torch.equal(g, w), (U, n)
    torch.cuda.synchronize()
    assert fm_cuda.LAUNCHES["fm_chain_walk_kernel"] == \
        n0["fm_chain_walk_kernel"] + calls
    assert fm_cuda.LAUNCHES["fm_inv_psi_walk_kernel"] == \
        n0["fm_inv_psi_walk_kernel"] + 6


def test_fm_extend_vs_plain_on_2_30_table_on_card(dev):
    """The extension (a pair of threads a lane over the packed table) equals
    its plain version on chip_smoke.py's random 2^30-base table (8,388,609
    rows, 537 MB, more than 10x L2), built on the card with no int64
    copy: 131,072 random lanes both ways, and a ragged 1,001; one counted
    launch per call."""
    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops.fm_cases import (random_extend_lanes,
                                                 random_index)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dfi = random_index(1 << 30, 808, dev)
    torch.cuda.synchronize()
    table = dfi.n_rows * 64                  # 536,870,976 B
    assert table <= torch.cuda.memory_allocated(dev) - m0 <= table + 4096
    assert torch.cuda.max_memory_allocated(dev) - m0 < table * 1.25
    gen = torch.Generator(device=dev).manual_seed(809)
    n0 = fm_cuda.LAUNCHES["fm_extend_sel_kernel"]
    calls = 0
    for n in (131072, 1001):
        for is_back in (False, True):
            a, _ = random_extend_lanes(dfi, gen, n, is_back)
            got = fm_cuda.extend_sel_batch(*a)
            calls += 1
            assert torch.equal(got, tfm._extend_sel_plain(*a)), (n, is_back)
    torch.cuda.synchronize()
    assert fm_cuda.LAUNCHES["fm_extend_sel_kernel"] == n0 + calls
    del dfi
    torch.cuda.empty_cache()


def test_fm_walks_non_stepping_lanes_read_nothing_on_card(dev, bench):
    """Without fill_oob, lanes that do not step (invalid, ambiguous at the
    first base, or not alive) keep their state, however far outside the
    table it points: the walks read no row for them, so nothing traps."""
    import numpy as np

    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops.fm_cases import garbage, pack
    for dtype in ("int32", "int64"):
        dfi = _bench_index(bench, dev, dtype)
        g = torch.from_numpy(garbage(dfi, 4096)).to(dev).to(dfi.dtype)
        W = 8
        bases = np.random.default_rng(64).integers(0, 4, (4096, W))
        bases[::2, 0] = 5
        wv = torch.from_numpy(pack(bases)).to(dev)
        valid = torch.arange(4096, device=dev) % 2 == 0
        ck, cl, cs, ln = fm_cuda.chain_walk(dfi, wv, W, g, g.flip(0),
                                            torch.full_like(g, 9), valid,
                                            is_back=True)
        kk, steps, alive = fm_cuda.inv_psi_walk(
            dfi, g, torch.zeros_like(g), torch.zeros_like(valid), 5)
        torch.cuda.synchronize()
        assert not ln.any()
        assert torch.equal(ck, g[:, None].expand(-1, W))
        assert torch.equal(cl, g.flip(0)[:, None].expand(-1, W))
        assert (cs == 9).all()
        assert torch.equal(kk, g) and not steps.any() and not alive.any()


def test_replicate_index_carries_packed_table_on_card(dev, bench):
    """replicate_index copies occ_packed to the replica's device with the
    other tables, and the walks run there on it."""
    import numpy as np

    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.fm_cases import intervals, pack, windows
    from compseed_tpu_torch.parallel.mesh import replicate_index
    host = to_device(bench[0], torch.device("cpu"))
    rep = replicate_index([dev], host)[dev]
    assert rep.occ_packed.device == dev and not hasattr(rep, "occ_rows")
    assert torch.equal(rep.occ_packed.cpu(), host.occ_packed)
    rng = np.random.default_rng(65)
    ik = intervals(host, rng, 2048, depth=10)
    wv = torch.from_numpy(pack(windows(rng, 2048, 5)))
    valid = torch.ones(2048, dtype=torch.bool)
    a = (wv, 5, ik[:, 0].contiguous(), ik[:, 1].contiguous(),
         ik[:, 2].contiguous(), valid)
    want = tss._chain_walk_plain(host, *a)
    got = fm_cuda.chain_walk(rep, *(x.to(dev) if torch.is_tensor(x) else x
                                    for x in a))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_seeding_first_bench_chunk_kernels_equal_plain_on_card(
        dev, bench, monkeypatch):
    """The default engine on the first 16,384 bench reads: round 1
    (chain_scan and walk_pool_chain) -- pool, memo, deaths, counters --
    and the whole chunk's head, seed matrix and merged SAL, with the FM
    kernels, equal the same calls with _chain_walk, _walk and
    extend_sel_batch patched to their plain versions (a test-only patch;
    the rounds and the suffix-array walk then run as their plain
    versions, since a loop's graph can hold no PyTorch operation)."""
    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    R, L, qd, rd = sd._upload(list(reads[:16384]))
    fns = sd._build(R, L)

    def run():
        for k in fm_cuda.LAUNCHES:
            fm_cuda.LAUNCHES[k] = 0
        r1 = fns["r1"](qd, rd)
        whole = sd._run(fns, qd, rd)
        torch.cuda.synchronize()
        return r1, whole, dict(fm_cuda.LAUNCHES)

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for y in x for v in flat(y)]
        return [x] if isinstance(x, torch.Tensor) else []

    r1_k, whole_k, n_k = run()
    assert n_k["fm_chain_walk_kernel"] > 0 and \
        n_k["fm_inv_psi_walk_kernel"] > 0, n_k
    monkeypatch.setattr(tss, "_chain_walk", tss._chain_walk_plain)
    monkeypatch.setattr(tss, "_chain_round",
                        lambda dev_: tss._chain_round_plain)
    monkeypatch.setattr(tss, "_walk_round",
                        lambda dev_: tss._walk_round_plain)
    monkeypatch.setattr(tfm, "_walk", tfm._walk_plain)
    monkeypatch.setattr(tfm, "_sa_compact",
                        lambda dev_: tfm._sa_batch_compact_plain)
    monkeypatch.setattr(tfm, "extend_sel_batch", tfm._extend_sel_plain)
    r1_p, whole_p, n_p = run()
    assert not any(n_p.values()), n_p
    got, want = flat((r1_k, whole_k)), flat((r1_p, whole_p))
    assert len(got) == len(want) > 20
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    head = whole_k[2].cpu()
    assert not head[3:14].any()          # no cap overflow on this chunk


# ---------------------------------------------------------------------------
# chain_scan's round (csrc/chain_scan.cu) on the first bench chunk.

def _chain_launches():
    from compseed_tpu_torch.ops import chain_cuda
    return dict(chain_cuda.LAUNCHES)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_chain_round_kernels_equal_plain_on_first_bench_chunk(
        dev, bench, dtype, monkeypatch):
    """The default engine on the first 16,384 bench reads with chain_scan's
    round on the kernels of csrc/chain_scan.cu: round 1 (pool, memo,
    counters, deaths), the whole chunk's head and seed matrix equal the
    same with seedscan._chain_round patched to the plain round (a
    test-only patch), with int32 and with int64 positions; each of the
    three kernels launched, none in the plain run."""
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dfi = _bench_index(bench, dev, dtype)
    sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=True)
    R, L, qd, rd = sd._upload(list(reads[:16384]))
    fns = sd._build(R, L)

    def run():
        n0 = _chain_launches()
        r1 = fns["r1"](qd, rd)
        whole = sd._run(fns, qd, rd)
        torch.cuda.synchronize()
        n1 = _chain_launches()
        return r1, whole, {k: n1[k] - n0[k] for k in n1}

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for y in x for v in flat(y)]
        return [x] if isinstance(x, torch.Tensor) else []

    r1_k, whole_k, n_k = run()
    assert all(n_k.values()) and len(set(n_k.values())) == 1, n_k
    monkeypatch.setattr(tss, "_chain_round",
                        lambda dev_: tss._chain_round_plain)
    r1_p, whole_p, n_p = run()
    assert not any(n_p.values()), n_p
    got, want = flat((r1_k, whole_k)), flat((r1_p, whole_p))
    assert len(got) == len(want) > 20
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    head = whole_k[2].cpu()
    assert not head[3:14].any()          # no cap overflow on this chunk
    assert sd.dfi.dtype == (torch.int64 if dtype == "int64" else torch.int32)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_chain_round_steps_vs_plain_on_card(dev, bench, dtype):
    """The first bench chunk's chain_scan rounds (the first of each width:
    round 1 at 16,384 lanes and its narrower segments, round 2 at
    65,536, round 3), and each in a lossy form (1,024 table slots, a
    store with 200 free rows), through each kernel and its plain step:
    equal output by output."""
    from compseed_tpu_torch.ops import chain_cases, chain_cuda
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dfi = _bench_index(bench, dev, dtype)
    sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=True)
    with chain_cases.RoundCapture(limit=16) as cap:
        sd.run_flat(list(reads[:16384]))
    torch.cuda.synchronize()
    widths = {w for _, w in cap.states}
    assert {16384, 65536} <= widths, sorted(cap.states)
    full = 0
    for key, rnd in sorted(cap.states.items()):
        for c in (rnd, chain_cases.lossy(rnd)):
            errs = chain_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), \
                (key, stats, errs)
            full += stats["stored"] < stats["n_w"]
    assert full > 0                       # a representative found no row


_CHAIN_ROUNDS = {}


def _chain_rounds(bench, dev, dtype):
    """The states before the first chain_scan round of each width of each
    call of the first bench chunk ((call, w) -> case), once per dtype."""
    from compseed_tpu_torch.ops import chain_cases
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    if dtype not in _CHAIN_ROUNDS:
        fm, reads = bench
        sd = DeviceSeeder(MemOptions(), fm, dev,
                          dfi=_bench_index(bench, dev, dtype), dedup=True)
        with chain_cases.RoundCapture(limit=16) as cap:
            sd.run_flat(list(reads[:16384]))
        torch.cuda.synchronize()
        _CHAIN_ROUNDS[dtype] = dict(cap.states)
    return _CHAIN_ROUNDS[dtype]


def _chain_round2(bench, dev, dtype):
    """The state before round 2's first chain_scan round (65,536 lanes)
    of the first bench chunk."""
    return next(c for (_, w), c in sorted(
        _chain_rounds(bench, dev, dtype).items()) if w == 65536)


@pytest.mark.parametrize("form", ["wide", "ragged", "padded"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_chain_round_scan_forms_on_card(dev, bench, dtype, form):
    """Round 2's first chain_scan round of the first bench chunk through
    each kernel and its plain step, equal output by output, each form also
    lossy: as captured (65,536 lanes: 256 blocks, so that the warp-wide
    look-back takes more than one step of 32 words), cut to a width that is no multiple of a block's lanes, and
    padded (Uw = w, a quarter of the lanes alive: the pads, which the
    probe writes, are most of the representatives)."""
    from compseed_tpu_torch.ops import chain_cases, chain_cuda
    case = _chain_round2(bench, dev, dtype)
    w = case[3]
    c = {"wide": case, "ragged": chain_cases.narrow(case, w - 333),
         "padded": chain_cases.padded(case)}[form]
    for c in (c, chain_cases.lossy(c)):
        errs = chain_cases.steps_vs_plain(c)
        stats = errs.pop("stats")
        assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), (form, stats)
        assert stats["w"] > 32 * chain_cuda.BLOCK
        assert stats["applied"] > 0 and stats["pushes"] > 0
        if form == "ragged":
            assert stats["w"] % chain_cuda.BLOCK
        if form == "padded":
            assert stats["Uw"] - stats["n_w"] > 2 * stats["n_w"], stats


@pytest.mark.parametrize("form", ["captured", "lossy", "padded"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_chain_probe_forms_on_card(dev, bench, dtype, form):
    """chain_probe_kernel on round 1's captured widths (16,384, 4,096 and
    1,024 lanes), round 2's 65,536 and the first 256 lanes (one block of
    the group and of the probe), as captured, lossy and padded, through
    a segment's first round and the next on one set of launch arguments
    (the probe reads each lane's read id from the state's lane_rid):
    every probe output, the pads and the round's group and apply outputs
    equal the plain steps, and lane_rid holds lane_rid0[lane0]."""
    from compseed_tpu_torch.ops import chain_cases, chain_cuda
    rounds = _chain_rounds(bench, dev, dtype)
    r1 = {w: c for (call, w), c in rounds.items() if call == 1}
    assert {16384, 4096, 1024} <= set(r1), sorted(rounds)
    cases = [r1[16384], r1[4096], r1[1024], _chain_round2(bench, dev, dtype),
             chain_cases.narrow(r1[16384], 256)]
    for case in cases:
        c = {"captured": case, "lossy": chain_cases.lossy(case),
             "padded": chain_cases.padded(case)}[form]
        fm, const, st, w, Uw = c
        ks, ps = chain_cases.clone_state(st), chain_cases.clone_state(st)
        rd = chain_cuda.ChainRound(fm, const, ks, w, Uw)
        for r in range(2):
            errs, ps = chain_cases.round_vs_plain(fm, const, rd, ks, ps, w,
                                                  Uw)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(chain_cuda.KERNELS, 0), \
                (w, form, r, stats)
            assert torch.equal(ks["lane_rid"], const["lane_rid0"][
                ks["lane0"].to(torch.int64)])
            if form == "padded" and r == 0:
                assert stats["Uw"] - stats["n_w"] > 2 * stats["n_w"], stats
        torch.cuda.synchronize()


def test_chain_scan_from_worker_threads_on_card(dev, bench):
    """chain_scan on cuda:0 from four worker threads side by side (the
    sharded path's rule): each equals the same call made alone."""
    import concurrent.futures as cf

    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    parts = [sd._upload(list(reads[i * 2048:(i + 1) * 2048]))
             for i in range(4)]

    def scan(part):
        R, L, qd, rd = part
        memo = tss.make_chain_memo(1 << 16, 8192, 5, sd.dfi.dtype, dev)
        out = tss.chain_scan(sd.dfi, qd, rd, 24 * R, memo, W=5)
        # the thread's stream, not the device: a device-wide sync while
        # another thread captures a graph invalidates that capture
        torch.cuda.current_stream(dev).synchronize()
        return out

    alone = [scan(p) for p in parts]
    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        side = list(ex.map(scan, parts))
    for a, b in zip(alone, side):
        for x, y in zip(a[:5], b[:5]):
            assert torch.equal(x, y)
        for k in tss.MEMO_KEYS:
            assert torch.equal(a[5][k], b[5][k])


# ---------------------------------------------------------------------------
# walk_pool_chain's round (csrc/walk_chain.cu) on the first bench chunk.

def _walk_launches():
    from compseed_tpu_torch.ops import walk_cuda
    return dict(walk_cuda.LAUNCHES)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_round_kernels_equal_plain_on_first_bench_chunk(
        dev, bench, dtype, monkeypatch):
    """The default engine on the first 16,384 bench reads with
    walk_pool_chain's round on the kernels of csrc/walk_chain.cu: every
    walk_pool_chain call's deaths, fk, fl, fs, ovf and counters, round 1's
    outputs (pool, SMEMs, counters), the whole chunk's head and seed matrix
    equal the same with seedscan._walk_round patched to the plain round (a
    test-only patch), with int32 and with int64 positions; each of the
    three kernels launched, none in the plain run."""
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dfi = _bench_index(bench, dev, dtype)
    sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=True)
    R, L, qd, rd = sd._upload(list(reads[:16384]))
    fns = sd._build(R, L)
    walk = tss.walk_pool_chain

    def run():
        calls = []

        def recorded(*a, **kw):
            out = walk(*a, **kw)
            calls.append([x.clone() for x in out])
            return out

        n0 = _walk_launches()
        with monkeypatch.context() as m:
            m.setattr(tss, "walk_pool_chain", recorded)
            r1 = fns["r1"](qd, rd)
            whole = sd._run(fns, qd, rd)
        torch.cuda.synchronize()
        n1 = _walk_launches()
        return (calls, r1, whole), {k: n1[k] - n0[k] for k in n1}

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for y in x for v in flat(y)]
        return [x] if isinstance(x, torch.Tensor) else []

    got_k, n_k = run()
    assert all(n_k.values()) and len(set(n_k.values())) == 1, n_k
    assert len(got_k[0]) >= 3               # round 1 twice (r1, whole), r2
    monkeypatch.setattr(tss, "_walk_round",
                        lambda dev_: tss._walk_round_plain)
    got_p, n_p = run()
    assert not any(n_p.values()), n_p
    got, want = flat(got_k), flat(got_p)
    assert len(got) == len(want) > 40
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    head = got_k[2][2].cpu()
    assert not head[3:14].any()          # no cap overflow on this chunk
    assert sd.dfi.dtype == (torch.int64 if dtype == "int64" else torch.int32)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_round_steps_vs_plain_on_card(dev, bench, dtype):
    """The first bench chunk's walk_pool_chain rounds (the first of each
    width: round 1 at 393,216 lanes and its narrower segments, round 2 at
    262,144 ...), each also with 64 representatives and in the forced
    forms (colliding keys, a live lane keyed INT32_MAX, one after a dead
    lane of its (window, k, s)), through each kernel and its plain step:
    equal output by output."""
    from compseed_tpu_torch.ops import walk_cases, walk_cuda
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dfi = _bench_index(bench, dev, dtype)
    sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=True)
    with walk_cases.RoundCapture(limit=16) as cap:
        sd.run_flat(list(reads[:16384]))
    torch.cuda.synchronize()
    widths = {n for _, n in cap.states}
    assert {24 * 16384, 16 * 16384} <= widths, sorted(cap.states)
    deferred = forced = 0
    for key, rnd in sorted(cap.states.items()):
        forms = [rnd, walk_cases.capped(rnd)]
        if int(rnd[2]["alive"][:5].sum()) == 5:
            forms.append(walk_cases.forced(rnd))
            forced += 1
        for c in forms:
            errs = walk_cases.steps_vs_plain(c)
            stats = errs.pop("stats")
            assert errs == dict.fromkeys(walk_cuda.KERNELS, 0), \
                (key, stats, errs)
            deferred += stats["n_u"] > stats["n_w"]
    assert deferred >= len(cap.states) and forced >= 2


_WALK_R1 = {}


def _walk_round1(bench, dev, dtype):
    """The state before round 1's first walk_pool_chain round (393,216
    lanes) of the first bench chunk, once per dtype."""
    from compseed_tpu_torch.ops import walk_cases
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    if dtype not in _WALK_R1:
        fm, reads = bench
        sd = DeviceSeeder(MemOptions(), fm, dev,
                          dfi=_bench_index(bench, dev, dtype), dedup=True)
        with walk_cases.RoundCapture(limit=16) as cap:
            sd.run_flat(list(reads[:16384]))
        torch.cuda.synchronize()
        _WALK_R1[dtype] = cap.states[(1, 24 * 16384)]
    return _WALK_R1[dtype]


@pytest.mark.parametrize("form", ["wide", "ragged", "padded", "W5"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_round_scan_forms_on_card(dev, bench, dtype, form):
    """Round 1's first walk_pool_chain round of the first bench chunk
    through each kernel and its plain step, equal output by output (calls,
    ngrp and the live count among them), each form also capped and
    forced: as captured (393,216 lanes: 1,536 group blocks, so that the
    warp-wide look-back takes many steps of 32 words), cut to a width that
    is no multiple of a block's lanes, padded (Uw = w, a quarter of the
    lanes alive: the pads, which the key kernel writes, are most of the
    representatives) and walked 5 chars a round (chain rows of 20 and 40
    bytes, read in 4- and 8-byte pieces)."""
    from compseed_tpu_torch.ops import walk_cases, walk_cuda
    case = _walk_round1(bench, dev, dtype)
    w = case[2]["k"].shape[0]
    c = {"wide": lambda: case,
         "ragged": lambda: walk_cases.narrow(case, w - 333),
         "padded": lambda: walk_cases.padded(case),
         "W5": lambda: walk_cases.width(case, 5)}[form]()
    for i, c2 in enumerate((c, walk_cases.capped(c), walk_cases.forced(c))):
        errs = walk_cases.steps_vs_plain(c2)
        stats = errs.pop("stats")
        assert errs == dict.fromkeys(walk_cuda.KERNELS, 0), (form, i, stats)
        assert stats["w"] > 32 * walk_cuda.GROUP_BLOCK
        assert stats["walked"] > 0 and stats["died"] > 0
        if i == 1:
            assert stats["n_u"] > stats["n_w"] == 64
        if form == "ragged":
            assert stats["w"] % walk_cuda.GROUP_BLOCK
        if form == "padded" and i != 1:
            assert stats["Uw"] - stats["n_w"] > 2 * stats["n_w"], stats


def test_walk_pool_chain_from_worker_threads_on_card(dev, bench):
    """walk_pool_chain on cuda:0 from four worker threads side by side (the
    sharded path's rule): each equals the same call made alone."""
    import concurrent.futures as cf

    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    parts = []
    for i in range(4):
        R, L, qd, rd = sd._upload(list(reads[i * 2048:(i + 1) * 2048]))
        memo = tss.make_chain_memo(1 << 16, 8192, 5, sd.dfi.dtype, dev)
        pool = tss.chain_scan(sd.dfi, qd, rd, 24 * R, memo, W=5)[0]
        parts.append((tss.packed_rev_windows(qd), L, pool, 16 * R))

    def walk(part):
        rw, L, pool, capw = part
        out = tss.walk_pool_chain(sd.dfi, rw, L, pool, capw)
        # the thread's stream, not the device: a device-wide sync while
        # another thread captures a graph invalidates that capture
        torch.cuda.current_stream(dev).synchronize()
        return out

    alone = [walk(p) for p in parts]
    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        side = list(ex.map(walk, parts))
    for a, b in zip(alone, side):
        assert int(a[6]) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The round loops as CUDA graphs (ops/cuda_lib.run_loop, csrc/loop_graph.cuh).

@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_loop_graph_calls_equal_plain_loop_on_card(dev, bench, dtype):
    """Every chain_scan and walk_pool_chain call of the first bench chunk,
    each segment one graph launch (chain_scan with report_rounds on),
    equals the same call run again through the plain loop, output by
    output: pool, cursor, ovf, fq, fc, the memo, rnd and alive_hist;
    death, fk, fl, fs, ovf, calls and ngrp.  On every round of those
    plain runs the round's sort (CUB's, over the key's bits) equals
    torch.sort(stable=True)."""
    from compseed_tpu_torch.ops import chain_cases, walk_cases
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev,
                      dfi=_bench_index(bench, dev, dtype), dedup=True)
    with chain_cases.CallCapture("chain_scan") as cc, \
            chain_cases.CallCapture("walk_pool_chain") as wc:
        sd.run_flat(list(reads[:16384]))
    torch.cuda.synchronize()
    assert len(cc.calls) == 3 and len(wc.calls) >= 2
    for entry, cap, check in (
            ("chain_scan", cc, chain_cases.sort_vs_torch()),
            ("walk_pool_chain", wc, walk_cases.sort_vs_torch())):
        for i, call in enumerate(cap.calls):
            errs = chain_cases.call_vs_plain(entry, call, check)
            assert not any(errs.values()), (entry, i, errs)
        assert len(check.errs) > 2 * len(cap.calls) and \
            not any(check.errs), (entry, check.errs)
    rounds = [int(c[2][6]) for c in cc.calls]
    assert min(rounds) > 3, rounds


def test_loop_graphs_make_no_host_sync_on_card(dev, bench):
    """chain_scan and walk_pool_chain on the first 16,384 bench reads
    under torch.cuda.set_sync_debug_mode("error"): neither waits on the
    card inside the call (each segment's loop test runs there)."""
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    R, L, qd, rd = sd._upload(list(reads[:16384]))
    memo = tss.make_chain_memo(1 << 21, 32 * R, 8, sd.dfi.dtype, dev)
    rw = tss.packed_rev_windows(qd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tss.chain_scan(sd.dfi, qd, rd, 24 * R, memo, W=8,
                             report_rounds=True)
        walk = tss.walk_pool_chain(sd.dfi, rw, L, out[0], 16 * R)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[6]) > 3 and int(out[1]) > 0
    assert int(walk[5]) > 0 and int(walk[6]) > 0


def test_capture_guard_raises_on_allocation_on_card(dev, bench,
                                                    monkeypatch):
    """A torch allocation planted in chain_scan's captured round body
    raises (cuda_lib.NoTorchOps) when the graph is captured (the shape's
    kept graphs dropped first) and leaves no capture open: the same call
    without it then equals the first."""
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    R, L, qd, rd = sd._upload(list(reads[:2048]))
    body = tss._chain_round_kernels

    def scan():
        memo = tss.make_chain_memo(1 << 16, 8192, 8, sd.dfi.dtype, dev)
        out = tss.chain_scan(sd.dfi, qd, rd, 24 * R, memo, W=8)
        torch.cuda.synchronize()
        return out

    def planted(fm_, c, r):
        torch.empty(1, device=r.dev)
        body(fm_, c, r)

    want = scan()
    tss.drop_held()                 # so that the next call captures anew
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round_kernels", planted)
        with pytest.raises(RuntimeError, match="graph capture"):
            scan()
    got = scan()
    for x, y in zip(got[:5], want[:5]):
        assert torch.equal(x, y)


def test_sharded_capture_beside_main_thread_dp_on_card(dev, bench):
    """The sharded seeder at S = 2 on [cuda:0] * 2 seeds 4,096 bench
    reads on a worker thread (its graphs captured there, thread-local)
    while the main thread launches the DP kernel again and again: the
    seeds equal the same run alone and every DP result equals the first,
    which equals the plain version."""
    import concurrent.futures as cf

    import numpy as np

    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.parallel.sharded import ShardedSeeder
    fm, reads = bench
    sd = ShardedSeeder(MemOptions(), fm, mesh=[dev, dev], dedup=True)
    queries = list(reads[:4096])

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [v for y in x for v in flat(y)]
        if isinstance(x, torch.Tensor):
            return [x.cpu().numpy()]
        return [np.asarray(x)]

    alone = flat(sd.run_flat(queries))
    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(14 + 128, P=4096, T=128))
    first = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    n_dp = 0
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(sd.run_flat, queries)
        while not fut.done() or n_dp == 0:
            got = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
            assert torch.equal(got, first)
            n_dp += 1
        side = flat(fut.result())
    torch.cuda.synchronize()
    assert n_dp > 1
    assert len(side) == len(alone) > 2
    for a, b in zip(alone, side):
        assert np.array_equal(a, b)
    q, ql, t, tl, h0, ws = tiles
    want = _extend_core(*GAP.values(), mat, ws[:, 0], q, ql[:, 0], t,
                        tl[:, 0], h0[:, 0])
    assert torch.equal(first[:, :6].cpu(), want.T.cpu())


def test_kept_graphs_serve_later_chunks_on_card(dev, bench, monkeypatch):
    """Three chunks of 4,096 bench reads (the first again last) through
    one seeder on the eager route (the route of the engines that run a
    call eagerly: seeder2.EagerCalls): the first captures every segment's
    graph, the later ones run the kept graphs (no capture) and each
    chunk's seeds equal the same chunk with the rounds patched to the
    plain loop."""
    import numpy as np

    from compseed_tpu_torch.ops import cuda_lib, seeder2
    from compseed_tpu_torch.ops import seedscan as tss
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    chunks = [list(reads[:4096]), list(reads[4096:8192]), list(reads[:4096])]
    monkeypatch.setattr(seeder2, "CALL_GRAPH",
                        dict.fromkeys(seeder2.CALL_GRAPH, False))
    tss.drop_held()
    ends = []
    end = cuda_lib.LoopGraph.end
    # the segments' graphs (the suffix-array loop's is captured every call
    # on this route)
    monkeypatch.setattr(cuda_lib.LoopGraph, "end", lambda self: (
        ends.append(1) if self._p != "fm" else None, end(self)))
    got = []
    for i, q in enumerate(chunks):
        n0 = len(ends)
        got.append(sd.run_flat(q))
        if i == 0:
            assert len(ends) > 6
        else:
            assert len(ends) == n0, i
    with monkeypatch.context() as m:
        m.setattr(tss, "_chain_round", lambda dev_: tss._chain_round_plain)
        m.setattr(tss, "_walk_round", lambda dev_: tss._walk_round_plain)
        want = [sd.run_flat(q) for q in chunks]
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("what", ["chain", "walk"])
def test_folded_loop_segment_equals_plain_loop_on_card(dev, bench, what):
    """Round 1's first segment of the first bench chunk (chain_scan at
    16,384 lanes, walk_pool_chain at 393,216; int32) as one graph
    (seedscan._chain_segment / _walk_segment: the entry kernel, then a
    WHILE node whose rounds end with the apply, whose last block counts
    the round and tests the next) against the plain loop on the same
    state (the plain round while rnd < RCAP and live > the next width):
    every lane, memo and pool word, the counters, the live count, the
    round counter and the histogram equal; the retire count 0 after the
    segment and after the kept graph's second launch on the same state,
    which equals the first; the body graph holds no kernel of its own for
    the loop's test (9 kernel nodes a chain round, 10 a walk round)."""
    from compseed_tpu_torch.ops import (chain_cases, chain_cuda, walk_cases,
                                        walk_cuda)
    from compseed_tpu_torch.ops import seedscan as tss
    i32 = torch.int32
    if what == "chain":
        fm, c, st0, w, Uw = _chain_rounds(bench, dev, "int32")[(1, 16384)]
        clone, mod, nodes_max = chain_cases.clone_state, chain_cuda, 9
        nxtw, rcap = w // 4, 3 * c["L"] + 16
        names = tss.CHAIN_LANE_KEYS + tss.MEMO_KEYS + tss.POOL_KEYS + (
            "fq", "fc", "cursor", "povf", "live")
    else:
        fm, c, st0, Uw = _walk_round1(bench, dev, "int32")
        w = st0["k"].shape[0]
        clone, mod, nodes_max = walk_cases.clone_state, walk_cuda, 10
        nxtw, rcap = w // 4, c["L"] + 2
        names = tss.WALK_LANE_KEYS + ("death", "fk", "fl", "fs", "calls",
                                      "ngrp", "live")
    # the plain loop
    ps, rnd, hist = clone(st0), 0, torch.zeros(rcap, dtype=i32, device=dev)
    while rnd < rcap and int(ps["live"]) > nxtw:
        hist[rnd] = ps["live"]
        ps = tss._chain_round_plain(fm, c, ps, w, Uw) if what == "chain" \
            else tss._walk_round_plain(fm, c, ps, Uw)
        rnd += 1
    assert rnd >= 2                 # the tail let a round run, then stopped
    ks = clone(st0)
    kept = {n: ks[n] for n in names}             # the tensors the graph names
    rnd_d = torch.zeros((), dtype=i32, device=dev)
    hist_d = torch.zeros(rcap, dtype=i32, device=dev)
    loop = dict(rnd=rnd_d, nxtw=nxtw, rcap=rcap)
    rd = None
    for launch in range(2):
        for n, x in kept.items():
            x.copy_(st0[n])
        rnd_d.zero_()
        hist_d.zero_()
        st = dict(ks, live=kept["live"])
        if what == "chain":
            rd = tss._chain_segment(fm, c, st, w, Uw, dict(loop, hist=hist_d),
                                    rd)
        else:
            rd = tss._walk_segment(fm, c, st, Uw, loop, rd)
        torch.cuda.synchronize()
        for n in names:
            got = st["live"] if n == "live" else kept[n]
            assert torch.equal(got.to(torch.int64), ps[n].to(torch.int64)), \
                (launch, n)
        assert int(rnd_d) == rnd, launch
        if what == "chain":
            assert torch.equal(hist_d, hist), launch
        retire = rd.scratch["sc"][mod.SC_RETIRE:mod.SC_RETIRE + 2]
        assert not retire.any(), launch
    assert rd.graph.nodes()["kernels"] <= nodes_max
    rd.close()


# ---------------------------------------------------------------------------
# A seeding call as one CUDA graph (cuda_lib.CallGraph, DeviceSeeder._call).

def _eager_and_graph(sd, queries):
    """One chunk's (head, seed matrix) by the eager _run and by the call
    graph (_call), each copied to the host."""
    R, L, qd, rd = sd._upload(queries)
    fns = sd._build(R, L)
    assert sd._graphed(fns)
    eager = [x.cpu() for x in sd._run(fns, qd, rd)[2:]]
    graph = [x.cpu() for x in sd._call(fns, qd, rd)]
    return eager, graph


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_call_graph_equals_eager_run_on_card(dev, bench, dtype):
    """The default engine's call graph on the first two 16,384-read bench
    chunks (the first captures it, the second replays it) equals the
    eager _run on each, head and seed matrix; one graph is kept; the
    suffix-array stage entry kernel ran."""
    import threading

    from compseed_tpu_torch.ops import fm_cuda
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev,
                      dfi=_bench_index(bench, dev, dtype), dedup=True)
    n0 = dict(fm_cuda.LAUNCHES)
    for c in range(2):
        eager, graph = _eager_and_graph(sd, list(reads[c * 16384:
                                                       (c + 1) * 16384]))
        for e, g in zip(eager, graph):
            assert torch.equal(e, g), c
        assert not eager[0][3:14].any()
    assert len(sd._calls.by_thread[threading.get_ident()]) == 1
    for k in fm_cuda.SA_KERNELS:
        assert fm_cuda.LAUNCHES[k] > n0[k], k


def test_call_graph_two_shapes_alternating_on_card(dev, bench):
    """Chunks of two shapes (4,096 and 16,384 reads) in turn, A B A B:
    each equals the eager _run; each shape captured once, both kept."""
    import threading

    from compseed_tpu_torch.ops import cuda_lib
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    made = []
    init = cuda_lib.CallGraph.__init__

    def counted(self, *a, **kw):
        made.append(1)
        init(self, *a, **kw)
    cuda_lib.CallGraph.__init__ = counted
    try:
        for q in (reads[:4096], reads[4096:20480], reads[8192:12288],
                  reads[:16384]):
            eager, graph = _eager_and_graph(sd, list(q))
            for e, g in zip(eager, graph):
                assert torch.equal(e, g), len(q)
    finally:
        cuda_lib.CallGraph.__init__ = init
    assert len(made) == 2
    assert len(sd._calls.by_thread[threading.get_ident()]) == 2


def test_call_graph_cap_raise_mid_stream_on_card(dev, bench):
    """A seeder whose round-1 pool is too small (GP_F = 18) on two
    chunks: the first overflows (rerun exactly, GP_F doubled, the
    thread's call graphs dropped with the programs), the second runs a
    new graph of the raised caps; both chunks' seeds equal a default
    seeder's."""
    import threading

    import numpy as np

    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    chunks = [list(reads[:16384]), list(reads[16384:32768])]
    ref = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    want = [ref.run_flat(q) for q in chunks]
    sd = DeviceSeeder(MemOptions(), fm, dev, dfi=ref.dfi, dedup=True)
    sd.GP_F = 18
    got = [sd.run_flat(chunks[0])]
    assert sd.last_overflow and sd.GP_F == 36
    assert threading.get_ident() not in sd._calls.by_thread
    got.append(sd.run_flat(chunks[1]))
    assert not sd.last_overflow
    (key, _), = sd._calls.by_thread[threading.get_ident()].items()
    assert key[4][0] == 36
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert np.array_equal(x, y)


def test_call_graph_from_four_threads_beside_dp_on_card(dev, bench):
    """Four worker threads, each with a seeder of its own over one index,
    seed 4,096-read chunks (each captures and replays its own call graph,
    thread-local) while the main thread launches the DP kernel again and
    again: every chunk equals the eager _run of the same reads, and every
    DP result equals the first."""
    import concurrent.futures as cf

    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    base = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    parts = [list(reads[i * 4096:(i + 1) * 4096]) for i in range(4)]

    def work(i):
        sd = DeviceSeeder(MemOptions(), fm, dev, dfi=base.dfi, dedup=True)
        out = []
        for q in (parts[i], parts[(i + 1) % 4]):
            R, L, qd, rd = sd._upload(q)
            fns = sd._build(R, L)
            graph = [x.clone() for x in sd._call(fns, qd, rd)]
            eager = sd._run(fns, qd, rd)[2:]
            out.append(all(torch.equal(a, b) for a, b in zip(graph, eager)))
        return out

    mat = torch.from_numpy(MAT).to(dev)
    tiles = _on(dev, dp_tiles(14 + 128, P=4096, T=128))
    first = bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP)
    n_dp = 0
    with cf.ThreadPoolExecutor(max_workers=4) as ex:
        futs = [ex.submit(work, i) for i in range(4)]
        while not all(f.done() for f in futs) or n_dp == 0:
            assert torch.equal(bsw_cuda.bsw_extend_tiles(mat, *tiles, **GAP),
                               first)
            n_dp += 1
        results = [f.result() for f in futs]
    assert n_dp > 1
    assert all(all(r) for r in results), results


def test_call_graph_keeps_a_chunks_results_after_the_next_on_card(dev,
                                                                  bench):
    """run_flat's results of chunk 1 and its read matrix (last_qd, which
    the engine slices pair sequences from while chunk 2 is seeded) are
    unchanged by chunk 2's replay of the same graph; chunk 2's last_qd is
    a tensor of its own."""
    import numpy as np

    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    sd = DeviceSeeder(MemOptions(), fm, dev, dedup=True)
    c1, c2 = list(reads[:16384]), list(reads[16384:32768])
    out1 = sd.run_flat(c1)
    qd1 = sd.last_qd
    snap = [np.array(x, copy=True) for x in out1], qd1.clone()
    out2 = sd.run_flat(c2)
    torch.cuda.synchronize()
    assert sd.last_qd is not qd1 and torch.equal(qd1, snap[1])
    for x, y in zip(out1, snap[0]):
        assert np.array_equal(x, y)
    assert not np.array_equal(out1[1], out2[1])     # other seeds
    R, L, qd, rd = sd._upload(c1)
    assert torch.equal(qd1, qd)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sharded_call_graph_equals_mesh_heads_on_card(dev, bench, dtype):
    """The sharded seeder at S = 4 on [cuda:0] * 4, each shard's program
    one call graph (the four shards replay one graph in turn, each
    shard's seed matrix copied out before the next): the first 16,384
    bench reads' shard heads and seed matrices equal
    compseed_tpu_torch/mesh_heads.json (the JAX package's ShardedSeeder);
    two chunks capture one graph."""
    import hashlib
    import json
    import os

    import numpy as np

    from compseed_tpu_torch.ops import cuda_lib
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.parallel.sharded import ShardedSeeder
    fm, reads = bench
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "compseed_tpu_torch",
                           "mesh_heads.json")) as f:
        stored = json.load(f)["heads"][dtype]
    sd = ShardedSeeder(MemOptions(), fm, mesh=[dev] * 4,
                       dfi=_bench_index(bench, dev, dtype), dedup=True)
    got = []
    run = sd._run_shards

    def wrapped(*a):
        shards, fns = run(*a)
        if not got:
            got.extend((x[0], x[1].cpu().numpy()) for x in shards)
        return shards, fns
    sd._run_shards = wrapped
    made = []
    init = cuda_lib.CallGraph.__init__

    def counted(self, *a, **kw):
        made.append(1)
        init(self, *a, **kw)
    cuda_lib.CallGraph.__init__ = counted
    try:
        sd.run_flat(list(reads[:16384]))
        sd.run_flat(list(reads[16384:32768]))
    finally:
        cuda_lib.CallGraph.__init__ = init
    assert len(made) == 1
    assert len(got) == 4

    def sha(x):
        return hashlib.sha256(np.ascontiguousarray(
            x, np.int32).tobytes()).hexdigest()
    for s, (head, seedpk) in enumerate(got):
        assert [int(x) for x in head[:28]] == stored[s]["scalars"], s
        assert sha(head) == stored[s]["head_sha256"], s
        assert sha(seedpk) == stored[s]["seedpk_sha256"], s


_BOUNDARIES: dict = {}


def _boundaries(bench, dev, dtype):
    """Every boundary between two segments of the first bench chunk's
    chain_scan and walk_pool_chain calls (entry_cases.BoundaryCapture),
    once per dtype."""
    from compseed_tpu_torch.ops import entry_cases
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    if dtype not in _BOUNDARIES:
        fm, reads = bench
        sd = DeviceSeeder(MemOptions(), fm, dev,
                          dfi=_bench_index(bench, dev, dtype), dedup=True)
        with entry_cases.BoundaryCapture() as cap:
            sd.run_flat(list(reads[:16384]))
        torch.cuda.synchronize()
        _BOUNDARIES[dtype] = list(cap.cases)
    return _BOUNDARIES[dtype]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_segment_entry_on_card(dev, bench, dtype):
    """The segment entry kernels (chain_segment_entry_kernel,
    walk_segment_entry_kernel) on every boundary of the first bench
    chunk, in every form (as captured, no live lane, exactly w live, w +
    37 live at the RCAP cap): equal to the plain version (seedscan.segment_entry_plain) on
    every lane of the new width and the loop words; one launch a call,
    counted."""
    from compseed_tpu_torch.ops import chain_cuda, entry_cases, walk_cuda
    cases = _boundaries(bench, dev, dtype)
    assert {c[0] for c in cases} == {"chain", "walk"}
    for case in cases:
        mod = chain_cuda if case[0] == "chain" else walk_cuda
        kernel, = mod.LOOP_KERNELS
        for form in entry_cases.FORMS:
            n0 = mod.LAUNCHES[kernel]
            r = entry_cases.entry_vs_plain(case, form)
            torch.cuda.synchronize()
            assert r["max_abs_err"] == 0, (case[0], case[4], form, r)
            assert mod.LAUNCHES[kernel] == n0 + 1
            if form == "cap":
                assert (r["kept"], r["go"]) == (case[4], 0)


_SA_BOUNDARIES: dict = {}


def _sa_boundaries(bench, dev, dtype):
    """Every boundary of the first bench chunk's sa_batch_compact call
    and of one call over 40 random positions (a last stage of one lane),
    as the plain version runs them (sa_cases.BoundaryCapture), once per
    dtype."""
    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import sa_cases
    from compseed_tpu_torch.ops.seeder2 import DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    if dtype not in _SA_BOUNDARIES:
        fm, reads = bench
        dfi = _bench_index(bench, dev, dtype)
        sd = DeviceSeeder(MemOptions(), fm, dev, dfi=dfi, dedup=True)
        gen = torch.Generator().manual_seed(40)
        small = torch.randint(0, dfi.seq_len, (40,), generator=gen)
        with sa_cases.BoundaryCapture() as cap:
            sd.run_flat(list(reads[:16384]))
            tfm.sa_batch_compact(dfi, small.to(dfi.dtype).to(dev))
        torch.cuda.synchronize()
        _SA_BOUNDARIES[dtype] = list(cap.cases)
    return _SA_BOUNDARIES[dtype]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_stage_entry_on_card(dev, bench, dtype):
    """sa_stage_entry_kernel on every boundary of the first bench chunk's
    suffix-array walk and of a 40-lane call, in every form (as captured,
    no live lane, cap // 2, cap and cap + 37 live lanes): equal to the
    plain version (fm._sa_boundary_plain) on the outputs, ovf, the next
    stage's alive bytes, slots and live lanes, and go before the last
    stage; one launch a call, counted."""
    from compseed_tpu_torch.ops import fm_cuda, sa_cases
    cases = _sa_boundaries(bench, dev, dtype)
    assert [c[2] for c in cases] == [0, 1, 2, 3] * 2
    for at, case in enumerate(cases):
        for form in sa_cases.forms(case):
            n0 = fm_cuda.LAUNCHES["sa_stage_entry_kernel"]
            r = sa_cases.stage_vs_plain(case, form)
            torch.cuda.synchronize()
            assert r["max_abs_err"] == 0, (at, form, r)
            assert fm_cuda.LAUNCHES["sa_stage_entry_kernel"] == n0 + 1
            if form == "cap + 37 live":
                assert r["ovf"]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_batch_compact_kernels_equal_plain_on_card(dev, bench, dtype):
    """sa_batch_compact by its kernels on the first bench chunk's lanes
    and on the 40-lane call, eagerly (the last stage's loop one graph of
    its own) and inside a CUDA graph capture (the loop joining it),
    equals the plain version: SA values and ovf; four stage entries a
    call, and no loop kernel of its own."""
    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import fm_cuda
    dfi = _bench_index(bench, dev, dtype)
    for case in _sa_boundaries(bench, dev, dtype)[::4]:
        k = case[3]["out_k"][:case[1]].clone()      # the call's positions
        want = tfm._sa_batch_compact_plain(dfi, k)
        n0 = fm_cuda.LAUNCHES["sa_stage_entry_kernel"]
        got = tfm.sa_batch_compact(dfi, k)
        torch.cuda.synchronize()
        assert fm_cuda.LAUNCHES["sa_stage_entry_kernel"] == n0 + 4
        assert torch.equal(got[0], want[0]) and \
            bool(got[1]) == bool(want[1])
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            out = tfm.sa_batch_compact(dfi, k)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and \
            bool(out[1]) == bool(want[1])
    assert set(fm_cuda.LAUNCHES) == {
        "fm_extend_sel_kernel", "fm_chain_walk_kernel",
        "fm_inv_psi_walk_kernel", "sa_stage_entry_kernel"}


_SA_LONG: dict = {}


def _sa_long_rows(bench, dev, dtype):
    """The bench index's 64 longest inverse-Psi walks (sa_cases.long_rows:
    rows and steps), once per dtype."""
    from compseed_tpu_torch.ops import sa_cases
    if dtype not in _SA_LONG:
        _SA_LONG[dtype] = sa_cases.long_rows(
            _bench_index(bench, dev, dtype), 64)
    return _SA_LONG[dtype]


def _in_capture(dev, fn):
    """fn() captured into a CUDA graph on a side stream, then replayed
    once; returns what the capture returned."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_loop_rounds_on_card(dev, bench, dtype):
    """The last stage's loop alone on the card (sa_cases.run_last_loop:
    one graph whose WHILE node the stage entry opens and the walk's last
    block to retire continues or ends each round), eagerly and inside a
    CUDA graph capture (the loop joining it), from the bench index's 64
    longest walks in the stage before the last (sa_cases.last_loop): the
    last stage's kk, steps and alive equal the plain loop's
    (fm._sa_loop_plain) from the same rows, which takes 3 rounds or
    more; go ends 0."""
    from compseed_tpu_torch.ops import fm as tfm
    from compseed_tpu_torch.ops import sa_cases
    dfi = _bench_index(bench, dev, dtype)
    rows, _ = _sa_long_rows(bench, dev, dtype)
    want = tfm._sa_loop_plain(dfi, rows, torch.zeros_like(rows),
                              (rows & (dfi.sa_intv - 1)) != 0)
    assert -(-int(want[1].max()) // (2 * dfi.sa_intv)) >= 3
    for captured in (False, True):
        lp = sa_cases.last_loop(dfi, rows)
        if captured:
            _in_capture(dev, lambda: sa_cases.run_last_loop(lp))
        else:
            sa_cases.run_last_loop(lp)
            lp.close()
            torch.cuda.synchronize()
        for g, w in zip(lp.lanes[3], want):
            assert torch.equal(g, w), captured
        assert int(lp.go) == 0


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_batch_compact_kernels_multi_round_on_card(dev, bench, dtype):
    """sa_batch_compact by its kernels on 4,096 positions, the bench
    index's 64 longest walks first (3 loop rounds or more after the first
    three stages' 7 sa_intv steps), then sampled rows (ovf clear) or
    random rows (ovf set), eagerly and inside a CUDA graph capture: SA
    values and ovf equal the plain version's."""
    from compseed_tpu_torch.ops import fm as tfm
    dfi = _bench_index(bench, dev, dtype)
    rows, steps = _sa_long_rows(bench, dev, dtype)
    i = dfi.sa_intv
    assert -(-(int(steps[0]) - 7 * i) // (2 * i)) >= 3
    gen = torch.Generator().manual_seed(41)
    rand = torch.randint(0, dfi.seq_len, (4096,), generator=gen).to(
        dfi.dtype).to(dev)
    for k in (rand - (rand & (i - 1)), rand):
        k = k.clone()
        k[:64] = rows
        want = tfm._sa_batch_compact_plain(dfi, k)
        got = tfm.sa_batch_compact(dfi, k)
        torch.cuda.synchronize()
        cap = _in_capture(dev, lambda k=k: tfm.sa_batch_compact(dfi, k))
        for out in (got, cap):
            assert torch.equal(out[0], want[0]) and \
                bool(out[1]) == bool(want[1])


# ---------------------------------------------------------------------------
# The exact rerun's per-read programs (csrc/smem_seed.cu): collect_mem and
# the fused round-3 scan, one launch a call.

def _smem_launches():
    from compseed_tpu_torch.ops import smem_cuda
    return dict(smem_cuda.LAUNCHES)


def _golden_rerun_calls(dev, dtype):
    """The calls of the exact rerun of tests/fixtures/reads.fq as one chunk
    on the tiny index (the chunk's caps overflow), the rerun's output and
    the launches of the FM and smem kernels in it."""
    import os

    import numpy as np

    from compseed_tpu_torch.index.fmindex import FMIndex
    from compseed_tpu_torch.io.fastq import read_fastq_chunks
    from compseed_tpu_torch.ops import fm_cuda, smem_cases, smem_cuda
    from compseed_tpu_torch.ops.device_index import to_device
    from compseed_tpu_torch.ops.engine import device_seeder
    from compseed_tpu_torch.options import MemOptions
    from compseed_tpu_torch.pipeline.align import encode_read
    fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    fm = FMIndex.load(os.path.join(fx, "tiny"))
    reads = []
    for chunk in read_fastq_chunks(os.path.join(fx, "reads.fq"), 10**9):
        reads.extend(chunk)
    queries = [encode_read(r.seq) for r in reads]
    dfi = to_device(fm, dev, force_dtype=np.int64 if dtype == "int64"
                    else None)
    sd = device_seeder(MemOptions(), fm, dedup=True, dfi=dfi, device=dev)
    for counts in (fm_cuda.LAUNCHES, smem_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    with smem_cases.Capture() as cap:
        got = sd.run_flat(queries)
    torch.cuda.synchronize(dev)
    assert sd.last_overflow
    return fm, queries, cap, got, dict(fm_cuda.LAUNCHES), _smem_launches()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_smem_kernels_on_golden_rerun_on_card(dev, dtype):
    """A golden's exact rerun on the card: every collect and round-3 call
    by smem_collect_kernel / smem_strategy_kernel, its output poisoned
    first, equals its plain version, one launch a call and no extension
    kernel launched; again with MLEP, MMEM, MMEM3 forced to 2, 1, 1
    (overflows hit)."""
    from compseed_tpu_torch.ops import smem_cases
    _, _, cap, _, fm_n, smem_n = _golden_rerun_calls(dev, dtype)
    assert fm_n["fm_extend_sel_kernel"] == 0, fm_n
    assert smem_n == {"smem_collect_kernel": cap.counts["collect"],
                      "smem_strategy_kernel": cap.counts["strategy"]}
    assert cap.counts["collect"] >= 2 and cap.counts["strategy"] == 1
    for call in cap.calls:
        assert smem_cases.vs_plain(call) == 0, (call.kind, call.lanes)
    ovf = 0
    for call in cap.calls:
        small = dict(call.caps, **{n: v for n, v in (
            ("MLEP", 2), ("MMEM", 1), ("MMEM3", 1)) if n in call.caps})
        forced = smem_cases.Call(call.kind, call.fm, call.L, call.args,
                                 small)
        assert smem_cases.vs_plain(forced) == 0, (call.kind, call.lanes)
        ovf += int(smem_cases.run(forced, "plain")[:, -1].sum())
    assert ovf > 0


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_smem_kernels_on_forced_overflow_chunk_on_card(dev, bench, dtype):
    """The first bench chunk on a seeder whose round-1 pool is too small
    (GP_F = 18, as chip_smoke.py forces it): the chunk reruns; every
    collect and round-3 call of the rerun, its output poisoned first,
    equals its plain version, with the caps as they are and forced to 2,
    1, 1."""
    from compseed_tpu_torch.ops import smem_cases
    from compseed_tpu_torch.ops.engine import device_seeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dfi = _bench_index(bench, dev, dtype)
    sd = device_seeder(MemOptions(), fm, dedup=True, dfi=dfi, device=dev)
    sd.GP_F = 18
    n0 = _fm_launch("fm_extend_sel_kernel")
    with smem_cases.Capture() as cap:
        sd.run_flat(list(reads[:16384]))
    torch.cuda.synchronize()
    assert sd.last_overflow
    assert _fm_launch("fm_extend_sel_kernel") == n0
    for call in cap.calls:
        assert smem_cases.vs_plain(call) == 0, (call.kind, call.lanes)
    for call in cap.calls[:3] + cap.calls[-1:]:
        small = {n: (2 if n == "MLEP" else 1) for n in call.caps}
        forced = smem_cases.Call(call.kind, call.fm, call.L, call.args,
                                 small)
        assert smem_cases.vs_plain(forced) == 0, (call.kind, call.lanes)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_smem_strategy_kernel_shapes_on_card(dev, dtype):
    """smem_strategy_kernel (a pair of threads a lane, blocks of 32 lanes)
    on a golden's round-3 lanes, its output poisoned first, equals the
    plain version: ragged lane counts (1, 31, 33, 32 k + 1, all: a block's
    last pairs idle), long reads padded with N (L = 1,600 over every lane,
    1,504 over 97), and max_intv 0 (no hit: every column past a restart
    extends)."""
    from compseed_tpu_torch.ops import smem_cases
    _, _, cap, _, _, _ = _golden_rerun_calls(dev, dtype)
    call = next(c for c in cap.calls if c.kind == "strategy")
    min_len, max_intv, q, act = call.args
    P, L = q.shape
    forms = [(n, L, max_intv) for n in (1, 31, 33, 32 * (P // 64) + 1, P)]
    forms += [(P, 1600, max_intv), (97, 1504, max_intv), (P, L, 0)]
    for n, width, mi in forms:
        qq = torch.full((n, width), 4, dtype=torch.uint8, device=dev)
        qq[:, :L] = q[:n]
        c = smem_cases.Call("strategy", call.fm, width,
                            (min_len, mi, qq.contiguous(), act[:n].clone()),
                            call.caps)
        assert smem_cases.vs_plain(c) == 0, (n, width, mi)
        torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_smem_collect_kernel_runs_a_call_in_one_wave_on_card(dev, dtype):
    """A collect call of 64 to 16,384 lanes (the reruns' widths) runs in
    one wave: the group the launcher takes for it (a warp a lane where the
    call fits so, else 8 threads a lane) keeps at least that many lanes
    resident (the occupancy query times the SMs), at most 64 registers a
    thread; the 8,192- and 16,384-lane calls among them, 16,384 lanes by
    8 threads a lane, 4,096 and fewer by 32 (at least 8 blocks of 4 lanes
    an SM: 4,224 lanes)."""
    from compseed_tpu_torch.ops import smem_cuda
    for lanes in (64, 1024, 4096, 8192, 16384):
        occ = smem_cuda.occupancy(dtype, dev, lanes)
        assert occ["resident_lanes"] >= lanes, (lanes, occ)
        assert occ["registers"] <= 64, (lanes, occ)
        if lanes != 8192:                  # either group may fit 8,192
            assert occ["threads_per_lane"] == (32 if lanes <= 4096 else 8), \
                (lanes, occ)


def _fm_launch(name):
    from compseed_tpu_torch.ops import fm_cuda
    return fm_cuda.LAUNCHES[name]


def test_smem_wrappers_check_inputs_on_card(dev, bench):
    """The launchers refuse caps outside [1, 32], CPU tensors and wrong
    dtypes, and launch nothing for them."""
    from compseed_tpu_torch.ops import smem_cuda
    dfi = _bench_index(bench, dev, "int32")
    P, L = 64, 32
    q = torch.full((P, L), 4, dtype=torch.uint8, device=dev)
    piv = torch.zeros(P, dtype=torch.int32, device=dev)
    act = torch.ones(P, dtype=torch.bool, device=dev)
    n0 = _smem_launches()
    with pytest.raises(ValueError):
        smem_cuda.collect(dfi, L, q, piv, piv, act, 33, 32)
    with pytest.raises(ValueError):
        smem_cuda.strategy(dfi, L, 19, 20, q, act, 0)
    with pytest.raises(ValueError):
        smem_cuda.collect(dfi, L, q.cpu(), piv, piv, act, 32, 32)
    with pytest.raises(TypeError):
        smem_cuda.collect(dfi, L, q, piv.to(torch.int64), piv, act, 32, 32)
    with pytest.raises(TypeError):
        smem_cuda.strategy(dfi, L, 19, 20, q.to(torch.int32), act, 32)
    assert _smem_launches() == n0
    out = smem_cuda.collect(dfi, L, q, piv, piv.to(torch.int64), act, 32, 32)
    assert out.shape == (P, 32 * 5 + 3) and not out[:, :-2].any()
    assert torch.equal(out[:, -2].cpu(), torch.ones(P, dtype=torch.int32))


def test_smem_kernels_on_a_second_card_first(dev):
    """Skips unless two cards are visible (one H100 runs none of it).  A
    golden's rerun calls on cuda:1 while cuda:0 is current: each kernel
    launches on its tensors' card and equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from compseed_tpu_torch.ops import smem_cases
    d1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        _, _, cap, _, _, _ = _golden_rerun_calls(d1, "int32")
    for call in cap.calls:
        with torch.cuda.device(0):
            got = smem_cases.run(call, "kernel")
        assert got.device == d1
        assert torch.equal(got, smem_cases.run(call, "plain"))


# ---------------------------------------------------------------------------
# The lockstep engines' loops (csrc/lockstep.cu) and sa_batch's loop.

GRAPHED = ("fwd_staged", "fwd_off", "bwd_win", "bwd_whole", "bwd_off",
           "r2_off", "all_off")


def _lockstep_launches():
    from compseed_tpu_torch.ops import lockstep_cuda
    return dict(lockstep_cuda.LAUNCHES)


def _engine_seeder(dev, bench, dtype, name):
    """A seeder of engine ``name`` over the bench index and its programs
    for a 16,384-read chunk (the knobs set while they are built)."""
    import os

    from compseed_tpu_torch.ops.seeder2 import ENGINES, DeviceSeeder
    from compseed_tpu_torch.options import MemOptions
    fm, reads = bench
    dedup, knobs = ENGINES[name]
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        sd = DeviceSeeder(MemOptions(), fm, dev,
                          dfi=_bench_index(bench, dev, dtype), dedup=dedup)
        fns = sd._build(*sd._upload(list(reads[:16384]))[:2])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert fns["engine"] == name
    return sd, fns


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_lockstep_kernels_equal_plain_on_first_bench_chunk(dev, bench,
                                                           dtype):
    """Every lockstep scan and walk-stage call of all_off's and bwd_win's
    first bench chunk (ops/lockstep_cases.Capture, the calls eager) by
    the kernels equals the plain version: lep, cnt, ovf; each stage's
    lanes, t and live; all three kernels launched."""
    from compseed_tpu_torch.ops import lockstep_cases, seeder2
    fm, reads = bench
    n0 = _lockstep_launches()
    kinds = set()
    for name in ("all_off", "bwd_win"):
        sd, fns = _engine_seeder(dev, bench, dtype, name)
        R, L, qd, rd = sd._upload(list(reads[:16384]))
        with seeder2.EagerCalls(), lockstep_cases.Capture() as cap:
            sd._run(fns, qd, rd)
        assert cap.calls
        for call in cap.calls:
            assert lockstep_cases.vs_plain(call) == 0, (name, call.kind,
                                                        call.lanes)
            kinds.add((call.kind, getattr(call, "src", None) is not None))
    assert kinds == {("scan", False), ("walk", False), ("walk", True)}
    n1 = _lockstep_launches()
    assert all(n1[k] > n0[k] for k in ("scan_lanes_kernel",
                                       "walk_stage_kernel",
                                       "walk_stage_entry_kernel")), (n0, n1)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_stage_schedule_on_first_bench_chunk(dev, bench, dtype):
    """walk_stage_kernel's schedule (a thread a lane, a block a tile of
    lanes) on every walk stage of all_off's and bwd_win's first bench
    chunk: each stage's loop equals the plain version on every lane word,
    t and live, and each stage's first segment alone (its loop word 0, so
    t stays) equals the plain version's first segment; the widest stage
    takes more than one wave of the card's resident lanes, the narrowest
    fits in one."""
    import ctypes as ct

    from compseed_tpu_torch.ops import lockstep_cases, lockstep_cuda, seeder2
    from compseed_tpu_torch.ops import seedscan as ss
    one_wave = lockstep_cuda.occupancy(
        "walk_stage_kernel", getattr(torch, dtype), dev)["resident_lanes"]
    fm, reads = bench
    widths = []
    for name in ("all_off", "bwd_win"):
        sd, fns = _engine_seeder(dev, bench, dtype, name)
        R, L, qd, rd = sd._upload(list(reads[:16384]))
        with seeder2.EagerCalls(), lockstep_cases.Capture() as cap:
            sd._run(fns, qd, rd)
        for call in cap.calls:
            if call.kind != "walk":
                continue
            widths.append(call.w)
            assert lockstep_cases.vs_plain(call) == 0, (name, call.w)
            # the first segment alone against the plain version's
            lp = lockstep_cuda.WalkLoop(call.fm, call.L, call.max_steps,
                                        call.qflat, call.rwflat, call.t0,
                                        call.width)
            st = lp.lanes(call.st) if call.src is None else \
                lp.empty_lanes(call.w)
            if call.src is not None:
                lp.live.fill_(call.live_in)
            lp._point(st, call.fit, call.src)
            lockstep_cuda._launch("walk_stage_entry_kernel", lp.dev, lp.args)
            start = {n: x.clone() for n, x in st.items()}
            args = (ct.c_longlong * len(lp.args))(*lp.args)
            args[lp.AT["loop"]] = 0
            lockstep_cuda._launch("walk_stage_kernel", lp.dev, args)
            want, t = ss._walk_stage_plain(
                call.fm, call.qflat, call.L, min(call.max_steps, call.t0 +
                                                 lockstep_cuda.MAX_SEG),
                start, call.t0, 0, call.rwflat)
            assert int(lp.t) == call.t0
            for n in want:
                assert torch.equal(st[n], want[n]), (name, call.w, n)
    assert max(widths) > one_wave > min(widths), (widths, one_wave)


def _walk_calls(dev, bench, dtype):
    """Every walk-stage call of all_off's and bwd_win's first bench chunk
    (ops/lockstep_cases.Capture, the calls eager): [(engine, call)]."""
    from compseed_tpu_torch.ops import lockstep_cases, seeder2
    fm, reads = bench
    out = []
    for name in ("all_off", "bwd_win"):
        sd, fns = _engine_seeder(dev, bench, dtype, name)
        R, L, qd, rd = sd._upload(list(reads[:16384]))
        with seeder2.EagerCalls(), lockstep_cases.Capture() as cap:
            sd._run(fns, qd, rd)
        out += [(name, c) for c in cap.calls if c.kind == "walk"]
    return out


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_stage_entry_on_every_stage_of_first_bench_chunk(dev, bench,
                                                              dtype):
    """walk_stage_entry_kernel as the launcher runs it (a compaction 2
    lanes a thread, a count 8) on every walk stage of all_off's and
    bwd_win's first bench chunk (24,576 to 589,824 lanes; a call's first
    stage counts its lanes, the others compact a wider stage's): the lanes
    (a compaction's poisoned first), the live word, go and the epoch equal
    the plain version's (lockstep_cases.entry_vs_plain), each launch
    counted."""
    from compseed_tpu_torch.ops import lockstep_cases
    calls = _walk_calls(dev, bench, dtype)
    assert {c.src is None for _, c in calls} == {True, False}
    n0 = _lockstep_launches()["walk_stage_entry_kernel"]
    for name, call in calls:
        assert lockstep_cases.entry_vs_plain(call) == 0, \
            (name, call.w, call.src is not None)
    assert _lockstep_launches()["walk_stage_entry_kernel"] == \
        n0 + len(calls)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_stage_entry_at_tile_boundaries_on_card(dev, bench, dtype):
    """walk_stage_entry_kernel on sources of 256 I k +- 1 lanes (I = 2,
    a compaction's lanes a thread, and 8, a count's; k = 1, 3: a tile's
    edge, the ragged last tile) with random lane words, against the plain
    version: compacted into a stage of half the width with more live lanes
    than it holds, with none and with every lane alive, and counted (no
    source)."""
    import dataclasses

    from compseed_tpu_torch.ops import lockstep_cases
    first = next(c for _, c in _walk_calls(dev, bench, dtype)
                 if c.src is not None)
    gen = torch.Generator(device=dev).manual_seed(25)
    for n in sorted({256 * items * k + d for items in (2, 8) for k in (1, 3)
                     for d in (-1, 1)}):
        w = n // 2
        words = {k: torch.randint(-1000, 1000, (n,), generator=gen,
                                  device=dev).to(x.dtype)
                 for k, x in first.src.items() if k != "alive"}
        for p_alive in (0.8, 0.0, 1.0):
            alive = torch.rand(n, generator=gen, device=dev) < p_alive
            src = dict(words, alive=alive)
            live = int(alive.sum())
            compact = dataclasses.replace(
                first, width=n, w=w, st=None, src=src, live_in=live,
                fit=w // 3)
            count = dataclasses.replace(
                first, width=n, w=n, st=src, src=None, live_in=None,
                fit=n // 3)
            for call in (compact, count):
                assert lockstep_cases.entry_vs_plain(call) == 0, \
                    (n, p_alive, call.src is not None)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_walk_stage_entry_epoch_across_a_stage_on_card(dev, bench, dtype):
    """The epoch word across a call's first stage and the next: on all_off's
    first stage, the entry counting its lanes (no ticket, no look-back)
    and a segment, then the next stage's compacting entry (a look-back
    over status words tagged with the epoch), twice over the same words:
    each entry advances the epoch by one, and the lanes, live word and t
    equal the plain version's."""
    import ctypes as ct

    from compseed_tpu_torch.ops import lockstep_cases, lockstep_cuda
    from compseed_tpu_torch.ops import seedscan as ss
    calls = [c for name, c in _walk_calls(dev, bench, dtype)
             if name == "all_off"]
    first = calls[0]
    assert first.src is None
    lp = lockstep_cuda.WalkLoop(first.fm, first.L, first.max_steps,
                                first.qflat, first.rwflat, first.t0,
                                first.width)
    sc = lp.sc.view(torch.int32)
    for rep in range(2):
        st = lp.lanes(first.st)
        lp._point(st, first.fit, None)
        e0 = int(sc[2])
        lockstep_cuda._launch("walk_stage_entry_kernel", lp.dev, lp.args)
        assert int(sc[2]) == e0 + 1 and int(sc[1]) == 0
        assert int(lp.live) == min(int(first.st["alive"].sum()),
                                   first.w)
        args = (ct.c_longlong * len(lp.args))(*lp.args)
        args[lp.AT["loop"]] = 0
        start = {n: x.clone() for n, x in st.items()}
        lockstep_cuda._launch("walk_stage_kernel", lp.dev, args)
        want, _ = ss._walk_stage_plain(
            first.fm, first.qflat, first.L,
            min(first.max_steps, first.t0 + lockstep_cuda.MAX_SEG),
            start, first.t0, 0, first.rwflat)
        for n in want:
            assert torch.equal(st[n], want[n]), (rep, n)
        src = dict(st)
        src.setdefault("steps", torch.zeros_like(st["rid"]))
        w = max(1, int(src["alive"].sum()) // 2)
        nxt = lp.empty_lanes(w)
        lp.live.fill_(int(src["alive"].sum()))
        lp._point(nxt, 0, src)
        lockstep_cuda._launch("walk_stage_entry_kernel", lp.dev, lp.args)
        assert int(sc[2]) == e0 + 2 and int(sc[1]) == 0
        plain = lockstep_cases.walk_entry_plain(src, w)
        for n in plain:
            assert torch.equal(nxt[n], plain[n]), (rep, n)
        assert int(lp.live) == int(plain["alive"].sum())
        lp.t.fill_(first.t0)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_fwd_stage_kernel_equals_plain_on_first_bench_chunk(dev, bench,
                                                            dtype):
    """Every stage of fwd_staged's staged forward walk on the first bench
    chunk (17: round 1's 7, round 2's 3, round 3's 7; ops/lockstep_cases.
    Capture, the calls eager) by fwd_stage_kernel equals the plain
    version, its outputs poisoned first: the state, pf (false past each
    lane's steps), the other records where j < steps; one launch a
    stage."""
    from compseed_tpu_torch.ops import lockstep_cases, seeder2
    fm, reads = bench
    sd, fns = _engine_seeder(dev, bench, dtype, "fwd_staged")
    R, L, qd, rd = sd._upload(list(reads[:16384]))
    # up to the merge: at int64 the overflowed chunk's merged suffix-array
    # lookup never ends (lockstep_cases.run_forward)
    with seeder2.EagerCalls(), lockstep_cases.Capture() as cap:
        lockstep_cases.run_forward(sd, fns, qd, rd)
    calls = [c for c in cap.calls if c.kind == "fwd"]
    assert len(calls) == cap.counts["fwd"] == 17 and not cap.counts["scan"]
    n0 = _lockstep_launches()["fwd_stage_kernel"]
    for i, call in enumerate(calls):
        assert lockstep_cases.vs_plain(call) == 0, (i, call.lanes, call.B)
    assert _lockstep_launches()["fwd_stage_kernel"] == n0 + 17


@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_engine_call_graph_equals_eager_on_card(dev, bench, name):
    """Each engine that takes the call graph since its loops run on the
    card: two 16,384-read bench chunks (the first captures the graph, the
    second replays it) by the graph equal the eager _run, head and seed
    matrix; no chunk-global overflow but fwd_staged's, whose rep caps the
    bench chunks overflow (as the JAX package's heads show:
    compseed_tpu_torch/engine_heads.json)."""
    import threading
    fm, reads = bench
    sd, fns = _engine_seeder(dev, bench, "int32", name)
    assert sd._graphed(fns)
    for c in range(2):
        eager, graph = _eager_and_graph(sd, list(reads[c * 16384:
                                                       (c + 1) * 16384]))
        for e, g in zip(eager, graph):
            assert torch.equal(e, g), (name, c)
        assert bool(eager[0][3:14].any()) == (name == "fwd_staged")
    assert len(sd._calls.by_thread[threading.get_ident()]) == 1
    sd._calls.drop_thread()


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_sa_batch_loop_on_card(dev, bench, dtype):
    """sa_batch on the card by its loop graph (the stage entry runs the
    first test, the walk's last block to retire each next one) equals the
    host-tested loop, on 20,000 positions with the index's 64 longest
    walks (3 rounds or more) and on sampled positions only (no round);
    it reads nothing on the host (no _sa_loop_plain call), eagerly and
    inside a CUDA graph capture."""
    import numpy as np

    from compseed_tpu_torch.ops import fm as tfm
    dfi = _bench_index(bench, dev, dtype)
    rows, steps = _sa_long_rows(bench, dev, dtype)
    assert -(-int(steps.max()) // (2 * dfi.sa_intv)) >= 3
    rng = np.random.default_rng(41)
    k = torch.from_numpy(rng.integers(0, dfi.seq_len, 20000)).to(
        dfi.dtype).to(dev)
    k[:64] = rows
    for lanes in (k, k - (k & (dfi.sa_intv - 1))):
        plain = tfm._sa_loop_plain
        kk, st, _ = plain(dfi, lanes, torch.zeros_like(lanes),
                          (lanes & (dfi.sa_intv - 1)) != 0)
        want = st + tfm._sa_sample(dfi, kk)
        tfm._sa_loop_plain = None            # any call would fail
        try:
            got = tfm.sa_batch(dfi, lanes)
            captured = _in_capture(dev, lambda: tfm.sa_batch(dfi, lanes))
        finally:
            tfm._sa_loop_plain = plain
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(captured, want)


def test_lockstep_wrappers_check_inputs_on_card(dev, bench):
    """The scan's and the forward stage's launchers refuse CPU tensors, a
    capl below 1 and wrong dtypes, and launch nothing for them; a scan of
    all-N reads, its outputs poisoned, pushes nothing and writes cnt and
    ovf 0 and no row (the rows past cnt are unspecified: all of them
    here); a stage of no lanes runs no kernel; a forward stage of dead
    lanes, its outputs poisoned, takes no step and writes pf false
    everywhere (its other records are unspecified past the steps: all of
    them here)."""
    from compseed_tpu_torch.ops import cuda_lib, lockstep_cuda
    dfi = _bench_index(bench, dev, "int32")
    R, L = 64, 32
    q = torch.full((R, L), 4, dtype=torch.uint8, device=dev)
    z = torch.zeros(R, dtype=torch.int32, device=dev)
    act = torch.ones(R, dtype=torch.bool, device=dev)
    n0 = _lockstep_launches()
    with pytest.raises(ValueError):
        lockstep_cuda.scan(dfi, L, 0, True, q, z, z, z + 1, act)
    with pytest.raises(ValueError):
        lockstep_cuda.scan(dfi, L, 4, True, q.cpu(), z, z, z + 1, act)
    with pytest.raises(TypeError):
        lockstep_cuda.scan(dfi, L, 4, True, q, z.to(torch.int64), z, z + 1,
                           act)
    assert _lockstep_launches() == n0
    with cuda_lib.Poisoned():
        lep, cnt, ovf = lockstep_cuda.scan(dfi, L, 4, True, q, z + L, z,
                                           z + 1, act)
    # every base N: no pivot starts, so nothing is pushed or written
    assert not cnt.any() and not ovf.any()
    assert bool((lep == cuda_lib.sentinel(lep.dtype)).all())
    lp = lockstep_cuda.WalkLoop(dfi, L, L + 2, q.reshape(-1), None, 0, 8)
    lp.run(lp.empty_lanes(0), 0)
    assert _lockstep_launches() == dict(
        n0, scan_lanes_kernel=n0["scan_lanes_kernel"] + 1)
    # the forward stage: a CPU tensor or a wrong dtype refused, no lanes
    # no launch; every lane dead: no step, the records zero
    st = dict(k=z.to(dfi.dtype), l=z.to(dfi.dtype), s=z.to(dfi.dtype),
              pos=z + 1, pivot=z, rid=torch.arange(R, dtype=torch.int32,
                                                   device=dev),
              alive=torch.zeros(R, dtype=torch.bool, device=dev))
    nxt = torch.full((R * L,), L, dtype=torch.int32, device=dev)
    args = (dfi, q.reshape(-1), nxt, L, 8)
    mh = z.to(dfi.dtype) + 1
    with pytest.raises(ValueError):
        lockstep_cuda.fwd_stage(*args, {n: x.cpu() for n, x in st.items()},
                                mh.cpu(), True, False)
    with pytest.raises(TypeError):
        lockstep_cuda.fwd_stage(*args, dict(st, pos=st["pos"].long()), mh,
                                True, False)
    n1 = _lockstep_launches()
    out = lockstep_cuda.fwd_stage(*args, {n: x[:0] for n, x in st.items()},
                                  mh[:0], True, False)
    assert out["pf"].shape == (0, 8) and _lockstep_launches() == n1
    with cuda_lib.Poisoned():
        out = lockstep_cuda.fwd_stage(*args, st, mh, True, False)
    assert not out["steps"].any() and not out["pf"].any() and \
        not out["alive"].any()
    assert _lockstep_launches() == dict(
        n1, fwd_stage_kernel=n1["fwd_stage_kernel"] + 1)
