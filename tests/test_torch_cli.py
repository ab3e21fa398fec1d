"""compseed_tpu_torch's command line (``python -m compseed_tpu_torch.cli``)
on the CPU: ``index`` writes the fixture index byte for byte; ``mem
--device cpu`` gives SAM equal to the goldens' records and, line for line
apart from @PG, to the JAX package's ``mem --engine device``; -K chunk
independence, -y 0, --sa-intv and its validation, --mesh, a missing
card, a failing kernel build, the two-process shard run with ``merge``,
``init_distributed``, ``reorder`` and ``shm`` (tolerance 0 everywhere:
the system is integer and bit-exact)."""

import os

import pytest
import torch

from compseed_tpu import cli as jax_cli
from compseed_tpu_torch import cli
from compseed_tpu_torch.parallel import distributed as dist

from tests.conftest import FIXTURES

# the port's CPU programs are many small operations: one intra-op thread
# is as fast, and test workers side by side do not fight over the cores
torch.set_num_threads(1)

IDX = os.path.join(FIXTURES, "tiny")
N = 256               # one full R=256 chunk: the cap-overflow path


def _subset(tmp_path, name, n, lines_per_read):
    out = str(tmp_path / f"sub_{n}_{name}")
    with open(os.path.join(FIXTURES, name)) as f, open(out, "w") as g:
        for _ in range(n * lines_per_read):
            g.write(f.readline())
    return out


def _sam(path):
    """(header lines other than @PG, records)."""
    with open(path) as f:
        lines = f.readlines()
    return ([l for l in lines if l.startswith("@")
             and not l.startswith("@PG")],
            [l for l in lines if not l.startswith("@")])


def _golden(name, n):
    with open(os.path.join(FIXTURES, name)) as f:
        return [l for l in f if not l.startswith("@")][:n]


CPU = ("--device", "cpu")


def _mem(tmp_path, tag, *argv, rc=0, main=cli.main, device=CPU):
    out = str(tmp_path / f"{tag}.sam")
    got = main(["mem", *device, "-v", "1", "-o", out, *argv])
    assert got == rc, (tag, got)
    return out


def test_index_writes_fixture_bytes(tmp_path, capsys):
    prefix = str(tmp_path / "idx")
    assert cli.main(["index", "-p", prefix,
                     os.path.join(FIXTURES, "tiny.fa")]) == 0
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        with open(prefix + ext, "rb") as f, open(IDX + ext, "rb") as g:
            assert f.read() == g.read(), ext
    assert "[index] built" in capsys.readouterr().err


@pytest.mark.parametrize("name,per,gold", [
    ("reads.fq", 4, "golden_bwamem.sam"),
    ("reads.reordered", 1, "golden_compseed_reordered.sam")])
def test_mem_vs_golden_and_jax_cli(tmp_path, name, per, gold):
    """256 reads as one chunk (the seeder's caps overflow and the chunk
    is rerun exactly): records equal to the golden's, every line but
    @PG equal to the JAX CLI's device engine; and the same records
    whatever -K cuts the input into."""
    reads = _subset(tmp_path, name, N, per)
    hdr, recs = _sam(_mem(tmp_path, "port", IDX, reads))
    assert recs == _golden(gold, N)
    jhdr, jrecs = _sam(_mem(tmp_path, "jax", IDX, reads, main=jax_cli.main,
                            device=("--engine", "device")))
    assert hdr == jhdr and hdr
    assert recs == jrecs
    with open(str(tmp_path / "port.sam")) as f:
        pg = [l for l in f if l.startswith("@PG")]
    assert len(pg) == 1 and pg[0].startswith(
        "@PG\tID:compseed-tpu\tPN:compseed-tpu\tVN:0.1.0\tCL:compseed-tpu "
        "mem --device cpu")
    # -K: 60 reads a chunk (5 chunks) against the one chunk above
    assert _sam(_mem(tmp_path, "k", "-K", str(60 * 101), IDX, reads))[1] \
        == recs


def test_mem_y0_vs_jax_device_path(tmp_path):
    """-y 0 (max_mem_intv = 0): the lockstep round 3 in the seeder."""
    reads = _subset(tmp_path, "reads.reordered", 96, 1)
    port = _sam(_mem(tmp_path, "port", "-y", "0", IDX, reads))
    jx = _sam(_mem(tmp_path, "jax", "-y", "0", IDX, reads,
                   main=jax_cli.main, device=("--engine", "device")))
    assert port == jx and len(port[1]) == 96
    oracle = _sam(_mem(tmp_path, "oracle", "-y", "0", "--engine", "oracle",
                       IDX, reads, device=()))
    assert port == oracle


def test_mem_oracle_engine_and_python_tail(tmp_path):
    """--engine oracle (the scalar host path) needs no device, and
    equals the device engine on the CPU; so does --tail python."""
    reads = _subset(tmp_path, "reads.fq", 24, 4)
    dev = _sam(_mem(tmp_path, "dev", IDX, reads))
    assert dev[1] == _golden("golden_bwamem.sam", 24)
    assert _sam(_mem(tmp_path, "oracle", "--engine", "oracle", IDX, reads,
                     device=())) == dev
    assert _sam(_mem(tmp_path, "py", "--engine", "oracle", "--tail",
                     "python", IDX, reads, device=())) == dev


def test_sa_intv_densifies_and_validates(tmp_path, capsys):
    reads = _subset(tmp_path, "reads.fq", 48, 4)
    base = _sam(_mem(tmp_path, "base", IDX, reads))
    capsys.readouterr()
    out = _mem(tmp_path, "sa8", "--sa-intv", "8", "-v", "3", IDX, reads)
    assert _sam(out) == base
    assert "densified the suffix-array sample from interval 32 to 8" in \
        capsys.readouterr().err
    # neither is a power of two; the message names both intervals
    for bad in ("12", "24"):
        out = _mem(tmp_path, "bad" + bad, "--sa-intv", bad, IDX, reads, rc=1)
        err = capsys.readouterr().err
        assert f"--sa-intv {bad}" in err and "32" in err and "[E::mem]" in err
        assert not os.path.exists(out)               # nothing was written
    # 64 >= 32: ignored, with a warning
    for big in ("64", "32"):
        out = _mem(tmp_path, "big" + big, "--sa-intv", big, IDX, reads)
        err = capsys.readouterr().err
        assert f"--sa-intv {big} is ignored" in err and "32" in err
        assert _sam(out) == base
    # the flag belongs to the device engine
    out = _mem(tmp_path, "orc", "--sa-intv", "8", "--engine", "oracle", IDX,
               reads, device=())
    err = capsys.readouterr().err
    assert "--sa-intv 8 is ignored" in err and "--engine oracle" in err
    assert _sam(out) == base


def test_mesh_raises(tmp_path):
    reads = _subset(tmp_path, "reads.fq", 4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.*multi-GPU"):
        _mem(tmp_path, "mesh", "--mesh", "2", IDX, reads)
    assert not os.path.exists(str(tmp_path / "mesh.sam"))


def test_mem_defaults_to_the_card_and_fails_without_one(tmp_path, capsys,
                                                         monkeypatch):
    """No --device: cuda.  Without a card mem returns non-zero, names
    the reason and writes no record; it never carries on with the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = _subset(tmp_path, "reads.fq", 4, 4)
    for device in ((), ("--device", "cuda:0")):
        out = _mem(tmp_path, "nocard", IDX, reads, rc=1, device=device)
        assert "no CUDA device" in capsys.readouterr().err
        assert not os.path.exists(out)


def test_mem_ends_on_a_kernel_that_does_not_build(tmp_path, capsys,
                                                   monkeypatch):
    """A failure while the engines are built (nvcc, the launch
    self-check) ends the run with its message and exit code 1."""
    from compseed_tpu_torch.ops import engine

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed (nvcc -arch=sm_90a ...): boom")

    monkeypatch.setattr(engine, "device_engine", broken)
    reads = _subset(tmp_path, "reads.fq", 4, 4)
    out = _mem(tmp_path, "nobuild", IDX, reads, rc=1)
    assert "nvcc failed" in capsys.readouterr().err
    assert _sam(out)[1] == []


@pytest.mark.parametrize("flag,want", [((), "cuda:0"),
                                       (("--device", "cuda"), "cuda:0"),
                                       (("--device", "cuda:1"), "cuda:1"),
                                       (("--device", "cpu"), "cpu")])
def test_mem_hands_the_engines_an_indexed_device(tmp_path, monkeypatch, flag,
                                                 want):
    """``cuda`` means ``cuda:0``: tensors report their device with its
    index, and the seeder holds the index's device to its own."""
    import torch
    from compseed_tpu_torch.ops import engine
    seen = []

    def capture(*a, device, **kw):
        seen.append(device)
        raise RuntimeError("stop here")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(engine, "device_seeder", capture)
    reads = _subset(tmp_path, "reads.fq", 4, 4)
    _mem(tmp_path, "dev", IDX, reads, rc=1, device=flag)
    assert seen == [torch.device(want)]
    assert (seen[0].index is not None) == (want != "cpu")


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_two_process_shard_merge(tmp_path, capsys):
    """Two simulated processes split the -K chunk stream round-robin;
    ``merge`` restores the single-process SAM byte for byte apart from
    @PG (mirrors tests/test_distributed.py)."""
    reads = _subset(tmp_path, "reads.fq", 200, 4)
    single = str(tmp_path / "single.sam")
    argv = ["mem", "--device", "cpu", "-v", "1", "-K", "5050", IDX, reads,
            "-o"]
    assert _with_env({"COMPSEED_NPROCS": ""},
                     lambda: cli.main(argv + [single])) == 0
    merged = str(tmp_path / "dist.sam")
    for pid in ("0", "1"):
        assert _with_env({"COMPSEED_NPROCS": "2", "COMPSEED_PROC_ID": pid},
                         lambda: cli.main(argv + [merged])) == 0
    shards = sorted(p for p in os.listdir(tmp_path)
                    if p.startswith("dist.sam.shard"))
    assert len(shards) == 4 and not os.path.exists(merged)
    assert os.path.exists(merged + ".header")
    assert cli.main(["merge", merged]) == 0
    assert "[merge] 4 shards" in capsys.readouterr().err
    with open(single) as f, open(merged) as g:
        a = [l for l in f if not l.startswith("@PG")]
        b = [l for l in g if not l.startswith("@PG")]
    assert a == b and len(a) > 200
    assert not os.path.exists(merged + ".header")
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]
    # distributed mode needs -o
    assert _with_env({"COMPSEED_NPROCS": "2", "COMPSEED_PROC_ID": "0"},
                     lambda: cli.main(argv[:-1])) == 1


def test_chunk_ownership_and_shard_names():
    assert [dist.owns_chunk(c, 1, 3) for c in range(6)] == \
        [False, True, False, False, True, False]
    assert dist.owns_chunk(5, 0, 0)
    assert dist.shard_path("out.sam", 12) == "out.sam.shard000012"


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda:0", "nccl")])
def test_init_distributed_calls_torch_distributed(monkeypatch, device,
                                                  backend):
    import torch.distributed
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for k in ("COMPSEED_COORD", "COMPSEED_NPROCS", "COMPSEED_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    # one process: nothing to initialise
    assert dist.init_distributed(device=device) == (0, 1)
    assert dist.init_distributed("h:1", 1, 0, device=device) == (0, 1)
    # several processes without a coordinator: partitioning only
    assert dist.init_distributed(None, 4, 2, device=device) == (2, 4)
    assert calls == []
    # with a coordinator, by arguments and by environment
    assert dist.init_distributed("localhost:29511", 4, 3,
                                 device=device) == (3, 4)
    monkeypatch.setenv("COMPSEED_COORD", "10.0.0.1:1234")
    monkeypatch.setenv("COMPSEED_NPROCS", "2")
    monkeypatch.setenv("COMPSEED_PROC_ID", "1")
    assert dist.init_distributed(device=device) == (1, 2)
    assert calls == [
        ((backend,), dict(init_method="tcp://localhost:29511", world_size=4,
                          rank=3)),
        ((backend,), dict(init_method="tcp://10.0.0.1:1234", world_size=2,
                          rank=1))]


def test_reorder_then_mem(tmp_path, capsys):
    """``reorder`` writes a permutation of its input that ``mem`` takes
    as FASTQ, equal to the JAX CLI's output for the same file."""
    reads = _subset(tmp_path, "reads.fq", 120, 4)
    out, jout = str(tmp_path / "re.fq"), str(tmp_path / "jre.fq")
    assert cli.main(["reorder", reads, "-o", out, "-k", "15"]) == 0
    assert "[reorder] 120 reads" in capsys.readouterr().err
    assert jax_cli.main(["reorder", reads, "-o", jout, "-k", "15"]) == 0
    with open(out) as f, open(jout) as g, open(reads) as h:
        mine, theirs, src = f.read(), g.read(), h.read()
    assert mine == theirs and mine != src

    def recs(text):
        ls = text.splitlines()
        return sorted(tuple(ls[i:i + 4]) for i in range(0, len(ls), 4))
    assert recs(mine) == recs(src)
    sam = _sam(_mem(tmp_path, "re", IDX, out))[1]
    want = {l.split("\t", 1)[0]: l
            for l in _golden("golden_bwamem.sam", 120)}
    assert len(sam) == 120
    # mapq tie-breaks hash the read's position in the stream, so compare
    # what does not depend on the order
    for l in sam:
        f, g = l.split("\t"), want[l.split("\t", 1)[0]].split("\t")
        assert f[9] == g[9] and f[2] == g[2]


def test_shm_stage_list_mem_drop(tmp_path, capsys, monkeypatch):
    from compseed_tpu_torch.index import shm
    monkeypatch.setattr(shm, "SHM_ROOT", str(tmp_path / "shm"))
    assert cli.main(["shm", "-l"]) == 0
    assert capsys.readouterr().out == ""
    assert cli.main(["shm", IDX]) == 0
    assert cli.main(["shm", "-l"]) == 0
    assert capsys.readouterr().out == "tiny\n"
    # mem attaches the staged copy; --sa-intv reads its interval from it
    reads = _subset(tmp_path, "reads.fq", 16, 4)
    out = _mem(tmp_path, "shm", "-v", "3", "--sa-intv", "12",
               str(tmp_path / "elsewhere" / "tiny"), reads, rc=1)
    assert "interval 32" in capsys.readouterr().err
    out = _mem(tmp_path, "shm", "-v", "3",
               str(tmp_path / "elsewhere" / "tiny"), reads)
    assert "attaching shm-staged index 'tiny'" in capsys.readouterr().err
    assert _sam(out)[1] == _golden("golden_bwamem.sam", 16)
    assert cli.main(["shm", "-d", IDX]) == 0
    assert cli.main(["shm", "-l"]) == 0
    assert capsys.readouterr().out == ""


def test_main_usage_and_unknown_command(capsys):
    assert cli.main([]) == 1
    assert "usage: compseed-tpu {index,mem,reorder,shm,merge}" in \
        capsys.readouterr().err
    assert cli.main(["frobnicate"]) == 1
    assert "unknown command" in capsys.readouterr().err
