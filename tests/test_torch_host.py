"""The port's own host layers: each copied module equals the JAX
package's file once the package name is mapped back (apart from an
allow-list, written out here with a reason per entry); the port's index
build writes the fixture index byte for byte; the port's benchmark
input equals bench.py's byte for byte at a reduced size; and the port's
native tail is its own build of the shared C++ sources."""

import os
import re

import numpy as np
import pytest

import bench
from compseed_tpu_torch import bench_input, convert
from compseed_tpu_torch import native as port_native
from compseed_tpu_torch.index import build_index
from compseed_tpu_torch.index.fmindex import FMIndex, unpack_pac_range
from compseed_tpu_torch.index.io import save_index
from compseed_tpu_torch.options import MemOptions

from tests.conftest import FIXTURES

ROOT = os.path.dirname(os.path.dirname(FIXTURES))

COPIED = [
    "utils.py", "options.py",
    "index/__init__.py", "index/suffix.py", "index/build.py",
    "index/fmindex.py", "index/io.py", "index/shm.py",
    "io/__init__.py", "io/kopen.py", "io/fastq.py", "io/reorder.py",
    "io/sam.py",
    "cpu/__init__.py", "cpu/fm_oracle.py", "cpu/ksw.py", "cpu/sort.py",
    "pipeline/__init__.py", "pipeline/types.py", "pipeline/seeding.py",
    "pipeline/chain.py", "pipeline/cigar.py", "pipeline/extension.py",
    "pipeline/finalize.py", "pipeline/align.py",
    "native/__init__.py",
    "api.py", "parallel/__init__.py", "parallel/distributed.py", "cli.py",
]

# file -> [(text in the JAX package's file, text in the port's, reason)]
ALLOWED = {
    "index/shm.py": [
        ("TPU-host equivalent:", "Accelerator-host equivalent:",
         "the port's device is a GPU")],
    "index/build.py": [
        ("from compseed_tpu.index.suffix import suffix_array\n", "",
         "the numpy build is no longer a fallback here"),
        ("    # native SA-IS when available (linear time, 64-bit \u2014 "
         "whole-genome\n"
         "    # scale); the numpy prefix-doubling build" "er is the "
         "pure-python\n"
         "    # fallback and the differential oracle\n"
         "    try:\n"
         "        from compseed_tpu.native import suffix_array_native\n"
         "        sa_full = suffix_array_native(both)\n"
         "    except Exception:\n"
         "        sa_full = suffix_array(both)\n",
         "    # native SA-IS (linear time, 64-bit \u2014 whole-genome scale); "
         "a failed\n"
         "    # g++ build of the native library raises here.  The numpy\n"
         "    # prefix-doubling build (index.suffix) is the differential "
         "oracle\n"
         "    from compseed_tpu.native import suffix_array_native\n"
         "    sa_full = suffix_array_native(both)\n",
         "a failed g++ build of the port's native library is loud, not "
         "swallowed into the numpy build"),
    ],
    "pipeline/align.py": [
        ('"""End-to-end batch alignment driv' 'er.',
         '"""End-to-end batch alignment.', "wording"),
        ("seeding/SAL/extension on TPU (compseed_tpu.ops), host tail.",
         "seeding/SAL/extension on the card (compseed_tpu.ops), host tail.",
         "the port's device is a GPU"),
        ("    # --- seeding + merged SAL (comp_seed.cpp:2262-2347)\n",
         "    # the engine's device read matrix belongs to the flat path "
         "above: one\n"
         "    # left by an earlier chunk must not serve these reads\n"
         "    if hasattr(engine, \"set_query_context\"):\n"
         "        engine.set_query_context(None)\n\n"
         "    # --- seeding + merged SAL (comp_seed.cpp:2262-2347)\n",
         "an engine that served a device-seeded chunk and is then given "
         "reads without the device seeder would slice them from the old "
         "chunk's read matrix")],
    "pipeline/extension.py": [
        ("exactly what the TPU DP kernel wants.",
         "exactly what the device DP kernel wants.",
         "the port's device is a GPU")],
    "native/__init__.py": [
        ("The library is built on demand with g++ and cached under build/."
         "  It owns\n",
         "The library is built on demand with g++ from the C++ sources at "
         "the\nrepository root and cached under build/compseed_tpu/.  It "
         "owns\n",
         "docstring names the port's own build directory"),
        ("rounds in the middle run on the TPU through",
         "rounds in the middle run on the card through",
         "the port's device is a GPU"),
        ('_BUILD = os.path.join(_ROOT, "build")\n',
         '_BUILD = os.path.join(_ROOT, "build", "compseed_tpu")\n',
         "the port builds its own library, never the JAX package's"),
        ("        subprocess.run(cmd, check=True, capture_output=True)\n",
         "        r = subprocess.run(cmd, capture_output=True, text=True)\n"
         "        if r.returncode != 0:\n"
         "            raise RuntimeError(f\"g++ failed ({' '.join(cmd)}):\\n\""
         "\n"
         "                               f\"{r.stdout}{r.stderr}\")\n",
         "a failed build shows the compiler's output"),
        ("    # exact bug behind the round-2 TPU SAM corruption, where the "
         "Pallas\n    # engine returned res[:, j] views while the XLA path "
         "returned copies\n",
         "    # bug behind a SAM corruption seen when a DP engine returned\n"
         "    # res[:, j] views instead of copies\n",
         "history of another device"),
    ],
    "api.py": [
        ("does not need batching or a driv" "er.",
         "does not need batching or a driving loop.", "wording")],
    "parallel/distributed.py": [
        ('"""Multi-host distribution: jax.distributed + deterministic shard merge.\n',
         '"""Multi-host distribution: torch.distributed + deterministic shard merge.\n',
         "torch.distributed in place of jax.distributed"),
        ('cstl/kthread.c:95-105).  The multi-host TPU equivalent implemented here:\n',
         'cstl/kthread.c:95-105).  The multi-host equivalent implemented here:\n',
         "the port's device is a GPU"),
        ('  * ``init_distributed`` — bring up ``jax.distributed`` from the standard\n'
         '    coordinator env vars so every host sees the global device set.\n',
         '  * ``init_distributed`` — bring up ``torch.distributed`` from the\n'
         '    coordinator env vars so every host joins one process group.\n',
         "torch.distributed in place of jax.distributed"),
        ('tests/test_distributed.py with n_hosts simulated process-locally.\n',
         'tests/test_torch_cli.py with n_hosts simulated process-locally.\n',
         "the port's own test file"),
        ('                     process_id: int | None = None) -> tuple[int, int]:\n'
         '    """Initialize jax.distributed when a multi-host launch is configured\n'
         '    (env: COMPSEED_COORD, COMPSEED_NPROCS, COMPSEED_PROC_ID — or the\n'
         '    standard JAX coordinator variables).  Returns (process_id, n)."""\n'
         '    import jax\n'
         '\n',
         '                     process_id: int | None = None, *,\n'
         '                     device) -> tuple[int, int]:\n'
         '    """Initialize torch.distributed when a multi-host launch is configured\n'
         '    (env: COMPSEED_COORD, COMPSEED_NPROCS, COMPSEED_PROC_ID): the\n'
         "    coordinator's host:port is the group's TCP address, the backend is\n"
         '    nccl for a CUDA ``device`` and gloo for the CPU.  Returns\n'
         '    (process_id, n)."""\n',
         "init_distributed takes the device, which picks the backend"),
        ('        jax.distributed.initialize(coordinator_address=coordinator,\n'
         '                                   num_processes=num_processes,\n'
         '                                   process_id=process_id)\n',
         '        import torch\n'
         '        import torch.distributed\n'
         '\n'
         '        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"\n'
         '        torch.distributed.init_process_group(\n'
         '            backend, init_method=f"tcp://{coordinator}",\n'
         '            world_size=num_processes, rank=process_id)\n',
         "torch.distributed.init_process_group in place of jax.distributed.initialize"),
        ('    # the chunk stream; no cross-process jax collectives are needed)\n',
         '    # the chunk stream; no cross-process collectives are needed)\n',
         "no JAX in the port"),
    ],
    "cli.py": [
        ("    one 64-bit SA-IS build" "er (csrc/sais.cpp), which produces the\n",
         "    one 64-bit SA-IS build (csrc/sais.cpp), which produces the\n",
         "wording"),
        ('                         "the 64-bit SA-IS build' 'er (same output '
         'bytes)")\n',
         '                         "the 64-bit SA-IS build (same output '
         'bytes)")\n', "wording"),
        ('        print(f"[index] -a {args.algo}: the 64-bit SA-IS build' 'er '
         'covers "\n',
         '        print(f"[index] -a {args.algo}: the 64-bit SA-IS build '
         'covers "\n', "wording"),
        ('                          BWA-MEM flag surface.\n',
         '                          BWA-MEM flag surface.\n'
         '\n'
         '``mem`` runs on ``--device cuda`` with ``--engine device`` unless told\n'
         'otherwise: seeding, SAL and the banded-SW extension on the card, the\n'
         'native tail on the host.  ``--device cpu`` runs the same device programs\n'
         'on the CPU, ``--engine oracle`` the scalar host path.  A card that is\n'
         'missing or a kernel that does not build or launch ends the run with an\n'
         'error; nothing carries on with another device or engine.\n',
         "docstring: the port's defaults"),
        ('    return a, b\n'
         '\n'
         '\n',
         '    return a, b\n'
         '\n'
         '\n'
         'def _check_sa_intv(args, shm_name: str) -> int:\n'
         '    """Validate --sa-intv against the interval of the index that ``mem``\n'
         "    is about to load, read from the staged copy's metadata or the .sa\n"
         '    header alone.  Returns the interval to densify to, 0 when the flag is\n'
         '    absent or ignored (with a warning), -1 after printing an error."""\n'
         '    new = args.sa_intv\n'
         '    if not new:\n'
         '        return 0\n'
         '    from compseed_tpu.index import shm as shm_mod\n'
         '    if shm_mod.shm_available(shm_name):\n'
         '        old = int(shm_mod.shm_load(shm_name).sa_intv)    # memory maps only\n'
         '    else:\n'
         '        import numpy as _np\n'
         '        with open(args.index_prefix + ".sa", "rb") as f:\n'
         '            old = int(_np.frombuffer(f.read(56), dtype="<u8")[5])\n'
         '    if new < 0 or new & (new - 1) or (new < old and old % new):\n'
         '        print(f"[E::mem] --sa-intv {new}: must be a power of two that "\n'
         '              f"divides the index\'s suffix-array interval {old}",\n'
         '              file=sys.stderr)\n'
         '        return -1\n'
         '    if new >= old:\n'
         '        print(f"[W::mem] --sa-intv {new} is ignored: it is not smaller "\n'
         '              f"than the index\'s suffix-array interval {old}",\n'
         '              file=sys.stderr)\n'
         '        return 0\n'
         '    if args.engine != "device":\n'
         '        print(f"[W::mem] --sa-intv {new} is ignored: it applies to "\n'
         '              f"--engine device, not --engine {args.engine}",\n'
         '              file=sys.stderr)\n'
         '        return 0\n'
         '    return new\n'
         '\n'
         '\n',
         "--sa-intv is validated before the index is loaded: a bad value ends the run with exit code 1 and both values, an ignored one warns"),
        ('                    default="oracle")\n',
         '                    default="device")\n'
         '    ap.add_argument("--device", default="cuda",\n'
         '                    help="torch device of the device engine: cuda "\n'
         '                         "(= cuda:0), cuda:N or cpu")\n',
         "an entry point of the port runs on the card unless the caller asks for the CPU: --engine device and the new --device flag"),
        ('                         "intv 32): HBM traded for SAL walk depth; "\n',
         '                         "intv 32): device memory traded for SAL walk "\n'
         '                         "depth; "\n',
         "the port's device is a GPU"),
        ('    shm_name = os.path.basename(args.index_prefix)\n',
         '    shm_name = os.path.basename(args.index_prefix)\n'
         '    sa_intv = _check_sa_intv(args, shm_name)\n'
         '    if sa_intv < 0:\n'
         '        return 1\n',
         "--sa-intv validation, before anything is loaded"),
        ('            a.is_alt = 0\n',
         '            a.is_alt = 0\n'
         '\n'
         '    dev = None\n'
         '    if args.engine == "device":\n'
         '        import torch\n'
         '        dev = torch.device(args.device)\n'
         '        if dev.type == "cuda" and dev.index is None:\n'
         '            dev = torch.device("cuda", 0)    # tensors report cuda:0\n'
         '        if dev.type == "cuda" and not torch.cuda.is_available():\n'
         '            print(f"[E::mem] --device {args.device}: no CUDA device is "\n'
         '                  "available (pass --device cpu or --engine oracle to run "\n'
         '                  "without one)", file=sys.stderr)\n'
         '            return 1\n'
         '        if args.mesh > 0 and dev.type == "cuda" and \\\n'
         '                dev.index + args.mesh > torch.cuda.device_count():\n'
         '            # never a smaller mesh than asked for\n'
         '            print(f"[E::mem] --mesh {args.mesh}: needs {args.mesh} CUDA "\n'
         '                  f"devices from {dev}, {torch.cuda.device_count()} are "\n'
         '                  "visible", file=sys.stderr)\n'
         '            return 1\n',
         "an explicit torch device; no card ends the run, nothing carries on with the CPU; "
         "--mesh N on a card needs N cards from --device on (the JAX package's "
         "jax.devices()[:N] would shrink the mesh without a word), else exit code 1"),
        ('        dfi = None\n'
         '        if args.sa_intv and args.sa_intv < fm.sa_intv:\n'
         '            import numpy as _np\n'
         '            from compseed_tpu.ops.device_index import densify_sa, to_device\n'
         '            dfi = densify_sa(to_device(fm), args.sa_intv)\n'
         '            # keep the host views in agreement (oracle fallback / SAL)\n'
         '            fm.sa_intv = args.sa_intv\n'
         '            fm.sa_sampled = _np.asarray(dfi.sa_sampled).astype(_np.uint64)\n'
         '        if args.mesh > 0:\n'
         "            # multi-chip: the production pipeline shard_map'd over a\n"
         '            # data mesh (parallel/sharded.py)\n'
         '            import jax\n'
         '            import numpy as _np\n'
         '            from compseed_tpu.parallel.mesh import make_mesh\n'
         '            from compseed_tpu.parallel.sharded import (ShardedBswRunner,\n'
         '                                                       ShardedSeeder)\n'
         '            mesh = make_mesh(jax.devices()[:args.mesh])\n'
         '            seeder = ShardedSeeder(opt, fm, mesh=mesh, dedup=True,\n'
         '                                   dfi=dfi)\n'
         '            engine = ShardedBswRunner(opt, _np.array(opt.mat), mesh=mesh,\n'
         '                                      dfi=seeder.dfi)\n'
         '        else:\n'
         '            from compseed_tpu.ops.engine import device_engine, device_seeder\n'
         '            # compressive dedup on for every input mode (the reference\n'
         '            # builds its SSTs unconditionally); the adaptive cap\n'
         '            # fallback protects low-sharing FASTQ input\n'
         '            seeder = device_seeder(opt, fm, dedup=True, dfi=dfi)\n'
         '            engine = device_engine(opt, fm,\n'
         '                                   dfi=getattr(seeder, "dfi", None))\n',
         '        from compseed_tpu.ops.engine import (device_engine,\n'
         '                                                   device_seeder)\n'
         '        try:\n'
         '            dfi = None\n'
         '            if sa_intv:\n'
         '                import numpy as _np\n'
         '                from compseed_tpu.ops.device_index import (densify_sa,\n'
         '                                                                 to_device)\n'
         '                t_d = time.time()\n'
         '                dfi = densify_sa(to_device(fm, dev), sa_intv)\n'
         '                # keep the host views in agreement (oracle fallback / SAL)\n'
         '                fm.sa_sampled = \\\n'
         '                    dfi.sa_sampled.cpu().numpy().astype(_np.uint64)\n'
         '                if args.verbose >= 3:\n'
         '                    print(f"[mem] densified the suffix-array sample from "\n'
         '                          f"interval {fm.sa_intv} to {sa_intv} in "\n'
         '                          f"{time.time() - t_d:.2f}s", file=sys.stderr)\n'
         '                fm.sa_intv = sa_intv\n'
         '            if args.mesh > 0:\n'
         '                # multi-device: the production pipeline sharded over a\n'
         '                # list of devices (parallel/sharded.py): cards from\n'
         '                # --device on, or N shards on the CPU\n'
         '                import numpy as _np\n'
         '                from compseed_tpu.parallel.sharded import (\n'
         '                    ShardedBswRunner, ShardedSeeder)\n'
         '                mesh = [torch.device(dev.type, dev.index + i)\n'
         '                        if dev.type == "cuda" else dev\n'
         '                        for i in range(args.mesh)]\n'
         '                seeder = ShardedSeeder(opt, fm, mesh=mesh, dedup=True,\n'
         '                                       dfi=dfi)\n'
         '                engine = ShardedBswRunner(opt, _np.array(opt.mat),\n'
         '                                          mesh=mesh, dfi=seeder.dfi)\n'
         '            else:\n'
         '                # compressive dedup on for every input mode (the reference\n'
         '                # builds its SSTs unconditionally); the adaptive cap\n'
         '                # fallback protects low-sharing FASTQ input\n'
         '                seeder = device_seeder(opt, fm, dedup=True, dfi=dfi,\n'
         '                                       device=dev)\n'
         '                # on a card this builds the kernels and runs their launch\n'
         '                # self-check\n'
         '                engine = device_engine(opt, fm, dfi=seeder.dfi, device=dev)\n'
         '        except (RuntimeError, OSError) as e:\n'
         '            # a kernel that does not build or launch, or a device that\n'
         '            # cannot be used: the run ends here\n'
         '            print(f"[E::mem] --engine device on {dev}: {e}",\n'
         '                  file=sys.stderr)\n'
         '            if args.output:\n'
         '                out.close()\n'
         '            return 1\n',
         "densify_sa takes the validated interval and a device and reports its time; "
         "the engines take an explicit device, the mesh is a list of devices "
         "(parallel/mesh.py); a kernel that does not build or launch ends the run "
         "with its message"),
        ('            os.remove(args.output)   # shards + header replace the stream\n',
         '            # shards + header replace the stream; processes that share a\n'
         '            # file system each opened it, and the first to end removes it\n'
         '            try:\n'
         '                os.remove(args.output)\n'
         '            except FileNotFoundError:\n'
         '                pass\n',
         "two processes of one host that share -o each remove the stream file "
         "at their end; the second found it gone and failed"),
        ('    proc_id, n_procs = dist_mod.init_distributed()\n',
         '    proc_id, n_procs = dist_mod.init_distributed(\n'
         '        device=dev if dev is not None else "cpu")\n',
         "torch.distributed's backend follows the device"),
        ('    # honor an explicit cpu request: the machine profile may pre-select\n'
         '    # the TPU backend via jax.config, which beats the env var alone\n'
         '    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):\n'
         '        try:\n'
         '            import jax\n'
         '            jax.config.update("jax_platforms", "cpu")\n'
         '        except Exception:\n'
         '            pass\n',
         "",
         "no JAX in the port"),
    ],
}


def _map_back(text: str) -> str:
    return re.sub(r"compseed_tpu_torch", "compseed_tpu", text)


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_is_a_copy(rel):
    with open(os.path.join(ROOT, "compseed_tpu", rel)) as f:
        want = f.read()
    with open(os.path.join(ROOT, "compseed_tpu_torch", rel)) as f:
        got = _map_back(f.read())
    for old, new, reason in ALLOWED.get(rel, []):
        assert want.count(old) == 1, (rel, old, reason)
        want = want.replace(old, new)
    assert got == want


def test_allow_list_names_copied_files_only():
    assert set(ALLOWED) <= set(COPIED)
    assert all(reason for subs in ALLOWED.values() for _, _, reason in subs)


def test_build_index_writes_fixture_index(tmp_path):
    built = build_index(os.path.join(FIXTURES, "tiny.fa"))
    prefix = str(tmp_path / "idx")
    save_index(prefix, built)
    for ext in (".pac", ".ann", ".amb", ".bwt", ".sa"):
        with open(prefix + ext, "rb") as f, \
                open(os.path.join(FIXTURES, "tiny" + ext), "rb") as g:
            assert f.read() == g.read(), ext


def test_fmindex_from_jax_package(tiny_fm):
    """convert.fmindex_from_jax_package carries every field across, and
    the result equals the port's own load of the fixture index."""
    got = convert.fmindex_from_jax_package(tiny_fm)
    want = FMIndex.load(os.path.join(FIXTURES, "tiny"))
    assert isinstance(got, FMIndex) and not isinstance(tiny_fm, FMIndex)
    for k in ("primary", "seq_len", "sa_intv", "l_pac"):
        assert getattr(got, k) == getattr(want, k) == getattr(tiny_fm, k), k
    for k in ("L2", "bwt_words", "cp_occ", "sa_sampled", "pac"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
        assert getattr(got, k) is not getattr(tiny_fm, k), k
    assert got.bns == want.bns
    assert type(got.bns) is type(want.bns)


def test_bench_input_equals_bench_py(monkeypatch, tmp_path):
    """The same genome and reads from the same seeds, byte for byte: the
    genome at full length (its repeat features sit at fixed offsets) with
    reduced N_READS, then both at a reduced GENOME_LEN / N_READS patched
    into both modules, where setup() builds and caches an index whose
    reference is that genome."""
    assert (bench_input.GENOME_LEN, bench_input.N_READS,
            bench_input.READ_LEN, bench_input.COVERAGE) == \
        (bench.GENOME_LEN, bench.N_READS, bench.READ_LEN, bench.COVERAGE)
    for mod in (bench, bench_input):
        monkeypatch.setattr(mod, "N_READS", 64)
    g_want = bench._make_genome(np.random.default_rng(2024))
    g_got = bench_input._make_genome(
        np.random.default_rng(bench_input.GENOME_SEED))
    assert g_got.tobytes() == g_want.tobytes() and len(g_got) == 2_000_000
    assert bench_input._simulate_reads(
        np.random.default_rng(bench_input.READS_SEED), g_got).tobytes() == \
        bench._simulate_reads(np.random.default_rng(7), g_want).tobytes()
    for mod in (bench, bench_input):
        monkeypatch.setattr(mod, "GENOME_LEN", 40_000)
        monkeypatch.setattr(mod, "N_READS", 96)
    g_want = bench._make_genome(np.random.default_rng(2024))
    g_got = bench_input._make_genome(
        np.random.default_rng(bench_input.GENOME_SEED))
    assert g_got.tobytes() == g_want.tobytes() and len(g_got) == 40_000
    r_want = bench._simulate_reads(np.random.default_rng(7), g_want)
    r_got = bench_input._simulate_reads(
        np.random.default_rng(bench_input.READS_SEED), g_got)
    assert r_got.shape == (96, 101) and r_got.tobytes() == r_want.tobytes()
    monkeypatch.setattr(bench_input, "CACHE", str(tmp_path / "cache"))
    fm, reads = bench_input.setup()
    assert fm.sa_intv == 8 and fm.l_pac == 40_000
    assert unpack_pac_range(fm.pac, 0, fm.l_pac).tobytes() == g_got.tobytes()
    assert reads.tobytes() == r_got.tobytes()
    fm2, reads2 = bench_input.setup()                 # from the cache
    assert np.array_equal(fm2.sa_sampled, fm.sa_sampled)
    assert reads2.tobytes() == reads.tobytes()


def test_pe_pairs_equals_pe_bench_script():
    """bench_input.pe_pairs is the pair simulator of scripts/pe_bench.py,
    byte for byte, over the bench genome and from its seed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pe_bench_script", os.path.join(ROOT, "scripts", "pe_bench.py"))
    pe_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pe_bench)
    assert (pe_bench.READ_LEN, pe_bench.INS_MEAN, pe_bench.INS_SD) == \
        (bench_input.READ_LEN, bench_input.INS_MEAN, bench_input.INS_SD)
    genome = bench._make_genome(np.random.default_rng(2024))
    for n_pairs, seed in ((96, 77), (40, 5)):
        w1, w2 = pe_bench.simulate_pairs(np.random.default_rng(seed), genome,
                                         n_pairs)
        g1, g2 = bench_input.pe_pairs(n_pairs, seed)
        assert g1.shape == g2.shape == (n_pairs, 101)
        assert g1.tobytes() == w1.tobytes() and g2.tobytes() == w2.tobytes()
    assert bench_input.PE_SEED == 77
    d1, d2 = bench_input.pe_pairs(96, genome=genome)        # default seed
    g1, g2 = bench_input.pe_pairs(96, 77)
    assert d1.tobytes() == g1.tobytes() and d2.tobytes() == g2.tobytes()


def test_native_library_is_the_ports_own_build():
    import compseed_tpu.native as jax_native
    so = port_native.build_library()
    assert so == os.path.join(ROOT, "build", "compseed_tpu_torch",
                              "libcompseed_host.so")
    assert so != jax_native._SO and os.path.exists(so)
    assert port_native._SRC == jax_native._SRC        # the shared C++ source
    port_native.NativeTail(MemOptions(), FMIndex.load(
        os.path.join(FIXTURES, "tiny")))


def test_native_build_fails_loudly(monkeypatch, tmp_path):
    """A failed g++ build raises, also through build_index: the index
    build does not carry on with the numpy suffix array."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "_SRC", str(bad))
    monkeypatch.setattr(port_native, "_SO", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        port_native.build_library(force=True)
    monkeypatch.setattr(port_native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        build_index(os.path.join(FIXTURES, "tiny.fa"))
