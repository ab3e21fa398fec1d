"""PyTorch + CUDA port of compseed_tpu's alignment path, from the
command line down.

A self-contained package: it imports ``torch``, numpy and the standard
library, never ``jax`` and nothing of ``compseed_tpu``.

  * ``compseed_tpu_torch.ops``      — the device layers: FM-index queries,
    the compressive seeder (``seeder2``), the exact lockstep seeder it
    reruns an overflowing chunk on (``smem``), and the banded
    Smith-Waterman DP, whose kernels are hand-written CUDA
    (``csrc/bsw_extend.cu``).
  * ``compseed_tpu_torch.index``, ``io``, ``cpu``, ``pipeline``,
    ``native``, ``options``, ``utils`` — the host layers, kept file for
    file equal to the JAX package's (same names, the package name
    changed), so SAM parity is a property of the device layers alone.
  * ``compseed_tpu_torch.cli`` — ``index`` / ``mem`` / ``reorder`` /
    ``shm`` / ``merge`` (``python -m compseed_tpu_torch.cli``);
    ``api`` — the SMEM iterator and single-read alignment;
    ``parallel.distributed`` — chunk striding over processes and the
    shard merge; ``parallel.mesh``, ``parallel.sharded`` — the pipeline
    sharded over several devices (``mem --mesh N``).
  * ``compseed_tpu_torch.bench_input`` — the seeded benchmark genome,
    reads and read pairs.

Every public function and class takes an explicit torch device (or
tensors that carry one); the CPU is used only when the caller passes CPU
tensors, as the tests do.  A kernel's wrapper launches the kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors.
"""

__version__ = "0.1.0"

from compseed_tpu_torch.options import MemOptions  # noqa: F401
