"""PyTorch + CUDA port of compseed_tpu's default alignment path.

The port owns only what ``compseed_tpu.ops`` does with JAX: the device
FM-index, the compressive seeder and the banded Smith-Waterman DP.  The
JAX-free host layers of ``compseed_tpu`` (index/, io/, pipeline/,
native/, cpu/, options.py, utils.py) are imported unchanged, so SAM
parity with the JAX package is a property of the device layers alone.

Nothing here imports ``jax``.  Every public function and class takes an
explicit torch device (or tensors that carry one); the CPU is used only
when the caller passes CPU tensors, as the tests do.  The DP runs on a
hand-written CUDA kernel (``csrc/bsw_extend.cu``) for CUDA tensors and
on its plain PyTorch version for CPU tensors.
"""
