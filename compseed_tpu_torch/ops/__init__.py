"""Device layers of the port: FM-index queries, compressive seeding and
banded Smith-Waterman extension, as PyTorch tensor code plus the
hand-written CUDA kernels (``bsw_cuda``)."""
