"""Device layers of the port: FM-index queries, compressive seeding and
banded Smith-Waterman extension, as PyTorch tensor code plus one CUDA
kernel (``bsw_cuda``)."""
