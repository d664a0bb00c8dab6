"""Hand-written CUDA kernels of the filter (``csrc/``), each with its plain
PyTorch version beside it."""
