"""Hand-written CUDA kernels (``csrc/``), their loaders and wrappers."""
