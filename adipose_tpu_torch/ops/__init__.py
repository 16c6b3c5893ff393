"""Tensor ops; hand-written CUDA kernels live in ``ops.cuda``."""
