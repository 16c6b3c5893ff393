"""CUDA kernels, each beside its plain PyTorch version and a launch count."""
