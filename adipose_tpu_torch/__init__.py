"""PyTorch port of ``adipose_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``adipose_tpu`` is the reference; this package mirrors its
module names. It imports ``torch`` and never ``jax``. Kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA here
(``csrc/``, bound in ``ops/cuda/``).
"""
