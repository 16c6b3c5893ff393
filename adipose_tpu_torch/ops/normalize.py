"""Intensity normalization (``adipose_tpu/ops/normalize.py``), plain PyTorch.

The segment path z-scores with the one-pass kernel in
:mod:`adipose_tpu_torch.ops.cuda.preprocess`; ``zscore_dataset`` is the
plain expression it replaces.
"""

from __future__ import annotations

import torch

TRAIN_MEAN_DEFAULT = 200.99  # the stain-normalization target statistics
TRAIN_STD_DEFAULT = 25.26


def zscore_dataset(image: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Standardize by dataset statistics: ``(x - mean) / (std + 1e-10)`` in f32."""
    return (image.to(torch.float32) - mean) / (std + 1e-10)
