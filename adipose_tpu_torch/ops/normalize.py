"""Intensity normalization (``adipose_tpu/ops/normalize.py``), plain PyTorch.

The segment path z-scores with the one-pass kernel in
:mod:`adipose_tpu_torch.ops.cuda.preprocess`; ``zscore_dataset`` is the
plain expression it replaces. The percentile stretch of a grayscale batch
goes through the histogram kernel in :mod:`adipose_tpu_torch.ops.cuda.percentile`
(:func:`batched_percentile_unit_fast`); :func:`percentile_unit` and
:func:`batched_percentile_unit` are the sort path, as ``jnp.percentile``
computes it.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda.percentile import percentile_normalize_u8

TRAIN_MEAN_DEFAULT = 200.99  # the stain-normalization target statistics
TRAIN_STD_DEFAULT = 25.26


def zscore_dataset(image: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Standardize by dataset statistics: ``(x - mean) / (std + 1e-10)`` in f32."""
    return (image.to(torch.float32) - mean) / (std + 1e-10)


def _percentiles(flat: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(row, p)`` ('linear') of each row of a (B, N) float32
    tensor, with jnp's float32 arithmetic: the rank ``p / 100 * (N - 1)`` in
    f32, then ``v[lo] * (1 - w) + v[hi] * w``."""
    n = flat.shape[1]
    rank = torch.tensor(p, dtype=torch.float32) / 100.0 * (n - 1)
    lo, hi = rank.floor(), rank.ceil()
    w = rank - lo
    ordered = flat.sort(dim=1).values
    lo_i, hi_i = (int(v.clamp(0, n - 1)) for v in (lo, hi))
    w = w.to(flat.device)
    return ordered[:, lo_i] * (1.0 - w) + ordered[:, hi_i] * w


def batched_percentile_unit(images: torch.Tensor, p_low: float = 1.0,
                            p_high: float = 99.0) -> torch.Tensor:
    """Per-sample percentile stretch to [0, 1] by sorting
    (``src/utils/data.py:413-416``), over every axis but the first."""
    img = images.to(torch.float32)
    flat = img.reshape(img.shape[0], -1)
    plow = _percentiles(flat, p_low)
    phigh = _percentiles(flat, p_high)
    scale = (phigh - plow).clamp_min(1e-3)
    shape = (-1,) + (1,) * (img.dim() - 1)
    return ((img - plow.view(shape)) / scale.view(shape)).clamp(0.0, 1.0)


def percentile_unit(image: torch.Tensor, p_low: float = 1.0,
                    p_high: float = 99.0) -> torch.Tensor:
    """Percentile stretch of one image to [0, 1] (``src/utils/data.py:413-416``)."""
    return batched_percentile_unit(image[None], p_low, p_high)[0]


def batched_percentile_unit_fast(images: torch.Tensor, p_low: float = 1.0,
                                 p_high: float = 99.0) -> torch.Tensor:
    """Per-tile percentile stretch to [0, 1], fast path.

    A (B, H, W) grayscale batch goes to the exact 256-bin-CDF kernel
    (:func:`~adipose_tpu_torch.ops.cuda.percentile.percentile_normalize_u8`;
    its plain version for a CPU tensor), which rounds fractional input to
    the nearest bin first (PARITY.md §Known deviations). An RGB
    (B, H, W, 3) batch takes the sort path.
    """
    if images.dim() == 3:
        return percentile_normalize_u8(images, p_low, p_high)
    return batched_percentile_unit(images, p_low, p_high)
