"""Intensity normalization (``adipose_tpu/ops/normalize.py``), plain PyTorch.

The segment path z-scores with the one-pass kernel in
:mod:`adipose_tpu_torch.ops.cuda.preprocess`; ``zscore_dataset`` is the
plain expression it replaces. The percentile stretch of a grayscale batch
goes through the histogram kernel in :mod:`adipose_tpu_torch.ops.cuda.percentile`
(:func:`batched_percentile_unit_fast`); :func:`percentile_unit`,
:func:`batched_percentile_unit` and the chunker's and ECM tools'
:func:`percentile_stretch_255` are the sort path, as ``jnp.percentile``
computes it (``torch.quantile`` refuses more than 2^24 elements, fewer than
a 6144^2 chunk has).
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda.percentile import percentile_normalize_u8

TRAIN_MEAN_DEFAULT = 200.99  # the stain-normalization target statistics
TRAIN_STD_DEFAULT = 25.26


def zscore_dataset(image: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Standardize by dataset statistics: ``(x - mean) / (std + 1e-10)`` in f32."""
    return (image.to(torch.float32) - mean) / (std + 1e-10)


def _percentiles(flat: torch.Tensor, *ps: float) -> list[torch.Tensor]:
    """``jnp.percentile(row, p)`` ('linear') of each row of a (B, N) float32
    tensor for each ``p``, with jnp's float32 arithmetic: the rank ``p / 100
    * (N - 1)`` in f32, then ``v[lo] * (1 - w) + v[hi] * w``; one sort."""
    n = flat.shape[1]
    ordered = flat.sort(dim=1).values
    out = []
    for p in ps:
        rank = torch.tensor(p, dtype=torch.float32) / 100.0 * (n - 1)
        lo, hi = rank.floor(), rank.ceil()
        w = (rank - lo).to(flat.device)
        lo_i, hi_i = (int(v.clamp(0, n - 1)) for v in (lo, hi))
        out.append(ordered[:, lo_i] * (1.0 - w) + ordered[:, hi_i] * w)
    return out


def batched_percentile_unit(images: torch.Tensor, p_low: float = 1.0,
                            p_high: float = 99.0) -> torch.Tensor:
    """Per-sample percentile stretch to [0, 1] by sorting
    (``src/utils/data.py:413-416``), over every axis but the first."""
    img = images.to(torch.float32)
    flat = img.reshape(img.shape[0], -1)
    plow, phigh = _percentiles(flat, p_low, p_high)
    scale = (phigh - plow).clamp_min(1e-3)
    shape = (-1,) + (1,) * (img.dim() - 1)
    return ((img - plow.view(shape)) / scale.view(shape)).clamp(0.0, 1.0)


def percentile_unit(image: torch.Tensor, p_low: float = 1.0,
                    p_high: float = 99.0) -> torch.Tensor:
    """Percentile stretch of one image to [0, 1] (``src/utils/data.py:413-416``)."""
    return batched_percentile_unit(image[None], p_low, p_high)[0]


def zscore_to_target(image: torch.Tensor, target_mean: float = TRAIN_MEAN_DEFAULT,
                     target_std: float = TRAIN_STD_DEFAULT) -> torch.Tensor:
    """Remap a uint8-range image to the target mean and population std, clip
    to [0, 255] (``stain_normalization.py:348-376``); a constant image is
    returned as it is. float32 in [0, 255]."""
    img = image.to(torch.float32)
    cur_mean, cur_std = img.mean(), img.std(correction=0)
    pos = cur_std > 0
    out = torch.where(pos, (img - cur_mean) / torch.where(pos, cur_std, 1.0) * target_std
                      + target_mean, img)
    return out.clamp(0.0, 255.0)


def percentile_stretch_255(image: torch.Tensor, p_low: float = 1.0,
                           p_high: float = 99.0) -> torch.Tensor:
    """Percentile stretch to [0, 255] (``stain_normalization.py:379-406``)
    through the sort path; a degenerate range returns the input unchanged.
    float32."""
    img = image.to(torch.float32)
    low, high = (v[0] for v in _percentiles(img.reshape(1, -1), p_low, p_high))
    stretched = torch.minimum(torch.maximum(img, low), high)
    stretched = (stretched - low) / (high - low).clamp_min(1e-12) * 255.0
    return torch.where(high == low, img, stretched)


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
