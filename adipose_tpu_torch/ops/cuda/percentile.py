"""Exact per-tile percentile stretch to [0, 1]: CUDA kernel and plain version.

Replaces the TPU kernel ``percentile_normalize_u8``
(``adipose_tpu/ops/pallas/preprocess.py:179``, body ``_percentile_kernel``).
For 8-bit data the numpy-'linear' order statistics are exactly recoverable
from a 256-bin histogram, so no tile is sorted. The kernel is
``csrc/percentile.cu``. It is bound by device memory (a few operations per
pixel). Its design builds the histogram with shared-memory integer atomics
over a (chunks x batch) grid, scans it in one block per tile, and stretches
in a second pass over the input; the source's header says more.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adipose_tpu_torch.ops.cuda import build

_IN_DTYPES = (torch.uint8, torch.float32)


def _ranks(n: int, p_low: float, p_high: float) -> tuple[float, float, float, float]:
    """``(rank_lo, frac_lo, rank_hi, frac_hi)``: the floor of each rank
    ``p / 100 * (n - 1)`` and its fraction, computed in double and rounded
    to float32, as the TPU kernel's wrapper passes them."""
    out = []
    for p in (p_low, p_high):
        rank = p / 100.0 * (n - 1)
        floor = math.floor(rank)
        out += [float(np.float32(floor)), float(np.float32(rank - floor))]
    return tuple(out)


def percentile_normalize_u8_plain(tiles: torch.Tensor, p_low: float = 1.0,
                                  p_high: float = 99.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`percentile_normalize_u8`: the same
    histogram, comparisons and f32 arithmetic, one tensor op at a time."""
    b = tiles.shape[0]
    dev = tiles.device
    x = tiles.reshape(b, -1)
    r = x.to(torch.float32) if x.dtype == torch.uint8 else torch.round(x)  # half to even
    valid = (r >= 0) & (r <= 255)  # values outside fall in no bin, as in the TPU kernel
    bins = torch.where(valid, r, 0.0).to(torch.int64)
    hist = torch.zeros((b, 256), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, bins, valid.to(torch.int64))
    cum = hist.cumsum(1).to(torch.float64)
    # Tensor operands throughout: on CUDA a Python-scalar divisor is applied
    # as a multiply by its reciprocal, one rounding away from the kernel's.
    rank_lo, frac_lo, rank_hi, frac_hi = (
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in _ranks(x.shape[1], p_low, p_high))
    one = torch.ones((), dtype=torch.float32, device=dev)

    def value_at(rank):  # v = sum_b [cdf[b] <= rank]
        return (cum <= rank.to(torch.float64)).sum(1).to(torch.float32)

    def order_statistic(rank, frac):
        lo, hi = value_at(rank), value_at(rank + one)
        return lo + frac * (hi - lo)

    low = order_statistic(rank_lo, frac_lo)
    scale = (order_statistic(rank_hi, frac_hi) - low).clamp_min(1e-3)
    out = ((r - low[:, None]) / scale[:, None]).clamp(0.0, 1.0)
    return out.reshape(tiles.shape)


def percentile_normalize_u8(tiles: torch.Tensor, p_low: float = 1.0,
                            p_high: float = 99.0) -> torch.Tensor:
    """Per-tile percentile stretch ``clip((x - P_low) / max(P_high - P_low,
    1e-3), 0, 1)``, with numpy-'linear' percentiles read off a 256-bin CDF.

    Args:
      tiles: (B, H, W) uint8, or float32 holding uint8-range values (rounded
        half to even first, as ``jnp.round``), contiguous.
      p_low, p_high: the percentiles, in [0, 100].

    Returns:
      (B, H, W) float32 in [0, 1].
    """
    if tiles.device.type == "cpu":
        return percentile_normalize_u8_plain(tiles, p_low, p_high)
    if tiles.dtype not in _IN_DTYPES:
        raise TypeError(f"percentile_normalize_u8: tiles dtype {tiles.dtype} not in {_IN_DTYPES}")
    if tiles.dim() != 3 or not tiles.is_contiguous() or tiles.numel() == 0:
        raise ValueError(
            f"percentile_normalize_u8: needs non-empty contiguous (B, H, W) tiles, "
            f"got shape {tuple(tiles.shape)} strides {tiles.stride()}")
    if not tiles.is_cuda:
        raise ValueError(f"percentile_normalize_u8: tiles on {tiles.device}, not CPU or CUDA")
    b, h, w = tiles.shape
    dev = tiles.device
    hist = torch.empty((b, 256), dtype=torch.int32, device=dev)
    low_scale = torch.empty((b, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    index, stream = build.launch_target(dev)
    code = build.library().adipose_percentile(
        index, tiles.data_ptr(), int(tiles.dtype == torch.uint8), hist.data_ptr(),
        low_scale.data_ptr(), out.data_ptr(), b, h * w, *_ranks(h * w, p_low, p_high), stream)
    build.check(code, "percentile_normalize_u8")
    percentile_normalize_u8.launches += 1
    return out


percentile_normalize_u8.launches = 0
