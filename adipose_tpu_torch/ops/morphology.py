"""Grayscale morphology (``adipose_tpu/ops/morphology.py``), plain PyTorch on
the tensor's device: erosion and dilation are windowed min and max over a
constant-padded image (a min is the max of the negated image), exact in every
bit. A window is separable, and a 1-D window of k takes about log2(k)
elementwise maxima of shifted views (spans doubled, then two overlapping
spans), so a 512-tall window costs 10 passes rather than 512 reads a pixel.

Rectangles are cv2's anchors (k // 2 before, the rest after). Disks are the
alternating 3x3 cross and square iteration of the JAX package, which
converges to an octagon inscribed in the disk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """The max of each run of k consecutive elements along ``dim`` (VALID:
    n - k + 1 of them): spans doubled while they fit in k, then the max of
    the two spans that overlap to cover k."""
    span = 1
    while 2 * span <= k:
        n = x.shape[dim]
        x = torch.maximum(x.narrow(dim, 0, n - span), x.narrow(dim, span, n - span))
        span *= 2
    if span < k:
        n, off = x.shape[dim], k - span
        x = torch.maximum(x.narrow(dim, 0, n - off), x.narrow(dim, off, n - off))
    return x


def _max_window(x: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """VALID windowed max of an (H, W) tensor over a ky x kx window."""
    return _window_max_1d(_window_max_1d(x, ky, 0), kx, 1)


def _pad_k(img: torch.Tensor, ky: int, kx: int, value: float) -> torch.Tensor:
    """SAME-style pad for a ky x kx window (cv2 anchors at k // 2, so the
    high side gets k - 1 - k // 2)."""
    ry_lo, rx_lo = ky // 2, kx // 2
    return F.pad(img, (rx_lo, kx - 1 - rx_lo, ry_lo, ky - 1 - ry_lo), value=value)


def erode_rect(img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """Grayscale erosion (windowed min) with a ky x kx rectangle; the border
    is padded with +inf, so it takes the interior's min."""
    x = img.to(torch.float32)
    return -_max_window(-_pad_k(x, ky, kx, float("inf")), ky, kx)


def dilate_rect(img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    x = img.to(torch.float32)
    return _max_window(_pad_k(x, ky, kx, float("-inf")), ky, kx)


def open_rect(img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    return dilate_rect(erode_rect(img, ky, kx), ky, kx)


def close_rect(img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    return erode_rect(dilate_rect(img, ky, kx), ky, kx)


# ---- Octagonal (disk-approx) elements ---------------------------------------


def _masked_extreme(x: torch.Tensor, square: bool) -> torch.Tensor:
    """The 3x3 square's or cross's max at every pixel, the border padded
    with -inf: a 3x3 window, or the larger of a 3x1 and a 1x3 window for the
    cross. The min is this max of the negated image, negated."""
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    if square:
        return _max_window(xp, 3, 3)
    return torch.maximum(_max_window(xp[:, 1:-1], 3, 1), _max_window(xp[1:-1], 1, 3))


def erode_disk(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Disk-approximate erosion: alternate 3x3 cross and square erosions
    ``radius`` times (an octagonal limit set); the dilation of the negated
    image, negated once."""
    return -dilate_disk(-img.to(torch.float32), radius)


def dilate_disk(img: torch.Tensor, radius: int) -> torch.Tensor:
    x = img.to(torch.float32)
    for i in range(radius):
        x = _masked_extreme(x, square=i % 2 == 1)
    return x


def open_disk(img: torch.Tensor, radius: int) -> torch.Tensor:
    return dilate_disk(erode_disk(img, radius), radius)


def close_disk(img: torch.Tensor, radius: int) -> torch.Tensor:
    return erode_disk(dilate_disk(img, radius), radius)


# ---- Composite corrections --------------------------------------------------


def remove_banding_morphological(img: torch.Tensor, kernel_width: int = 1,
                                 kernel_height: int = 512) -> torch.Tensor:
    """Background subtraction with a tall rectangle opening
    (``preprocess_small_MS_SIMs.py:217-246``)."""
    x = img.to(torch.float32)
    background = open_rect(x, kernel_height, kernel_width)
    return (x - background + background.mean()).clamp(0.0, 255.0)


def correct_illumination_rolling_ball(img: torch.Tensor, radius: int = 100) -> torch.Tensor:
    """Rolling-ball background subtraction (the disk-opening approximation of
    ``preprocess_small_MS_SIMs.py:293-327``)."""
    x = img.to(torch.float32)
    background = open_disk(x, radius)
    return (x - background + background.mean()).clamp(0.0, 255.0)


def correct_illumination_tophat(img: torch.Tensor, kernel_size: int = 301) -> torch.Tensor:
    """White top-hat boost (``preprocess_small_MS_SIMs.py:357-390``)."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    x = img.to(torch.float32)
    tophat = x - open_disk(x, kernel_size // 2)
    return (x + tophat * 0.5).clamp(0.0, 255.0)
