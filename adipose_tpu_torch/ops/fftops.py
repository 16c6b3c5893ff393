"""FFT debanding, illumination and contrast field ops for ECM fluorescence
channels (``adipose_tpu/ops/fftops.py``), plain PyTorch on the tensor's device.

Behavioral spec: ``pre-post-processing_tools/preprocess_small_MS_SIMs.py``:
  * ``remove_banding_fft`` (:145-214): a Gaussian notch pair at ±center_freq
    on the horizontal frequency axis, inverse FFT, optional blend;
  * ``remove_banding_column_normalize`` (:249-290): per-column
    standardization with optional global-statistics restoration;
  * ``correct_illumination_polynomial`` (:329-355): heavy Gaussian-blur
    multiplicative flat-field correction;
  * ``sharpen_image`` (:434-459): unsharp mask.

The Gaussian blur is two 1-D convolutions in full float32: under PyTorch's
default ``cudnn.allow_tf32`` a float32 conv on the card rounds its inputs to
TF32 (~1e-3 relative), which flips uint8 levels, so :func:`full_f32` turns
TF32 off around each conv. Reflect padding follows ``numpy.pad``'s 'reflect'
at any width (``F.pad`` refuses a pad as wide as the image, and the blur's
radius is 600 at sigma 150).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def recip(v: float) -> float:
    """The float32 reciprocal of ``v``: XLA compiles ``x / constant`` as
    ``x * (1 / constant)``, and so does this package, on either device."""
    return float(np.float32(1.0) / np.float32(v))


@contextlib.contextmanager
def full_f32():
    """cuDNN's float32 convolutions in full float32 (no TF32) within the
    block, whatever the global setting, which is restored after it."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def reflect_index(n: int, lo: int, hi: int, device=None) -> torch.Tensor:
    """Source indices of ``numpy.pad(arange(n), (lo, hi), 'reflect')``: the
    edge is not repeated, and a pad wider than ``n - 1`` reflects again."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def reflect_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """``jnp.pad(x, ((top, bottom), (left, right)), mode='reflect')`` of an
    (H, W) tensor."""
    h, w = x.shape
    if top or bottom:
        x = x.index_select(0, reflect_index(h, top, bottom, x.device))
    if left or right:
        x = x.index_select(1, reflect_index(w, left, right, x.device))
    return x


def remove_banding_fft(img: torch.Tensor, band_freq_range: tuple = (0.01, 0.05),
                       vertical_width: int = 3, smooth_sigma_scale: float = 0.5,
                       blend: float = 1.0) -> torch.Tensor:
    """FFT notch filter for vertical banding; float32 in [0, 255] in and out
    (``preprocess_small_MS_SIMs.py:145-214``)."""
    x = img.to(torch.float32)
    rows, cols = x.shape
    f = torch.fft.fftshift(torch.fft.fft2(x))

    crow, ccol = rows // 2, cols // 2
    freq_low = max(min(band_freq_range[0], 0.5), 0.0)
    freq_high = max(min(band_freq_range[1], 0.5), freq_low + 1e-4)
    band_width = max(freq_high - freq_low, 1e-4)
    center_freq = (freq_low + freq_high) / 2.0

    y_grid = ((torch.arange(rows, dtype=torch.float32, device=x.device) - crow)
              * recip(rows))[:, None]
    x_grid = ((torch.arange(cols, dtype=torch.float32, device=x.device) - ccol)
              * recip(cols))[None, :]

    sigma_x = max(band_width * smooth_sigma_scale, band_width * 0.25)
    sigma_y = max((vertical_width / rows) * smooth_sigma_scale, 1.0 / rows)

    rx, ry = recip(sigma_x), recip(sigma_y)
    g_left = torch.exp(-0.5 * (((x_grid + center_freq) * rx) ** 2 + (y_grid * ry) ** 2))
    g_right = torch.exp(-0.5 * (((x_grid - center_freq) * rx) ** 2 + (y_grid * ry) ** 2))
    notch = (g_left + g_right).clamp(0.0, 1.0)
    mask = (1.0 - notch).clamp(0.0, 1.0)

    filtered = torch.fft.ifft2(torch.fft.ifftshift(f * mask)).abs().clamp(0.0, 255.0)
    return (x * (1.0 - blend) + filtered * blend).clamp(0.0, 255.0)


def remove_banding_column_normalize(img: torch.Tensor,
                                    preserve_global: bool = True) -> torch.Tensor:
    """Per-column standardization (``preprocess_small_MS_SIMs.py:249-290``),
    population statistics as ``jnp.std``."""
    x = img.to(torch.float32)
    if preserve_global:
        g_mean, g_std = x.mean(), x.std(correction=0)
    col_mean = x.mean(dim=0, keepdim=True)
    col_std = x.std(dim=0, keepdim=True, correction=0) + 1e-10
    z = (x - col_mean) / col_std
    if preserve_global:
        out = z * g_std + g_mean
    else:
        lo, hi = z.min(), z.max()
        out = (z - lo) / (hi - lo + 1e-10) * 255.0
    return out.clamp(0.0, 255.0)


def _gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x * recip(sigma)) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with cv2.GaussianBlur(ksize=0)'s support for
    float input (radius = round(4 sigma)), reflect-101 padding; full float32."""
    if sigma <= 0:
        return img.to(torch.float32)
    radius = max(1, int(round(4.0 * sigma)))
    k = _gaussian_kernel1d(sigma, radius, img.device)
    x = img.to(torch.float32)
    with full_f32():
        x = F.conv2d(reflect_pad(x, radius, radius, 0, 0)[None, None], k.view(1, 1, -1, 1))[0, 0]
        x = F.conv2d(reflect_pad(x, 0, 0, radius, radius)[None, None], k.view(1, 1, 1, -1))[0, 0]
    return x


def correct_illumination_polynomial(img: torch.Tensor,
                                    smoothing_sigma: float = 150.0) -> torch.Tensor:
    """Multiplicative flat-field via a heavy Gaussian blur
    (``preprocess_small_MS_SIMs.py:329-355``)."""
    x = img.to(torch.float32)
    background = gaussian_blur(x, smoothing_sigma)
    return (x * (background.mean() / (background + 1.0))).clamp(0.0, 255.0)


def sharpen_unsharp(img: torch.Tensor, sigma: float = 1.0, amount: float = 0.5) -> torch.Tensor:
    """Unsharp mask (``preprocess_small_MS_SIMs.py:434-459``)."""
    x = img.to(torch.float32)
    return (x + amount * (x - gaussian_blur(x, sigma))).clamp(0.0, 255.0)
