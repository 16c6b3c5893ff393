"""sRGB <-> CIELAB conversion (D65, 2-degree observer): the port's copy of
``adipose_tpu/ops/color.py`` in plain batched PyTorch.

The reference's Reinhard stain transfer calls ``skimage.color.rgb2lab`` and
``lab2rgb`` per tile (``src/utils/stain_normalization.py:27,83,115,137``);
here the conversion is elementwise tensor work over whole tile batches on
the tensors' device. The formulas are the standard CIE ones: sRGB gamma
decode, linear RGB, XYZ (D65 matrix), f(t) companding, L*a*b*.
"""

from __future__ import annotations

import torch

# sRGB D65 -> XYZ (rows: X, Y, Z), IEC 61966-2-1
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
# Its float32 inverse as the JAX package computes it (jnp.linalg.inv of the
# float32 matrix), copied bit for bit: a float64 inverse rounds otherwise.
_XYZ2RGB = (
    (float.fromhex("0x1.9ec816p+1"), float.fromhex("-0x1.8982c2p+0"),
     float.fromhex("-0x1.fe804ep-2")),
    (float.fromhex("-0x1.f0422ap-1"), float.fromhex("0x1.e040e0p+0"),
     float.fromhex("0x1.546d14p-5")),
    (float.fromhex("0x1.c7db6cp-5"), float.fromhex("-0x1.a1e06ap-3"),
     float.fromhex("0x1.0eabf0p+0")),
)

# D65 reference white
_WHITE = (0.95047, 1.0, 1.08883)

_DELTA = 6.0 / 29.0
_DELTA3 = _DELTA**3
_KAPPA = 1.0 / (3.0 * _DELTA**2)


def srgb_to_linear(rgb: torch.Tensor) -> torch.Tensor:
    """Gamma-decode sRGB in [0,1] to linear light."""
    rgb = rgb.to(torch.float32)
    return torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    lin = lin.to(torch.float32).clamp_min(0.0)
    return torch.where(lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1.0 / 2.4) - 0.055)


def _f(t: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt; the root is only taken where t > delta^3 > 0, where
    # pow(t, 1/3) is defined (the other branch's NaN-free value is kept)
    return torch.where(t > _DELTA3, t.clamp_min(_DELTA3) ** (1.0 / 3.0),
                       _KAPPA * t + 4.0 / 29.0)


def _f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > _DELTA, ft**3, (ft - 4.0 / 29.0) / _KAPPA)


def _apply_3x3(m, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) @ 3x3^T as explicit float32 elementwise products and sums,
    in the JAX package's order (no matmul, so no TF32 or reduced-precision
    path on any device)."""
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[r][0] * c0 + m[r][1] * c1 + m[r][2] * c2 for r in range(3)], dim=-1)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1], shape (..., 3) -> L*a*b* (L in [0,100])."""
    lin = srgb_to_linear(rgb.to(torch.float32).clamp(0.0, 1.0))
    xyz = _apply_3x3(_RGB2XYZ, lin)
    white = torch.tensor(_WHITE, dtype=torch.float32, device=xyz.device)
    fxyz = _f(xyz / white)
    fx, fy, fz = fxyz[..., 0], fxyz[..., 1], fxyz[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab2rgb(lab: torch.Tensor) -> torch.Tensor:
    """L*a*b* -> sRGB in [0,1] (clipped)."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    white = torch.tensor(_WHITE, dtype=torch.float32, device=lab.device)
    xyz = _f_inv(torch.stack([fx, fy, fz], dim=-1)) * white
    lin = _apply_3x3(_XYZ2RGB, xyz)
    return linear_to_srgb(lin).clamp(0.0, 1.0)


def rgb2gray(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv2.COLOR_RGB2GRAY weights), shape (..., 3) -> (...)."""
    x = rgb.to(torch.float32)
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
