"""Reinhard LAB stain normalization, batched on the device: the port's copy
of ``adipose_tpu/ops/stain.py`` in plain PyTorch.

Behavioral spec: ``src/utils/stain_normalization.py:32-146``: per-channel
LAB statistics transfer ``(x - mu_src) * (sigma_ref / sigma_src) + mu_ref``
against a reference tile whose statistics live in
``stain_reference_metadata.json`` (L 62.5 +- 15.2, A 8.3 +- 12.1, B 14.7 +-
8.9 for the shipped reference). Each tile of a batch takes its own LAB mean
and population std over its pixels, in one pass over the whole batch.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.ops.color import lab2rgb, rgb2lab


@dataclass(frozen=True)
class LabStats:
    """Per-channel LAB mean/std. ``mean``/``std`` have shape (3,) = (L, A, B)."""

    mean: tuple
    std: tuple

    @classmethod
    def from_image(cls, rgb, device="cpu") -> "LabStats":
        """LAB stats of an RGB image in [0,1] or uint8
        (``stain_normalization.py:76-92``), computed on ``device``."""
        mean, std = compute_lab_stats(_to_unit(torch.as_tensor(np.asarray(rgb), device=device)))
        return cls(mean=tuple(float(x) for x in mean.cpu()),
                   std=tuple(float(x) for x in std.cpu()))

    @classmethod
    def from_metadata(cls, path: str | Path) -> "LabStats":
        """Load from a stain_reference_metadata.json
        (``src/utils/stain_reference_metadata.json`` consumed at
        ``stain_normalization.py:324-345``)."""
        meta = json.loads(Path(path).read_text())
        lab = meta.get("lab_statistics") or meta.get("lab_stats") or meta
        mean = tuple(float(lab[c]["mean"]) for c in ("L", "A", "B"))
        std = tuple(float(lab[c]["std"]) for c in ("L", "A", "B"))
        return cls(mean=mean, std=std)

    def as_arrays(self, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.mean, dtype=torch.float32, device=device),
                torch.tensor(self.std, dtype=torch.float32, device=device))


# Shipped reference stats (src/utils/stain_reference_metadata.json:12-28)
DEFAULT_REFERENCE = LabStats(mean=(62.5, 8.3, 14.7), std=(15.2, 12.1, 8.9))


def _to_unit(rgb: torch.Tensor) -> torch.Tensor:
    if not rgb.is_floating_point():
        return rgb.to(torch.float32) / 255.0
    return rgb.to(torch.float32)


def compute_lab_stats(rgb_unit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std of each LAB channel over every axis but the
    last; (..., 3) in [0,1]."""
    lab = rgb2lab(rgb_unit)
    axes = tuple(range(lab.dim() - 1))
    return lab.mean(dim=axes), lab.std(dim=axes, correction=0)


def _transfer(lab: torch.Tensor, axes: tuple, ref_mean: torch.Tensor,
              ref_std: torch.Tensor) -> torch.Tensor:
    src_mean = lab.mean(dim=axes, keepdim=True)
    src_std = lab.std(dim=axes, correction=0, keepdim=True)
    # a zero-variance source channel maps to the reference mean
    # (stain_normalization.py:129-134)
    zero = src_std == 0.0
    scale = torch.where(zero, 0.0, ref_std / torch.where(zero, 1.0, src_std))
    return lab2rgb((lab - src_mean) * scale + ref_mean)


def reinhard_normalize(rgb_unit: torch.Tensor, ref_mean: torch.Tensor,
                       ref_std: torch.Tensor) -> torch.Tensor:
    """Reinhard transfer of one (H, W, 3) RGB image in [0,1] -> normalized
    RGB in [0,1]; per channel ``(lab - mu_src) * (sigma_ref / sigma_src) +
    mu_ref``."""
    lab = rgb2lab(rgb_unit)
    return _transfer(lab, tuple(range(lab.dim() - 1)), ref_mean, ref_std)


def reinhard_normalize_batch(rgb_batch_unit: torch.Tensor, ref_mean: torch.Tensor,
                             ref_std: torch.Tensor) -> torch.Tensor:
    """Reinhard over a (B, H, W, 3) batch in [0,1]: each tile uses its own
    source statistics over dims (1, 2), as the reference builder applies it
    tile by tile (``build_dataset.py:1211-1250``)."""
    return _transfer(rgb2lab(rgb_batch_unit), (1, 2), ref_mean, ref_std)


def normalize_image(rgb, reference: LabStats = DEFAULT_REFERENCE, device=None):
    """``ReinhardStainNormalizer.normalize_image``
    (``stain_normalization.py:94-146``): accepts uint8 or unit floats (numpy
    or torch) and returns a tensor in the range it received; uint8 output is
    truncated, as ``astype(uint8)`` truncates. It runs on ``device``; by
    default a tensor's own device, and the card for numpy input."""
    if device is None:
        device = rgb.device if torch.is_tensor(rgb) else "cuda"
    rgb = torch.as_tensor(np.asarray(rgb) if not torch.is_tensor(rgb) else rgb, device=device)
    is_uint8 = not rgb.is_floating_point() or bool(rgb.max() > 1.0)
    unit = _to_unit(rgb) if is_uint8 else rgb.to(torch.float32)
    ref_mean, ref_std = reference.as_arrays(unit.device)
    out = reinhard_normalize(unit, ref_mean, ref_std)
    if is_uint8:
        return (out * 255.0).to(torch.uint8)
    return out
