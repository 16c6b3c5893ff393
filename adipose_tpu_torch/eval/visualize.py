"""Mask overlays (``adipose_tpu/eval/visualize.py``), numpy only."""

from __future__ import annotations

import numpy as np


def _to_rgb(gray_or_rgb: np.ndarray) -> np.ndarray:
    a = np.asarray(gray_or_rgb)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return np.clip(a, 0, 255).astype(np.uint8)


def color_overlay(image: np.ndarray, mask: np.ndarray, rgb, alpha: float = 0.4) -> np.ndarray:
    """Blend ``rgb`` into ``image`` where ``mask > 0.5``; uint8 RGB out."""
    base = _to_rgb(image).astype(np.float32)
    sel = np.asarray(mask) > 0.5
    color = np.asarray(rgb, np.float32)
    base[sel] = alpha * color + (1 - alpha) * base[sel]
    return base.astype(np.uint8)
