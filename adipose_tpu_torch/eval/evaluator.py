"""Tile IO for evaluation and inference (``adipose_tpu/eval/evaluator.py``)."""

from __future__ import annotations

import numpy as np


def read_image_gray(path: str) -> np.ndarray:
    """Grayscale float32 load; 16-bit TIFFs are scaled to the 8-bit range."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"Failed to load {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if img.dtype == np.uint16:
        img = (img / 257.0).astype(np.float32)
    return img.astype(np.float32)
