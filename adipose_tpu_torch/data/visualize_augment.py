"""Augmentation visualizer: a debugging grid of augmented examples, the
port's ``adipose_tpu/data/visualize_augment.py``.

Behavioral spec: ``src/utils/data.py:462-508`` (``visualize_augmentation``):
N rows of [original | augmented | augmented mask] rendered for a chosen
tier. The tier's draws come from :func:`adipose_tpu_torch.data.augment.draw_tier`
on one ``torch.Generator`` seeded from ``seed`` (the JAX package's
``jax.random`` stream is not reproduced); the grid is drawn with
:mod:`adipose_tpu_torch.core.charts`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.core.charts import Figure
from adipose_tpu_torch.data.augment import batched_tier, draw_tier


def augmented_examples(image: np.ndarray, mask: np.ndarray, tier: str = "moderate",
                       num_examples: int = 5, seed: int = 42, device="cuda") -> list:
    """``num_examples`` (augmented image, augmented mask) pairs of one square
    (H, W) image and its mask, drawn in turn from one generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
    msk = torch.as_tensor(np.asarray(mask, np.float32), device=device)[None]
    h, w = img.shape[1:]
    out = []
    for _ in range(num_examples):
        ai, am = batched_tier(draw_tier(g, tier, 1, h, w), img, msk, tier)
        out.append((ai[0].cpu().numpy(), am[0].cpu().numpy()))
    return out


def visualize_augmentation(
    image: np.ndarray,
    mask: np.ndarray,
    tier: str = "moderate",
    num_examples: int = 5,
    save_path: str | Path | None = None,
    seed: int = 42,
    device="cuda",
):
    """The grid, 9 x 3n inches at 120 dpi: saved to ``save_path`` (its path
    returned), else the :class:`~adipose_tpu_torch.core.charts.Figure`."""
    fig = Figure(9, 3 * num_examples, 120, num_examples, 3)
    examples = augmented_examples(image, mask, tier, num_examples, seed, device)
    for i, (ai, am) in enumerate(examples):
        fig.panel(i, 0).image(np.asarray(image, np.float32), "Original")
        fig.panel(i, 1).image(ai, f"Augmented {i + 1} ({tier})")
        fig.panel(i, 2).image(am, "Augmented Mask")
    if save_path:
        return fig.save(save_path)
    return fig
