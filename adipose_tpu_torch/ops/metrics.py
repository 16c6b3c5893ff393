"""Training metrics (``adipose_tpu/ops/metrics.py``): the activation
statistics of the U-Net trainer's validation step."""

from __future__ import annotations

import torch


def activation_stats(y_pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """Prediction activation statistics, the reference's act_mean/min/max/std
    training metrics (``src/utils/model.py:24-35``); std is the population
    std, as ``jnp.std``."""
    p = y_pred.to(torch.float32)
    return {"act_mean": p.mean(), "act_min": p.min(), "act_max": p.max(),
            "act_std": p.std(correction=0)}
