"""Training metrics (``adipose_tpu/ops/metrics.py``): the activation
statistics of the U-Net trainer's validation step, and the classifier
trainer's ROC AUC and accuracy. Each is computed on the device, so reading
it is the only wait for the host."""

from __future__ import annotations

import torch


def activation_stats(y_pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """Prediction activation statistics, the reference's act_mean/min/max/std
    training metrics (``src/utils/model.py:24-35``); std is the population
    std, as ``jnp.std``."""
    p = y_pred.to(torch.float32)
    return {"act_mean": p.mean(), "act_min": p.min(), "act_max": p.max(),
            "act_std": p.std(correction=0)}


def roc_auc(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Exact ROC AUC by the Mann-Whitney rank statistic, ties given their
    average rank, as ``sklearn.roc_auc_score``
    (``full_evaluation_enhanced.py:869``); NaN when only one class is
    present (:857-863). A 0-dim float32 tensor on ``pred``'s device."""
    scores = pred.reshape(-1).to(torch.float32)
    labels = (true.reshape(-1).to(scores.device) > 0.5).to(torch.float32)
    n = scores.numel()
    order = torch.argsort(scores, stable=True)
    ordered, labels = scores[order], labels[order]
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)
    new_group = torch.ones(n, dtype=torch.bool, device=scores.device)
    new_group[1:] = ordered[1:] != ordered[:-1]
    group = torch.cumsum(new_group, 0) - 1
    group_sum = torch.zeros_like(idx).index_add_(0, group, idx)
    group_cnt = torch.zeros_like(idx).index_add_(0, group, torch.ones_like(idx))
    avg_rank = (group_sum / group_cnt.clamp_min(1.0))[group]
    n_pos = labels.sum()
    n_neg = n - n_pos
    auc = ((avg_rank * labels).sum() - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg).clamp_min(1.0)
    return torch.where((n_pos == 0) | (n_neg == 0), torch.full_like(auc, float("nan")), auc)


def binary_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    """The share of ``(y_pred > threshold) == y_true``, as float32."""
    return ((y_pred > threshold).to(torch.float32) == y_true).to(torch.float32).mean()
