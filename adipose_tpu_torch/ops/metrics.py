"""Training and evaluation metrics (``adipose_tpu/ops/metrics.py``): the
activation statistics of the U-Net trainer's validation step, the
classifier's ROC AUC, accuracy and compiled metric set, and the evaluator's
pixel metrics, threshold sweep and AUCs.

Behavioral spec from ``Segmentation/full_evaluation_enhanced.py``:
  * ``calculate_pixel_metrics`` (:720-785): thresholded confusion counts with
    the both-empty => all-metrics-perfect convention for background tiles;
  * ``calculate_auc_metrics`` (:847-888): pixel-level ROC AUC and PR AUC,
    NaN when only one class is present.

Each is computed on the device over a batch of tiles, so only the per-tile
scalars cross to the host. Thresholds are float32, as the JAX package
compares them: a float64 threshold would promote the map and flip the
pixels that sit on a grid value.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10


def _f32(threshold, device) -> torch.Tensor:
    return torch.as_tensor(threshold, dtype=torch.float32, device=device)


def confusion_counts(pred: torch.Tensor, true: torch.Tensor, threshold: float = 0.5):
    """TP/FP/FN/TN pixel counts of each map at a threshold, summed over the
    last two dims: binarization is ``pred > threshold`` and ``true > 0.5``
    (``full_evaluation_enhanced.py:733-734``)."""
    p = pred > _f32(threshold, pred.device)
    t = true > 0.5
    return tuple(m.sum((-2, -1)) for m in (p & t, p & ~t, ~p & t, ~p & ~t))


def metrics_from_counts(tp, fp, fn, tn) -> dict[str, torch.Tensor]:
    """Derived metrics in float32 with the both-empty = perfect convention
    (``full_evaluation_enhanced.py:736-785``)."""
    tp, fp, fn, tn = (torch.as_tensor(v).to(torch.float32) for v in (tp, fp, fn, tn))
    both_empty = (tp + fp + fn) == 0

    def perfect_if_empty(x):
        return torch.where(both_empty, torch.ones_like(x), x)

    f1 = perfect_if_empty(2.0 * tp / (2.0 * tp + fp + fn + _EPS))
    return {
        "dice_score": f1,
        "jaccard_index": perfect_if_empty(tp / (tp + fp + fn + _EPS)),
        "sensitivity": perfect_if_empty(tp / (tp + fn + _EPS)),
        "specificity": perfect_if_empty(tn / (tn + fp + _EPS)),
        "precision": perfect_if_empty(tp / (tp + fp + _EPS)),
        "f1_score": f1,
        "accuracy": perfect_if_empty((tp + tn) / (tp + fp + fn + tn + _EPS)),
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
    }


def pixel_metrics(pred: torch.Tensor, true: torch.Tensor,
                  threshold: float = 0.5) -> dict[str, torch.Tensor]:
    """The pixel-metric dict of one (H, W) map, or of each map of an
    (N, H, W) batch."""
    return metrics_from_counts(*confusion_counts(pred, true, threshold))


batched_pixel_metrics = pixel_metrics


def f1_threshold_sweep(pred: torch.Tensor, true: torch.Tensor, thresholds=None,
                       num_thresholds: int = 17) -> torch.Tensor:
    """F1 at each threshold, (..., T) for (..., H, W) maps, both-empty = 1.

    The default grid is ``arange(num_thresholds) * 0.05 + 0.1`` in float32
    (``full_evaluation_enhanced.py:891-983``: 0.1 .. 0.9 step 0.05); the
    evaluator optimizes the slide-macro mean on the host. One pass per
    threshold, so no (T, ..., H, W) mask is held in memory.
    """
    if thresholds is None:
        thr = torch.arange(num_thresholds, dtype=torch.float32, device=pred.device) * 0.05 + 0.1
    else:
        thr = _f32(thresholds, pred.device)
    return torch.stack([pixel_metrics(pred, true, t)["f1_score"] for t in thr], -1)


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


def classifier_metrics(y_true: torch.Tensor, y_prob: torch.Tensor,
                       threshold: float = 0.5) -> dict[str, torch.Tensor]:
    """acc / auc / precision / recall over (N,) probabilities, the
    classifier's compiled metric set
    (``Classification/train_adipose_classifier_v0.py:372-378``); counts as in
    :func:`confusion_counts`, empty denominators clamped to 1."""
    p = y_prob > _f32(threshold, y_prob.device)
    t = y_true.to(y_prob.device) > 0.5
    tp, fp, fn, tn = (m.sum().to(torch.float32) for m in (p & t, p & ~t, ~p & t, ~p & ~t))
    return {
        "acc": (tp + tn) / (tp + fp + fn + tn).clamp_min(1.0),
        "auc": roc_auc(y_prob, y_true),
        "precision": tp / (tp + fp).clamp_min(1.0),
        "recall": tp / (tp + fn).clamp_min(1.0),
    }


def pr_auc(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Average precision (``sklearn.average_precision_score``): the sum of
    (R_i - R_{i-1}) P_i over descending-score thresholds, one threshold per
    block of tied scores; NaN when only one class is present. A 0-dim
    float32 tensor on ``pred``'s device."""
    scores = pred.reshape(-1).to(torch.float32)
    labels = (true.reshape(-1).to(scores.device) > 0.5).to(torch.float32)
    n = scores.numel()
    n_pos = labels.sum()
    order = torch.argsort(-scores, stable=True)
    ordered, labels = scores[order], labels[order]
    tp_cum = torch.cumsum(labels, 0)
    fp_cum = torch.cumsum(1.0 - labels, 0)
    precision = tp_cum / (tp_cum + fp_cum).clamp_min(1.0)
    recall = tp_cum / n_pos.clamp_min(1.0)
    # the last index of each tie block is a threshold; each one's recall
    # step spans back to the previous block's last index
    is_boundary = torch.ones(n, dtype=torch.bool, device=scores.device)
    is_boundary[:-1] = ordered[:-1] != ordered[1:]
    idx = torch.arange(n, device=scores.device)
    last = torch.cummax(torch.where(is_boundary, idx, torch.full_like(idx, -1)), 0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    r_prev = torch.where(prev >= 0, recall[prev.clamp_min(0)], torch.zeros_like(recall))
    delta_r = torch.where(is_boundary, recall - r_prev, torch.zeros_like(recall))
    ap = (delta_r * precision).sum()
    return torch.where((n_pos == 0) | (n_pos == n), torch.full_like(ap, float("nan")), ap)


def auc_metrics(pred: torch.Tensor, true: torch.Tensor) -> dict[str, torch.Tensor]:
    """ROC and PR AUC of one map (``full_evaluation_enhanced.py:847-888``)."""
    return {"roc_auc": roc_auc(pred, true), "pr_auc": pr_auc(pred, true)}


def batched_auc_metrics(pred: torch.Tensor, true: torch.Tensor) -> dict[str, np.ndarray]:
    """Per-map ROC and PR AUC over an (N, H, W) stack, computed on the device
    and copied to the host once: ``{"roc_auc": (N,), "pr_auc": (N,)}``."""
    pairs = torch.stack([torch.stack([roc_auc(p, t), pr_auc(p, t)])
                         for p, t in zip(pred, true)]).cpu().numpy()
    return {"roc_auc": pairs[:, 0], "pr_auc": pairs[:, 1]}
