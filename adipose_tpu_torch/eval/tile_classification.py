"""Segmentation-as-classification evaluation
(``adipose_tpu/eval/tile_classification.py``).

Behavioral spec: ``Segmentation/tile_classification_evaluation.py``: a tile is
classified "has fat" when its predicted fat-pixel fraction >= a coverage
threshold (``calculate_fat_percentage`` :211, ``evaluate_tiles`` :402); scored
as binary classification with confusion matrix and an optional
``--multi-threshold`` sensitivity sweep. Host numpy over the maps that
``PublicationEvaluator.predict_tiles`` returns.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def calculate_fat_percentage(pred: np.ndarray, pixel_threshold: float = 0.5) -> float:
    """Fraction of pixels above the pixel threshold (:211)."""
    return float((np.asarray(pred) > pixel_threshold).mean())


def classify_tiles(predictions, ground_truths, coverage_threshold: float = 0.025,
                   pixel_threshold: float = 0.5):
    """Per-tile (pred_label, true_label) using fat-coverage >= threshold."""
    pred_labels, true_labels = [], []
    for p, t in zip(predictions, ground_truths):
        pred_labels.append(int(calculate_fat_percentage(p, pixel_threshold) >= coverage_threshold))
        true_labels.append(int((np.asarray(t) > 0.5).mean() >= coverage_threshold))
    return np.asarray(pred_labels), np.asarray(true_labels)


def evaluate_tiles(predictions, ground_truths, coverage_threshold: float = 0.025,
                   pixel_threshold: float = 0.5) -> dict:
    """Binary-classification scoring of the segmenter (:402)."""
    pred, true = classify_tiles(predictions, ground_truths, coverage_threshold, pixel_threshold)
    tp = int(((pred == 1) & (true == 1)).sum())
    fp = int(((pred == 1) & (true == 0)).sum())
    fn = int(((pred == 0) & (true == 1)).sum())
    tn = int(((pred == 0) & (true == 0)).sum())
    eps = 1e-10
    return {
        "coverage_threshold": coverage_threshold,
        "pixel_threshold": pixel_threshold,
        "confusion_matrix": {"tp": tp, "fp": fp, "fn": fn, "tn": tn},
        "accuracy": (tp + tn) / max(tp + fp + fn + tn, 1),
        "precision": tp / (tp + fp + eps),
        "recall": tp / (tp + fn + eps),
        "f1": 2 * tp / (2 * tp + fp + fn + eps),
        "specificity": tn / (tn + fp + eps),
        "n_tiles": len(pred),
    }


def multi_threshold_sweep(predictions, ground_truths,
                          coverage_thresholds=(0.01, 0.025, 0.05, 0.10, 0.20),
                          pixel_threshold: float = 0.5) -> list:
    """``--multi-threshold`` sensitivity analysis."""
    return [evaluate_tiles(predictions, ground_truths, ct, pixel_threshold)
            for ct in coverage_thresholds]


def run_tile_classification_evaluation(predictions, ground_truths, output_dir: str | Path,
                                       coverage_threshold: float = 0.025,
                                       multi_threshold=False,
                                       pixel_threshold: float = 0.5) -> dict:
    """``multi_threshold``: True sweeps the default ladder; a sequence of
    coverage fractions sweeps those (the reference's comma-list
    ``--multi-threshold "1,5,10"``, ``tile_classification_evaluation.py:620``).
    Writes ``tile_classification_metrics.json``."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = evaluate_tiles(predictions, ground_truths, coverage_threshold, pixel_threshold)
    if multi_threshold:
        kwargs = {"pixel_threshold": pixel_threshold}
        if not isinstance(multi_threshold, bool):
            kwargs["coverage_thresholds"] = tuple(multi_threshold)
        results["threshold_sweep"] = multi_threshold_sweep(predictions, ground_truths, **kwargs)
    (out / "tile_classification_metrics.json").write_text(
        json.dumps(results, indent=2, default=float))
    return results
