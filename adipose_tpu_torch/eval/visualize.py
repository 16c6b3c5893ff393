"""Evaluation visualizations (``adipose_tpu/eval/visualize.py``), host code
on numpy and cv2: mask overlays, 4-panel comparisons and Dice-bucketed
overlay folders.

Behavioral spec: ``full_evaluation_enhanced.py``:
  * ``create_4panel_visualization`` (:1021-1107): original / GT overlay
    (yellow) / prediction overlay (magenta) / discrepancy map
    (green=TP, red=FP, blue=FN, black=TN);
  * Dice-bucketed overlay folders (:1801-1876): tiles sorted into
    poor (<0.5) / fair (<0.65) / good (<0.75) / excellent buckets
    (bucket edges from ``get_dice_bucket``, :1140-1153).
"""

from __future__ import annotations

from pathlib import Path

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


def dice_bucket(dice: float) -> str:
    """(:1140-1153)."""
    if dice < 0.5:
        return "poor"
    if dice < 0.65:
        return "fair"
    if dice < 0.75:
        return "good"
    return "excellent"


def discrepancy_map(pred_bin: np.ndarray, true_bin: np.ndarray) -> np.ndarray:
    """green=TP, red=FP, blue=FN, black=TN (:1084-1100)."""
    h, w = pred_bin.shape
    out = np.zeros((h, w, 3), np.uint8)
    p, t = pred_bin > 0.5, true_bin > 0.5
    out[p & t] = (0, 200, 0)
    out[p & ~t] = (220, 0, 0)
    out[~p & t] = (0, 0, 220)
    return out


def create_4panel_visualization(
    original: np.ndarray,
    gt_mask: np.ndarray,
    pred_mask: np.ndarray,
    dice_score: float,
    output_path: str | Path,
    threshold: float = 0.5,
) -> Path:
    """2x2 grid saved as one PNG (composited directly, without matplotlib)."""
    import cv2

    pred_bin = (np.asarray(pred_mask) > threshold).astype(np.float32)
    true_bin = (np.asarray(gt_mask) > 0.5).astype(np.float32)
    p1 = _to_rgb(original)
    p2 = color_overlay(original, true_bin, (255, 255, 0))      # GT yellow
    p3 = color_overlay(original, pred_bin, (255, 0, 255))      # pred magenta
    p4 = discrepancy_map(pred_bin, true_bin)
    top = np.concatenate([p1, p2], axis=1)
    bottom = np.concatenate([p3, p4], axis=1)
    grid = np.concatenate([top, bottom], axis=0)
    label = f"Dice {dice_score:.3f}"
    cv2.putText(grid, label, (10, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.9,
                (255, 255, 255), 2)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(output_path), cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
    return output_path


def save_bucketed_visualizations(
    images: list,
    preds: list,
    trues: list,
    dices: list,
    names: list,
    output_dir: str | Path,
    threshold: float = 0.5,
    max_per_bucket: int = 40,
) -> dict:
    """Dice-bucketed 4-panel dumps (:1801-1876). Returns bucket counts."""
    output_dir = Path(output_dir)
    counts: dict = {}
    for img, pred, true, dice, name in zip(images, preds, trues, dices, names):
        bucket = dice_bucket(float(dice))
        if counts.get(bucket, 0) >= max_per_bucket:
            continue
        out = output_dir / bucket / f"{Path(name).stem}_dice{float(dice):.3f}.png"
        create_4panel_visualization(img, true, pred, float(dice), out, threshold)
        counts[bucket] = counts.get(bucket, 0) + 1
    return counts
