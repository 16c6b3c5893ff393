"""Threshold optimization on slide-level macro F1
(``adipose_tpu/eval/threshold.py``).

Behavioral spec (``full_evaluation_enhanced.py:891-983,1593-1627``):
  * grid 0.10..0.90 step 0.05; per threshold, tiles group by slide id, the
    mean tile F1 per slide is averaged across slides (slide-macro F1), the
    best wins;
  * optional two-stage adaptive search: coarse 0.1..0.9 step 0.1, then fine
    +-0.05 step 0.01 around the winner;
  * a tile-level variant for backward compatibility.

Each tile's F1 at every threshold is computed on the device, one batch per
shape group; only the (tiles x thresholds) matrix crosses to the host.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.ops.metrics import f1_threshold_sweep


def extract_slide_id(tile_path: str) -> str:
    """Strip a trailing ``_rX_cY`` pair (``full_evaluation_enhanced.py:658-678``)."""
    stem = Path(tile_path).stem
    parts = stem.split("_")
    if len(parts) >= 2 and parts[-2].startswith("r") and parts[-1].startswith("c"):
        return "_".join(parts[:-2])
    if parts[-1].startswith(("r", "c")):
        return "_".join(parts[:-1])
    return stem


def _f1_matrix(predictions, ground_truths, thresholds, device="cuda") -> np.ndarray:
    """(n_tiles, n_thresholds) float64 F1 matrix, computed on ``device`` in
    float32 per shape group (sliding-window datasets mix image sizes)."""
    thr = np.asarray(thresholds, np.float32)
    groups = defaultdict(list)
    for i, p in enumerate(predictions):
        groups[p.shape].append(i)
    out = np.empty((len(predictions), len(thr)), np.float64)
    for idxs in groups.values():
        preds = torch.from_numpy(np.stack([predictions[i] for i in idxs])).to(device)
        trues = torch.from_numpy(np.stack([ground_truths[i] for i in idxs])).to(device)
        out[idxs] = f1_threshold_sweep(preds, trues, thr).cpu().numpy()
    return out


def _slide_macro_f1(f1_matrix: np.ndarray, slide_ids) -> np.ndarray:
    """Mean over tiles per slide, then mean over slides, per threshold."""
    groups = defaultdict(list)
    for row, sid in enumerate(slide_ids):
        groups[sid].append(row)
    return np.stack([f1_matrix[rows].mean(axis=0) for rows in groups.values()]).mean(axis=0)


def optimize_threshold_f1_slide_level(predictions, ground_truths, tile_paths,
                                      threshold_range=None, device="cuda"):
    """(optimal_threshold, slide-macro F1 per threshold)
    (``full_evaluation_enhanced.py:891-947``)."""
    if threshold_range is None:
        threshold_range = np.arange(0.1, 0.95, 0.05)
    slide_ids = [extract_slide_id(p) for p in tile_paths]
    macro = _slide_macro_f1(_f1_matrix(predictions, ground_truths, threshold_range, device),
                            slide_ids)
    return float(threshold_range[int(np.argmax(macro))]), macro


def optimize_threshold_f1(predictions, ground_truths, threshold_range=None, device="cuda"):
    """Tile-level variant (``full_evaluation_enhanced.py:950-983``)."""
    if threshold_range is None:
        threshold_range = np.arange(0.1, 0.95, 0.05)
    mean_f1 = _f1_matrix(predictions, ground_truths, threshold_range, device).mean(axis=0)
    return float(threshold_range[int(np.argmax(mean_f1))]), mean_f1


def optimize_threshold_adaptive(predictions, ground_truths, tile_paths, device="cuda"):
    """Two-stage grid: coarse 0.1..0.9 step 0.1, then +-0.05 step 0.01
    (``full_evaluation_enhanced.py:1596-1616``)."""
    t1, _ = optimize_threshold_f1_slide_level(predictions, ground_truths, tile_paths,
                                              np.arange(0.1, 0.95, 0.1), device)
    fine = np.arange(max(0.01, t1 - 0.05), min(0.99, t1 + 0.05) + 1e-9, 0.01)
    return optimize_threshold_f1_slide_level(predictions, ground_truths, tile_paths, fine,
                                             device)
