"""WSI classification-overlay renderer: the port's copy of
``adipose_tpu/wsi/overlay.py`` (cv2 on the host).

Behavioral spec: ``Classification/reconstruct_wsi_classification.py``:
  * two-level tile coordinates: chunk offsets ``_x{X}_y{Y}[_w{W}_h{H}]`` plus
    subtile ``_r{row}_c{col}`` (:129-201);
  * per-tile TP (green) / FP (red) / FN (orange) / TN (cyan) rectangles from a
    predictions CSV (:377-447);
  * N x N patch combining with TP>TN>FP>FN priority (:293-374);
  * legend + downsampled output.
"""

from __future__ import annotations

import re
from pathlib import Path

import cv2
import numpy as np

# BGR colors per category (reference :60-66 semantics, stored here as RGB)
CATEGORY_COLORS = {
    "TP": (0, 200, 0),
    "FP": (220, 0, 0),
    "FN": (255, 140, 0),
    "TN": (0, 200, 200),
}
CATEGORY_PRIORITY = ("TP", "TN", "FP", "FN")  # combine_patches order (:293-374)


def parse_two_level_coords(filename: str, tile_size: int = 1024):
    """(abs_x, abs_y) of a tile inside the WSI from chunk + subtile encodings
    (``reconstruct_wsi_classification.py:129-201``)."""
    stem = Path(filename).stem
    chunk = re.search(r"_x(\d+)_y(\d+)(?:_w(\d+)_h(\d+))?", stem)
    sub = re.search(r"_r(\d+)_c(\d+)$", stem)
    if sub is None:
        raise ValueError(f"no _rX_cY suffix in {filename}")
    row, col = int(sub.group(1)), int(sub.group(2))
    base_x = int(chunk.group(1)) if chunk else 0
    base_y = int(chunk.group(2)) if chunk else 0
    return base_x + col * tile_size, base_y + row * tile_size


def categorize(label: int, pred: int) -> str:
    if label and pred:
        return "TP"
    if not label and pred:
        return "FP"
    if label and not pred:
        return "FN"
    return "TN"


def combine_patches(categories: dict, n: int) -> dict:
    """Merge an N×N block of tile categories into one: the highest-priority
    category present wins (``reconstruct_wsi_classification.py:293-374``)."""
    if n <= 1:
        return dict(categories)
    combined = {}
    blocks: dict = {}
    for (x, y), cat in categories.items():
        blocks.setdefault((x // n, y // n), []).append(cat)
    for key, cats in blocks.items():
        for cat in CATEGORY_PRIORITY:
            if cat in cats:
                combined[key] = cat
                break
    return combined


def create_overlay(
    wsi_image: np.ndarray,
    tile_results: list,
    tile_size: int = 1024,
    combine_n: int = 1,
    alpha: float = 0.35,
    downsample: int = 4,
    draw_legend: bool = True,
) -> np.ndarray:
    """Render category rectangles onto the WSI.

    tile_results: [(filename, label, pred), ...] — anything parseable by
    :func:`parse_two_level_coords`.
    """
    img = wsi_image
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    overlay = img.copy()

    cats = {}
    for filename, label, pred in tile_results:
        try:
            x, y = parse_two_level_coords(filename, tile_size)
        except ValueError:
            continue
        cats[(x // tile_size, y // tile_size)] = categorize(int(label), int(pred))
    if combine_n > 1:
        cats = combine_patches(cats, combine_n)
        eff = tile_size * combine_n
    else:
        eff = tile_size

    for (gx, gy), cat in cats.items():
        x, y = gx * eff, gy * eff
        color = CATEGORY_COLORS[cat]
        cv2.rectangle(overlay, (x, y), (x + eff, y + eff), color, -1)
        cv2.rectangle(img, (x, y), (x + eff, y + eff), color, max(2, eff // 64))
    out = cv2.addWeighted(overlay, alpha, img, 1 - alpha, 0)

    if downsample > 1:
        out = cv2.resize(
            out, (out.shape[1] // downsample, out.shape[0] // downsample),
            interpolation=cv2.INTER_AREA,
        )
    if draw_legend:
        y0 = 20
        for cat, color in CATEGORY_COLORS.items():
            cv2.rectangle(out, (10, y0 - 12), (30, y0 + 2), color, -1)
            cv2.putText(out, cat, (36, y0), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        (255, 255, 255), 1)
            y0 += 22
    return out
