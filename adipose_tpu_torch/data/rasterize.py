"""Annotation JSON -> binary masks, on the host: the port's copy of
``adipose_tpu/data/rasterize.py`` (cv2 and numpy only).

Behavioral spec: ``Segmentation/build_dataset.py:738-963``:
  * annotation files are lists (or single dicts) of records with an optional
    ``confidenceScore`` (1/2/3) and ``annotation.elements`` containing
    ``type: 'polyline'`` point lists;
  * records below ``min_confidence`` are skipped; records with NO score are
    always included (flagged ``missing_confidence``);
  * polygons rasterize with ``cv2.fillPoly`` into {0,1} masks;
  * tile-scoped extraction shifts polygons into tile-local coordinates and
    flags tiles whose intersecting annotations are ALL low-confidence
    (``get_tile_annotations`` :840-905);
  * mask post-processing: fat - bubbles subtraction, morphological close,
    small-component removal (``prepare_target_masks`` :1134-1194).

Rasterization is integer polygon scan-conversion over sparse annotations,
not tensor work, so it stays on the host.
"""

from __future__ import annotations

import json
from pathlib import Path

import cv2
import numpy as np


def _records(payload):
    return payload if isinstance(payload, list) else [payload]


def _iter_polylines(record):
    if not isinstance(record, dict):
        return
    for elem in record.get("annotation", {}).get("elements", []) or []:
        if not isinstance(elem, dict) or elem.get("type") != "polyline":
            continue
        pts = elem.get("points", [])
        if pts and len(pts) >= 3:
            coords = np.array(
                [[int(round(p[0])), int(round(p[1]))] for p in pts], dtype=np.int32
            )
            if len(coords) >= 3:
                yield coords


def load_json_annotations(json_path: str | Path, min_confidence: int = 1):
    """Returns (polygons, missing_confidence) (``build_dataset.py:738-802``)."""
    payload = json.loads(Path(json_path).read_text(encoding="utf-8"))
    polys, missing = [], False
    for ann in _records(payload):
        if not isinstance(ann, dict):
            continue
        confidence = ann.get("confidenceScore")
        if confidence is None:
            missing = True
        elif confidence < min_confidence:
            continue
        polys.extend(_iter_polylines(ann))
    return polys, missing


def slide_has_valid_annotations(json_path: str | Path, min_confidence: int) -> bool:
    """(``build_dataset.py:805-837``)."""
    payload = json.loads(Path(json_path).read_text(encoding="utf-8"))
    for ann in _records(payload):
        if not isinstance(ann, dict):
            continue
        confidence = ann.get("confidenceScore")
        if confidence is not None and confidence < min_confidence:
            continue
        for _ in _iter_polylines(ann):
            return True
    return False


def get_tile_annotations(json_path: str | Path, tile_bbox, min_confidence: int):
    """Polygons intersecting a tile, tile-local coords; flags low-conf-only
    tiles (``build_dataset.py:840-905``)."""
    payload = json.loads(Path(json_path).read_text(encoding="utf-8"))
    x1, y1, x2, y2 = tile_bbox
    polys = []
    has_low = has_high = False
    for ann in _records(payload):
        if not isinstance(ann, dict):
            continue
        confidence = ann.get("confidenceScore")
        for coords in _iter_polylines(ann):
            xs, ys = coords[:, 0], coords[:, 1]
            if xs.max() < x1 or xs.min() > x2 or ys.max() < y1 or ys.min() > y2:
                continue
            if confidence is not None and confidence < min_confidence:
                has_low = True
                continue
            polys.append(coords - np.array([x1, y1]))
            has_high = True
    return polys, (has_low and not has_high)


def create_binary_mask(polygons, width: int, height: int) -> np.ndarray:
    """cv2.fillPoly rasterization → {0,1} uint8 (``build_dataset.py:907-915``)."""
    mask = np.zeros((height, width), dtype=np.uint8)
    cv_polys = [
        np.asarray(p, dtype=np.int32).reshape(-1, 1, 2)
        for p in polygons
        if len(p) >= 3
    ]
    if cv_polys:
        cv2.fillPoly(mask, cv_polys, 1)
    return mask


def remove_small_components(mask: np.ndarray, min_area: int) -> np.ndarray:
    """Drop connected components below min_area (``build_dataset.py:1170-1190``)."""
    n, labels, stats, _ = cv2.connectedComponentsWithStats(
        mask.astype(np.uint8), connectivity=8
    )
    out = np.zeros_like(mask, dtype=np.uint8)
    for i in range(1, n):
        if stats[i, cv2.CC_STAT_AREA] >= min_area:
            out[labels == i] = 1
    return out


def prepare_target_mask(
    fat_mask: np.ndarray,
    bubble_mask: np.ndarray | None = None,
    close_kernel: int = 5,
    min_component_area: int = 50,
) -> np.ndarray:
    """fat − bubbles, morphological close, small-component removal
    (``build_dataset.py:1134-1194``)."""
    target = fat_mask.astype(np.uint8).copy()
    if bubble_mask is not None:
        target[bubble_mask.astype(bool)] = 0
    if close_kernel > 1:
        kernel = cv2.getStructuringElement(
            cv2.MORPH_ELLIPSE, (close_kernel, close_kernel)
        )
        target = cv2.morphologyEx(target, cv2.MORPH_CLOSE, kernel)
    if min_component_area > 0:
        target = remove_small_components(target, min_component_area)
    return target


def create_overlay(image, mask: np.ndarray, rgb_color=(255, 255, 0), alpha: float = 0.4):
    """Annotation overlay render (``build_dataset.py:918-928``); image is an
    RGB array or path."""
    if isinstance(image, (str, Path)):
        arr = cv2.cvtColor(cv2.imread(str(image)), cv2.COLOR_BGR2RGB)
    else:
        arr = np.asarray(image).copy()
    sel = mask > 0
    color = np.asarray(rgb_color, dtype=np.float32)
    arr[sel] = (alpha * color + (1 - alpha) * arr[sel].astype(np.float32)).astype(np.uint8)
    return arr
