"""Full-slide reconstruction from model-tile predictions: the port's copy of
``adipose_tpu/wsi/reconstruct.py``, with the predict and the blend canvases
on the reconstructor's device.

Behavioral spec: ``Segmentation/reconstruct_full_images.py``:
  * filename contract ``{slide_id}_r{row}_c{col}.jpg`` (:114-146);
  * slide grouping with row/col ranges (:149-201);
  * dimension resolution: true source image if findable, else inferred from
    the tile grid (max_pos * stride + tile) (:204-298);
  * coverage gate: found/expected tiles >= min_coverage (default 0.9)
    (:301-327, 685-699);
  * per-tile prediction (+-TTA, +-refinement) then Gaussian-blended
    reconstruction of prediction, GT, and the grayscale source (:334-417);
  * per-slide metrics + ``reconstruction_log.json`` (:544-579).

Tile predictions are batched on the device and blended into canvases that
stay there (:mod:`adipose_tpu_torch.ops.blend`). For canvases too large for
memory, rows of tiles are blended in stripes (stripe height = tile size),
each independently: exact, because band boundaries fall on stride
multiples, so no tile spans two bands.
"""

from __future__ import annotations

import json
from collections import defaultdict
from datetime import datetime
from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.core.host_copy import copy_in, predict_batch
from adipose_tpu_torch.core.hostio import thread_map, write_csv
from adipose_tpu_torch.eval.boundary import BoundaryRefiner
from adipose_tpu_torch.ops.blend import (accumulate_predictions, accumulate_weights,
                                         blend_tiles, finalize_blend, gaussian_weight_map)
from adipose_tpu_torch.ops.metrics import pixel_metrics
from adipose_tpu_torch.parallel.mesh import pad_batch_to


def parse_tile_filename(filename: str):
    """(slide_id, row, col) from the trailing ``_rX_cY``
    (``reconstruct_full_images.py:114-146``)."""
    stem = Path(filename).stem
    parts = stem.split("_")
    if len(parts) >= 2 and parts[-2].startswith("r") and parts[-1].startswith("c"):
        try:
            return "_".join(parts[:-2]), int(parts[-2][1:]), int(parts[-1][1:])
        except (ValueError, IndexError):
            pass
    raise ValueError(f"Cannot parse tile position from filename: {filename}")


def group_tiles_by_slide(images_dir: str | Path, masks_dir: str | Path | None = None):
    """(:149-201)."""
    images_dir = Path(images_dir)
    mask_files = {}
    if masks_dir and Path(masks_dir).exists():
        for ext in ("*.tif", "*.tiff", "*.png"):
            for m in Path(masks_dir).glob(ext):
                mask_files.setdefault(m.stem, m)
    slides = defaultdict(lambda: {"tiles": [], "positions": set()})
    for img_path in sorted(images_dir.glob("*.jpg")):
        try:
            slide_id, row, col = parse_tile_filename(img_path.name)
        except ValueError:
            continue
        slides[slide_id]["tiles"].append(
            (row, col, img_path, mask_files.get(img_path.stem))
        )
        slides[slide_id]["positions"].add((row, col))
    for info in slides.values():
        rows = [r for r, _ in info["positions"]]
        cols = [c for _, c in info["positions"]]
        info["row_range"] = (min(rows), max(rows))
        info["col_range"] = (min(cols), max(cols))
    return dict(slides)


def infer_full_image_dimensions(positions, tile_size: int, stride: int):
    """Grid fallback (:229-248): size = max_index * stride + tile."""
    max_row = max(r for r, _ in positions)
    max_col = max(c for _, c in positions)
    return max_row * stride + tile_size, max_col * stride + tile_size


def find_source_image(slide_id: str, data_root: str | Path | None):
    """Recursive source lookup (:204-227)."""
    if data_root is None:
        return None
    for ext in (".tif", ".tiff", ".jpg", ".png"):
        for p in Path(data_root).rglob(f"{slide_id}{ext}"):
            return p
    return None


def coverage(positions, row_range, col_range) -> float:
    expected = (row_range[1] - row_range[0] + 1) * (col_range[1] - col_range[0] + 1)
    return len(positions) / max(expected, 1)


class SlideReconstructor:
    """Drives per-slide reconstruction with a batched tile predictor
    ``predict_fn(params, tiles (B, T, T) on device) -> (B, T, T)``."""

    def __init__(
        self,
        predict_fn,
        params,
        tile_size: int = 1024,
        stride: int = 1024,
        blend_sigma_factor: float = 0.25,
        batch_size: int = 8,
        use_refinement: bool = False,
        stripe_tiles: int = 0,
        blend_mode: str = "gaussian",
        refine_kernel: int = 5,
        device="cuda",
    ):
        self.predict_fn = predict_fn
        self.params = params
        self.tile_size = tile_size
        self.stride = stride
        self.batch_size = batch_size
        self.device = torch.device(device)
        # 'linear'/'none' average uniformly (reconstruct_full_images.py:898)
        self.weight_map = (
            gaussian_weight_map(tile_size, blend_sigma_factor, device=self.device)
            if blend_mode == "gaussian"
            else torch.ones((tile_size, tile_size), dtype=torch.float32, device=self.device)
        )
        self.refiner = (BoundaryRefiner(kernel_size=refine_kernel)
                        if use_refinement else None)
        self.stripe_tiles = stripe_tiles  # 0 = single canvas

    def _predict_batch(self, tiles: np.ndarray) -> np.ndarray:
        b = self.batch_size
        return np.concatenate([predict_batch(self.predict_fn, self.params, tiles[i : i + b], b,
                                             self.device) for i in range(0, len(tiles), b)])

    def _predict_and_blend(self, tiles: np.ndarray, positions: np.ndarray,
                           shape) -> np.ndarray:
        """Predict chunks and blend them into device-resident canvases:
        prediction maps never visit the host (same accumulation order as
        :func:`blend_tiles`, so the result is bit-identical to
        ``_blend(_predict_batch(tiles), ...)``)."""
        h, w = int(shape[0]), int(shape[1])
        acc = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        wsum = torch.zeros_like(acc)
        b = self.batch_size
        for i in range(0, len(tiles), b):
            (chunk, cpos), n = pad_batch_to(b, tiles[i : i + b], positions[i : i + b])
            pred = self.predict_fn(self.params, copy_in(chunk, self.device))
            valid = np.arange(b) < n
            accumulate_predictions(acc, pred, cpos, self.weight_map, valid)
            accumulate_weights(wsum, cpos, self.weight_map, valid)
        return finalize_blend(acc, wsum).cpu().numpy()

    def _blend(self, tiles: np.ndarray, positions: np.ndarray, shape):
        h, w = int(shape[0]), int(shape[1])
        if not self.stripe_tiles:
            return blend_tiles(copy_in(tiles, self.device), positions, self.weight_map, h,
                               w).cpu().numpy()
        # Striped blending for canvases beyond device memory: process bands of
        # `stripe_tiles` tile-rows; tiles fall wholly inside one band because
        # band boundaries align to stride multiples.
        band_h = self.stripe_tiles * self.stride + (self.tile_size - self.stride)
        out = np.zeros((h, w), np.float32)
        wsum = np.zeros((h, w), np.float32)
        wm = self.weight_map.cpu().numpy()
        band_step = self.stripe_tiles * self.stride
        for y0 in range(0, h, band_step):
            sel = (positions[:, 0] >= y0) & (positions[:, 0] < y0 + band_step)
            if not sel.any():
                continue
            local = positions[sel].copy()
            local[:, 0] -= y0
            bh = min(band_h, h - y0)
            band = blend_tiles(copy_in(tiles[sel], self.device), local, self.weight_map,
                               bh, w).cpu().numpy()
            # accumulate band weights for overlap-correct normalization
            bw = np.zeros((bh, w), np.float32)
            for (ty, tx) in local:
                bw[ty : ty + self.tile_size, tx : tx + self.tile_size] += wm
            out[y0 : y0 + bh] += band * bw
            wsum[y0 : y0 + bh] += bw
        return out / np.maximum(wsum, 1e-8)

    def reconstruct_slide(self, tiles_info, full_shape):
        """Returns (pred_full, gt_full | None, image_full).

        tiles_info: [(row, col, image_path, mask_path|None), ...]
        """

        def decode(info):
            row, col, img_path, mask_path = info
            img = cv2.imread(str(img_path), cv2.IMREAD_GRAYSCALE)
            if img is None:
                return None
            gt = None
            if mask_path is not None:
                m = cv2.imread(str(mask_path), cv2.IMREAD_UNCHANGED)
                gt = (np.asarray(m) > 0).astype(np.float32)
            return img.astype(np.float32), (row * self.stride, col * self.stride), gt

        decoded = [d for d in thread_map(decode, tiles_info) if d is not None]
        imgs = [d[0] for d in decoded]
        positions = [d[1] for d in decoded]
        gts = [d[2] for d in decoded]
        if not imgs:
            raise ValueError("no readable tiles")
        tiles = np.stack(imgs)
        positions = np.asarray(positions, np.int32)

        if self.refiner is None and not self.stripe_tiles:
            pred_full = self._predict_and_blend(tiles, positions, full_shape)
        else:  # host refinement / striped canvases need the maps on host
            preds = self._predict_batch(tiles)
            if self.refiner is not None:
                preds = np.stack([self.refiner.refine(p) for p in preds])
            pred_full = self._blend(preds, positions, full_shape)
        img_full = self._blend(tiles, positions, full_shape)
        gt_full = None
        if all(g is not None for g in gts):
            gt_full = self._blend(np.stack(gts), positions, full_shape)
        return pred_full, gt_full, img_full


def reconstruct_all_slides(
    images_dir: str | Path,
    masks_dir: str | Path | None,
    output_dir: str | Path,
    predict_fn,
    params,
    tile_size: int = 1024,
    stride: int = 1024,
    min_coverage: float = 0.9,
    threshold: float = 0.5,
    data_root: str | Path | None = None,
    batch_size: int = 8,
    use_refinement: bool = False,
    blend_mode: str = "gaussian",
    refine_kernel: int = 5,
    max_tiles: int | None = None,
    save_masks: bool = True,
    save_overlays: bool = False,
    save_comparisons: bool = False,
    device="cuda",
) -> dict:
    """Batch driver with coverage gating, per-slide outputs, and
    ``reconstruction_log.json`` (:586-866). ``max_tiles`` limits each slide to
    its top-left N x N tile grid, encoded in the output dir name (:603-678)."""
    output_dir = Path(output_dir)
    if max_tiles:
        output_dir = output_dir.parent / f"{output_dir.name}_{max_tiles}x{max_tiles}"
    output_dir.mkdir(parents=True, exist_ok=True)
    slides = group_tiles_by_slide(images_dir, masks_dir)
    if max_tiles:
        for info in slides.values():
            info["tiles"] = [t for t in info["tiles"]
                             if t[0] < max_tiles and t[1] < max_tiles]
            info["positions"] = {(r, c) for r, c in info["positions"]
                                 if r < max_tiles and c < max_tiles}
            info["row_range"] = (0, max_tiles - 1)
            info["col_range"] = (0, max_tiles - 1)
    recon = SlideReconstructor(predict_fn, params, tile_size, stride,
                               batch_size=batch_size,
                               use_refinement=use_refinement,
                               blend_mode=blend_mode,
                               refine_kernel=refine_kernel,
                               device=device)
    log = {
        "timestamp": datetime.now().isoformat(),
        "n_slides": len(slides),
        "slides": {},
        "skipped": {},
    }
    summary_rows = []
    for slide_id, info in slides.items():
        cov = coverage(info["positions"], info["row_range"], info["col_range"])
        if cov < min_coverage:
            log["skipped"][slide_id] = {"coverage": cov}
            continue
        src = None if max_tiles else find_source_image(slide_id, data_root)
        if src is not None:
            src_img = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)
            shape = src_img.shape[:2]
        else:
            shape = infer_full_image_dimensions(info["positions"], tile_size, stride)
        pred, gt, img = recon.reconstruct_slide(info["tiles"], shape)

        slide_dir = output_dir / slide_id
        slide_dir.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(slide_dir / "prediction.png"),
                    (np.clip(pred, 0, 1) * 255).astype(np.uint8))
        if save_masks:
            cv2.imwrite(str(slide_dir / "binary_mask.png"),
                        ((pred > threshold) * 255).astype(np.uint8))
        cv2.imwrite(str(slide_dir / "image.png"), np.clip(img, 0, 255).astype(np.uint8))
        if save_overlays:
            from adipose_tpu_torch.eval.visualize import color_overlay

            ov = color_overlay(img, pred > threshold, (0, 255, 255))
            cv2.imwrite(str(slide_dir / "overlay.png"),
                        cv2.cvtColor(ov, cv2.COLOR_RGB2BGR))
        entry = {"coverage": cov, "shape": list(shape)}
        if gt is not None:
            cv2.imwrite(str(slide_dir / "ground_truth.png"),
                        (np.clip(gt, 0, 1) * 255).astype(np.uint8))
            # in key order, as the JAX package's jitted dict comes back
            m = {k: float(v) for k, v in sorted(pixel_metrics(
                copy_in(pred, recon.device), copy_in(gt, recon.device), threshold).items())}
            entry["metrics"] = m
            (slide_dir / "metrics.json").write_text(json.dumps(m, indent=2))
            summary_rows.append({"slide": slide_id, **m})
            if save_comparisons:
                from adipose_tpu_torch.eval.visualize import create_4panel_visualization

                create_4panel_visualization(
                    img, gt, pred, m["dice_score"],
                    slide_dir / "comparison_4panel.png", threshold,
                )
        log["slides"][slide_id] = entry
    (output_dir / "reconstruction_log.json").write_text(json.dumps(log, indent=2))
    if summary_rows:
        write_csv(output_dir / "summary.csv", summary_rows)
    return log
