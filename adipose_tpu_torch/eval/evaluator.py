"""Publication-quality evaluation (``adipose_tpu/eval/evaluator.py``).

Behavioral spec: ``run_publication_evaluation`` + ``main``
(``full_evaluation_enhanced.py:1446-2167``):
  * deterministic seeds (1337), training-set normalization statistics (no
    leakage), deep supervision detected from ``training_settings.log``;
  * per-tile inference with optional TTA and/or sliding window + blending
    and/or boundary refinement;
  * slide-level threshold optimization (grid or two-stage adaptive);
  * slide grouping -> per-slide means of tile metrics -> bootstrap CIs;
  * artifact contract: ``<ckpt>/evaluation/<dataset>_<source>_<enhancements>/``
    with ``{dataset}_comprehensive_results.csv``, ``metrics.json``,
    ``predictions.csv`` and optional 4-panel visualizations.

Tiles are predicted in device batches of ``batch_size`` forward images (TTA
views fold into the batch): the z-score by kernel A, the U-Net's head by
kernel B, the TTA views and their inverse by kernel D. Confusion counts,
AUCs and the threshold sweep reduce on the device; only the boundary
metrics (scipy EDT) run on the host.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.core.config import EvalConfig, UNetConfig
from adipose_tpu_torch.core.host_copy import predict_batch
from adipose_tpu_torch.core.hostio import thread_map, write_csv
from adipose_tpu_torch.eval.batch_eval import build_eval_config_string
from adipose_tpu_torch.eval.boundary import BoundaryRefiner, calculate_boundary_metrics
from adipose_tpu_torch.eval.bootstrap import safe_bootstrap_ci
from adipose_tpu_torch.eval.sliding_window import SlidingWindowInference
from adipose_tpu_torch.eval.threshold import (extract_slide_id, optimize_threshold_adaptive,
                                              optimize_threshold_f1_slide_level)
from adipose_tpu_torch.eval.tta import make_tta_predict
from adipose_tpu_torch.eval.visualize import save_bucketed_visualizations
from adipose_tpu_torch.ops.d4 import MODE_IDS
from adipose_tpu_torch.ops.metrics import batched_auc_metrics, batched_pixel_metrics
from adipose_tpu_torch.serving.predict import load_segmenter
from adipose_tpu_torch.train import checkpoint as ckpt

METRIC_KEYS = (
    "dice_score", "jaccard_index", "sensitivity", "specificity", "precision",
    "f1_score", "accuracy", "roc_auc", "pr_auc", "hausdorff95", "assd",
)
# metrics.json key -> the comprehensive results CSV's display name
DISPLAY_NAMES = {
    "dice_score": "Dice Score", "jaccard_index": "Jaccard Index (IoU)",
    "sensitivity": "Sensitivity (Recall)", "specificity": "Specificity",
    "precision": "Precision", "f1_score": "F1 Score", "accuracy": "Accuracy",
    "roc_auc": "ROC AUC", "pr_auc": "PR AUC", "hausdorff95": "Hausdorff95", "assd": "ASSD",
}


def load_validation_data(val_root: str | Path):
    """Paired (image, mask) paths (``full_evaluation_enhanced.py:1386-1443``):
    recurses images/ and masks/, pairs by stem, tolerates a '_mask' suffix."""
    val_root = Path(val_root)
    images_dir, masks_dir = val_root / "images", val_root / "masks"
    if not images_dir.exists() or not masks_dir.exists():
        raise FileNotFoundError(f"Image/mask dirs not found under {val_root}")
    img_exts = {".jpg", ".jpeg", ".png", ".tif", ".tiff"}
    image_files = sorted(p for p in images_dir.rglob("*") if p.suffix.lower() in img_exts)
    masks_by_stem = {}
    # sorted: first-seen wins on stem collisions, so the chosen mask does
    # not depend on the filesystem's iteration order
    for m in sorted(masks_dir.rglob("*")):
        if m.suffix.lower() in img_exts:
            masks_by_stem.setdefault(m.stem, m)
            if m.stem.endswith("_mask"):
                masks_by_stem.setdefault(m.stem[: -len("_mask")], m)
    pairs = [(str(p), str(masks_by_stem[p.stem])) for p in image_files if p.stem in masks_by_stem]
    if not pairs:
        raise FileNotFoundError(f"No paired tiles under {val_root}")
    return pairs


def read_image_gray(path: str) -> np.ndarray:
    """Grayscale float32 load; 16-bit TIFFs are scaled to the 8-bit range
    (``full_evaluation_enhanced.py:1356-1384``)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"Failed to load {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if img.dtype == np.uint16:
        img = (img / 257.0).astype(np.float32)
    return img.astype(np.float32)


def build_output_dir(checkpoint_dir: Path, test_dataset: Path, cfg: EvalConfig,
                     output: str | None = None) -> Path:
    """``<ckpt>/evaluation/<dataset>_<source>[_<flags>]``
    (``full_evaluation_enhanced.py:2053-2101``); the checkpoint visualizer
    parses the name, so it is part of the artifact contract."""
    if output:
        return Path(output)
    test_dataset = Path(test_dataset)
    source = "stain" if "stain" in test_dataset.parent.name.lower() else "original"
    suffix = build_eval_config_string(cfg)
    name = f"{test_dataset.name}_{source}" + (f"_{suffix}" if suffix else "")
    return Path(checkpoint_dir) / "evaluation" / name


def _boundary_metrics_all(preds: list, trues: list, threshold: float) -> list:
    """Per-tile Hausdorff95/ASSD, on host threads from 16 tiles on (scipy's
    EDT releases the GIL); the values are the serial loop's."""
    if len(preds) < 16:
        return [calculate_boundary_metrics(p, t, threshold) for p, t in zip(preds, trues)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda pt: calculate_boundary_metrics(pt[0], pt[1], threshold),
                           zip(preds, trues)))


class PublicationEvaluator:
    def __init__(self, weights: str | Path, cfg: EvalConfig | None = None,
                 model_cfg: UNetConfig | None = None, device="cuda"):
        self.cfg = cfg or EvalConfig()
        self.device = torch.device(device)
        weights_path = ckpt.resolve_weights_path(weights, self.cfg.use_ema_weights)
        self.checkpoint_dir = weights_path.parent
        self.model_cfg = model_cfg or ckpt.detect_model_config(self.checkpoint_dir)
        self.predict_raw, self.params, self.mean, self.std = load_segmenter(
            weights, self.cfg.use_ema_weights, self.device, self.model_cfg)
        self.predict = (make_tta_predict(self.predict_raw, self.cfg.tta_mode)
                        if self.cfg.use_tta else self.predict_raw)
        # The float16 cast runs on the device, so the copy moves half the
        # bytes. Only at the direct-download site: the sliding window
        # quantizes once, on its blended map, so a map is never rounded twice.
        if self.cfg.transfer_dtype == "float16":
            self.predict_transfer = lambda p, t: self.predict(p, t).to(torch.float16)
        else:
            self.predict_transfer = self.predict
        # TTA stacks its views into the forward batch: the tile chunk is
        # divided by the view count so the device batch stays at batch_size.
        tta_mode = self.cfg.tta_mode if self.cfg.tta_mode in MODE_IDS else "basic"
        self.n_views = len(MODE_IDS[tta_mode]) if self.cfg.use_tta else 1
        self.tile_batch = max(1, self.cfg.batch_size // self.n_views)
        # seconds of each stage of the last evaluate(), by the host clock;
        # every stage ends in a copy to the host
        self.timings: dict[str, float] = {}

    # -- inference ------------------------------------------------------------

    def predict_tiles(self, image_paths) -> tuple[list, list]:
        """(images, probability maps), float32 numpy, one per path;
        same-shape tiles batch together on the device."""
        cfg = self.cfg
        images = thread_map(read_image_gray, image_paths)  # cv2 releases the GIL
        preds: list = [None] * len(images)
        if cfg.use_sliding_window:
            sw = SlidingWindowInference(
                tile_size=self.model_cfg.tile_size, overlap=cfg.sliding_overlap,
                blend_mode=cfg.blend_mode, batch_size=self.tile_batch,
                transfer_dtype=cfg.transfer_dtype, device=self.device)
            for i, img in enumerate(images):
                preds[i] = sw.predict(self.predict, self.params, img)
        else:
            by_shape = defaultdict(list)
            for i, img in enumerate(images):
                by_shape[img.shape].append(i)
            b = self.tile_batch
            for idxs in by_shape.values():
                for s in range(0, len(idxs), b):
                    chunk_idx = idxs[s:s + b]
                    batch = np.stack([images[j] for j in chunk_idx])
                    out = predict_batch(self.predict_transfer, self.params, batch, b,
                                        self.device).astype(np.float32)
                    for k, j in enumerate(chunk_idx):
                        preds[j] = out[k]
        if cfg.use_boundary_refinement:
            refiner = BoundaryRefiner(kernel_size=cfg.refine_kernel)
            preds = [refiner.refine(p) for p in preds]
        return images, preds

    # -- full evaluation ------------------------------------------------------

    def evaluate(self, data_root: str | Path, dataset_name: str = "test",
                 output_dir: str | Path | None = None, optimize_threshold: bool | None = None,
                 save_visualizations: bool = False, n_vis_samples: int = 10) -> dict:
        cfg = self.cfg
        timings = self.timings = {}
        clock = time.perf_counter()

        def lap(stage: str) -> None:
            nonlocal clock
            now = time.perf_counter()
            timings[stage] = timings.get(stage, 0.0) + now - clock
            clock = now

        np.random.seed(cfg.eval_seed)  # set_deterministic_seeds(1337) analog
        data_root = Path(data_root)
        out = Path(output_dir) if output_dir else build_output_dir(self.checkpoint_dir,
                                                                   data_root, cfg)
        out.mkdir(parents=True, exist_ok=True)

        pairs = load_validation_data(data_root)
        tile_paths = [p for p, _ in pairs]
        images, preds = self.predict_tiles(tile_paths)
        trues = thread_map(lambda m: (read_image_gray(m) > 127).astype(np.float32),
                           [m for _, m in pairs])
        lap("predict_s")

        do_opt = cfg.optimize_threshold if optimize_threshold is None else optimize_threshold
        if cfg.adaptive_threshold:
            threshold, _ = optimize_threshold_adaptive(preds, trues, tile_paths, self.device)
        elif do_opt:
            threshold, _ = optimize_threshold_f1_slide_level(preds, trues, tile_paths,
                                                             device=self.device)
        else:
            threshold = cfg.threshold
        lap("threshold_s")

        # Per-tile pixel metrics and AUCs on the device, batched per shape
        # group (sliding-window datasets mix image sizes).
        shape_groups = defaultdict(list)
        for i, p in enumerate(preds):
            shape_groups[p.shape].append(i)
        n_tiles = len(preds)
        pm: dict = {}
        am: dict = {}
        for idxs in shape_groups.values():
            pa = torch.from_numpy(np.stack([preds[i] for i in idxs])).to(self.device)
            ta = torch.from_numpy(np.stack([trues[i] for i in idxs])).to(self.device)
            g_pm = {k: v.cpu().numpy() for k, v in batched_pixel_metrics(pa, ta, threshold).items()}
            g_am = batched_auc_metrics(pa, ta)
            for d, g in ((pm, g_pm), (am, g_am)):
                for k, vals in g.items():
                    d.setdefault(k, np.empty(n_tiles, np.float64))[idxs] = vals
        lap("device_metrics_s")
        bms = _boundary_metrics_all(preds, trues, threshold)
        lap("boundary_s")
        tile_rows = []
        for i, path in enumerate(tile_paths):
            tile_rows.append({
                "tile": Path(path).name,
                "slide_id": extract_slide_id(path),
                **{k: float(pm[k][i]) for k in (
                    "dice_score", "jaccard_index", "sensitivity", "specificity",
                    "precision", "f1_score", "accuracy")},
                "roc_auc": float(am["roc_auc"][i]),
                "pr_auc": float(am["pr_auc"][i]),
                **bms[i],
            })

        # Slide-level aggregation (:1629-1727): mean of tile metrics per
        # slide, NaN/inf-filtered for AUC and boundary metrics
        slides = defaultdict(list)
        for row in tile_rows:
            slides[row["slide_id"]].append(row)
        slide_metrics = {k: [] for k in METRIC_KEYS}
        for rows in slides.values():
            for k in METRIC_KEYS:
                vals = np.asarray([r[k] for r in rows], dtype=np.float64)
                if k in ("roc_auc", "pr_auc", "hausdorff95", "assd"):
                    vals = vals[np.isfinite(vals)]
                slide_metrics[k].append(float(np.mean(vals)) if len(vals) else np.nan)

        # Bootstrap CIs over slides (:1730-1745)
        summary = {}
        for k in METRIC_KEYS:
            point, (lo, hi) = safe_bootstrap_ci(np.asarray(slide_metrics[k]),
                                                n_bootstrap=cfg.n_bootstrap, device=self.device)
            summary[k] = {"mean": point, "ci_lower": lo, "ci_upper": hi}
        lap("bootstrap_s")

        results = {
            "dataset": dataset_name,
            "n_slides": len(slides),
            "n_tiles": len(tile_paths),
            "optimal_threshold": float(threshold),
            "metrics": summary,
            "config": asdict(cfg),
        }
        dices = [r["dice_score"] for r in tile_rows]
        if save_visualizations:
            k = n_vis_samples
            results["visualization_buckets"] = save_bucketed_visualizations(
                images[:k], preds[:k], trues[:k], dices[:k], tile_paths[:k],
                out / "visualizations", threshold)
        if cfg.save_overlays:
            # Dice-bucketed 4-panel dumps over a sampled pos/neg tile subset
            # (sample_tiles :1111-1140; overlays loop :1801-1876)
            rng = np.random.RandomState(cfg.eval_seed)
            pos_idx = [i for i, t in enumerate(trues) if t.max() > 0]
            neg_idx = [i for i, t in enumerate(trues) if t.max() == 0]

            def sample(idx, n):
                return idx if len(idx) <= n else list(rng.choice(idx, n, replace=False))

            chosen = sample(pos_idx, cfg.n_positive) + sample(neg_idx, cfg.n_negative)
            results["overlay_buckets"] = save_bucketed_visualizations(
                [images[i] for i in chosen], [preds[i] for i in chosen],
                [trues[i] for i in chosen], [dices[i] for i in chosen],
                [tile_paths[i] for i in chosen], out / "overlays", threshold,
                max_per_bucket=10 ** 9)
        # written after the bucket sections, so metrics.json holds the dict
        # the caller receives
        self._write_artifacts(out, dataset_name, results, tile_rows)
        lap("artifacts_s")
        return results

    def _write_artifacts(self, out: Path, dataset_name: str, results: dict, tile_rows) -> None:
        (out / "metrics.json").write_text(json.dumps(results, indent=2))
        write_csv(out / "predictions.csv", tile_rows)
        rows = []
        for k, name in DISPLAY_NAMES.items():
            m = results["metrics"][k]
            rows.append({
                "Metric": name, "Mean": m["mean"],
                "CI_Lower": m["ci_lower"], "CI_Upper": m["ci_upper"],
                "N_Slides": results["n_slides"], "N_Tiles": results["n_tiles"],
                "Mean_CI": f"{m['mean']:.4f} [{m['ci_lower']:.4f}, {m['ci_upper']:.4f}]",
            })
        write_csv(out / f"{dataset_name}_comprehensive_results.csv", rows)
