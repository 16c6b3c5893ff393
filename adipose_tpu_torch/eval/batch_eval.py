"""Batch checkpoint evaluation and the comparison chart
(``adipose_tpu/eval/batch_eval.py``).

Behavioral spec:
  * ``Segmentation/evaluate_all_checkpoints.py``: discovers
    ``checkpoints/**/*adipose*`` run dirs, evaluates each (in-process here,
    no subprocess), records per-checkpoint successes and failures and writes
    ``batch_evaluation_summary.json``;
  * ``Segmentation/visualize_checkpoint_metrics.py``: parses each
    checkpoint's ``*_comprehensive_results.csv``, bar chart with CI whiskers,
    eval-config suffix matching (:646 ``build_eval_config_string``).

The CSVs are read with the ``csv`` module and the chart is drawn with cv2, so
neither pandas nor matplotlib is needed.
"""

from __future__ import annotations

import csv
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np

from adipose_tpu_torch.core.config import EvalConfig


def discover_checkpoints(root: str | Path, pattern: str = "*adipose*"):
    """Run dirs under <root> matching the pattern that hold
    ``normalization_stats.json``, sorted by name, the newest first
    (``evaluate_all_checkpoints.py:72-130`` semantics)."""
    root = Path(root)
    if not root.exists():
        return []
    found = [d for d in root.rglob(pattern) if d.is_dir()
             and (d / "normalization_stats.json").exists()]
    return sorted(found, key=lambda d: d.name, reverse=True)


def build_eval_config_string(cfg: EvalConfig) -> str:
    """Flag-suffix encoding shared by the evaluator's output dirs and the
    metrics visualizer (``visualize_checkpoint_metrics.py:646``)."""
    parts = []
    if cfg.use_ema_weights:
        parts.append("ema")
    if cfg.use_tta:
        parts.append(f"tta_{cfg.tta_mode}")
    if cfg.use_sliding_window:
        sw = f"sw_{cfg.blend_mode}"
        if cfg.sliding_overlap != 0.5:
            sw += f"_o{int(cfg.sliding_overlap * 100)}"
        parts.append(sw)
    if cfg.use_boundary_refinement:
        parts.append("refine" if cfg.refine_kernel == 5 else f"refine{cfg.refine_kernel}")
    if cfg.adaptive_threshold:
        parts.append("adaptive")
    return "_".join(parts)


class CheckpointBatchEvaluator:
    """In-process batch evaluation with per-checkpoint failure records and a
    wall-clock budget per run (replacing the reference's subprocess timeout)."""

    def __init__(self, checkpoints_root: str | Path, data_root: str | Path,
                 cfg: EvalConfig | None = None, timeout_s: float = 3600.0,
                 save_images: bool = False, parallel: bool = False,
                 max_workers: int = 2, device="cuda"):
        self.checkpoints_root = Path(checkpoints_root)
        self.data_root = Path(data_root)
        self.cfg = cfg or EvalConfig()
        self.timeout_s = timeout_s
        self.save_images = save_images
        self.parallel = parallel  # --parallel/--max-workers (:560-565)
        self.max_workers = max_workers
        self.device = device
        self.records: list = []

    def _eval_one(self, run_dir, dataset_name: str) -> dict:
        from adipose_tpu_torch.eval.evaluator import PublicationEvaluator

        rec = {"checkpoint": str(run_dir), "status": "pending"}
        t0 = time.time()
        try:
            ev = PublicationEvaluator(run_dir, self.cfg, device=self.device)
            results = ev.evaluate(self.data_root, dataset_name,
                                  save_visualizations=self.save_images)
            rec.update(status="success", elapsed_s=time.time() - t0,
                       dice=results["metrics"]["dice_score"]["mean"],
                       threshold=results["optimal_threshold"])
        except Exception as e:
            rec.update(status="failed", elapsed_s=time.time() - t0,
                       error=str(e), traceback=traceback.format_exc())
        if time.time() - t0 > self.timeout_s:
            rec["timed_out"] = True
        return rec

    def run(self, dataset_name: str = "test") -> list:
        run_dirs = discover_checkpoints(self.checkpoints_root)
        if self.parallel and len(run_dirs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                self.records.extend(pool.map(lambda d: self._eval_one(d, dataset_name),
                                             run_dirs))
        else:
            for run_dir in run_dirs:
                self.records.append(self._eval_one(run_dir, dataset_name))
        summary_path = self.checkpoints_root / "batch_evaluation_summary.json"
        summary_path.write_text(json.dumps(self.records, indent=2, default=str))
        return self.records


def _cell(text: str):
    """A CSV field as pandas reads it: int, float, NaN for an empty field,
    else the string."""
    if text == "":
        return math.nan
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def collect_checkpoint_metrics(checkpoints_root: str | Path,
                               cfg: EvalConfig | None = None) -> list[dict]:
    """The rows of the per-checkpoint ``*_comprehensive_results.csv`` files
    whose eval-dir suffix matches the config, each with its CSV columns plus
    ``checkpoint`` and ``eval_dir`` (``visualize_checkpoint_metrics.py:125-440``)."""
    cfg = cfg or EvalConfig()
    suffix = build_eval_config_string(cfg)
    rows = []
    for run_dir in discover_checkpoints(checkpoints_root):
        eval_root = run_dir / "evaluation"
        if not eval_root.exists():
            continue
        for eval_dir in eval_root.iterdir():
            if suffix and not eval_dir.name.endswith(suffix):
                continue
            if not suffix and any(tok in eval_dir.name
                                  for tok in ("ema", "tta", "sw_", "refine", "adaptive")):
                continue
            for path in eval_dir.glob("*_comprehensive_results.csv"):
                with path.open(newline="") as f:
                    for row in csv.DictReader(f):
                        rows.append({k: _cell(v) for k, v in row.items()}
                                    | {"checkpoint": run_dir.name, "eval_dir": eval_dir.name})
    return rows


# Chart geometry in pixels: a figure of max(6, 1.2 n) x 4 inches at 120 dpi.
_DPI, _MARGIN_L, _MARGIN_R, _MARGIN_T, _MARGIN_B = 120, 80, 20, 40, 110
_BLACK, _GREY, _BAR = (0, 0, 0), (200, 200, 200), (180, 119, 31)  # BGR


def plot_checkpoint_comparison(rows: list[dict], output_path: str | Path,
                               metric: str = "Dice Score"):
    """Bar chart of ``metric``'s mean per checkpoint row with 95% CI
    whiskers (``visualize_checkpoint_metrics.py:445-640``); None when no row
    has the metric."""
    import cv2

    sel = [r for r in rows if r.get("Metric") == metric]
    if not sel:
        return None
    width, height = int(max(6, len(sel) * 1.2) * _DPI), 4 * _DPI
    img = np.full((height, width, 3), 255, np.uint8)
    x0, x1, y0, y1 = _MARGIN_L, width - _MARGIN_R, _MARGIN_T, height - _MARGIN_B
    means = np.array([float(r["Mean"]) for r in sel])
    lo = np.array([float(r["CI_Lower"]) for r in sel])
    hi = np.array([float(r["CI_Upper"]) for r in sel])
    finite = np.concatenate([means, lo, hi])
    finite = finite[np.isfinite(finite)]
    top = max(float(finite.max()) if finite.size else 1.0, 1e-9) * 1.05
    to_y = lambda v: int(round(y1 - (y1 - y0) * min(max(v, 0.0), top) / top))  # noqa: E731

    font = cv2.FONT_HERSHEY_SIMPLEX
    for k in range(5):  # y grid and tick labels
        v = top * k / 4
        cv2.line(img, (x0, to_y(v)), (x1, to_y(v)), _GREY, 1)
        cv2.putText(img, f"{v:.3g}", (8, to_y(v) + 4), font, 0.4, _BLACK, 1, cv2.LINE_AA)
    slot = (x1 - x0) / len(sel)
    for i, (r, m, a, b) in enumerate(zip(sel, means, lo, hi)):
        cx = int(x0 + slot * (i + 0.5))
        half = int(slot * 0.4)
        if math.isfinite(m):
            cv2.rectangle(img, (cx - half, to_y(m)), (cx + half, y1), _BAR, -1)
        if math.isfinite(a) and math.isfinite(b):  # whisker with caps
            cv2.line(img, (cx, to_y(a)), (cx, to_y(b)), _BLACK, 1)
            for v in (a, b):
                cv2.line(img, (cx - 6, to_y(v)), (cx + 6, to_y(v)), _BLACK, 1)
        label = str(r["checkpoint"])[-28:]
        cv2.putText(img, label, (cx - half, y1 + 16 + 14 * (i % 2)), font, 0.35, _BLACK, 1,
                    cv2.LINE_AA)
    cv2.line(img, (x0, y0), (x0, y1), _BLACK, 1)
    cv2.line(img, (x0, y1), (x1, y1), _BLACK, 1)
    cv2.putText(img, f"{metric} across checkpoints (95% CI)", (x0, 24), font, 0.55, _BLACK, 1,
                cv2.LINE_AA)
    cv2.imwrite(str(output_path), img)
    return output_path
