"""Classifier evaluation (``adipose_tpu/eval/classifier_eval.py``): TTA,
snapshot ensembling, calibration, threshold sweeps, class statistics, plots
and example dumps.

Behavioral spec: ``Classification/eval_adipose_classifier.py``:
  * deterministic 8-way geometric TTA by transform id (:98-102, :311-322);
  * snapshot ensembling in logit space (:324-336);
  * probability calibration: temperature / Platt / isotonic fit on a
    held-out val split (:339-370);
  * ROC/PR AUC, per-threshold sweep 0.05..0.95 step 0.05 with best-F1 pick,
    confusion matrices at 0.5 and best (:373-416);
  * per-class probability statistics (:419-442);
  * plots and TP/FP/FN/TN example image dumps (:582);
  * optional slide-level aggregation via the slide-base grouping (:554);
  * structured ``evaluation/<testdir>_<suffixes>/`` outputs (:726-752).

Each batch of uint8 tiles is copied to the device once; kernel D makes its
TTA views and kernel P stretches them inside the predict (one forward per
batch). The probabilities come back to the host once per dataset.

Everything after the predict is host numpy, as in the JAX package, without
sklearn, pandas or matplotlib: the calibrators are solved here (an
L2-regularised logistic regression by Newton's method, isotonic regression
by pooling adjacent violators) with sklearn's conventions, the ROC and PR
curves and their areas follow ``sklearn.metrics``, the CSV is written with
``csv`` and the plots are drawn with cv2.
"""

from __future__ import annotations

import csv
import json
import shutil
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from scipy.interpolate import interp1d
from scipy.special import expit

from adipose_tpu_torch.core.host_copy import copy_in_pinned
from adipose_tpu_torch.data.loader import prefetch_batches
from adipose_tpu_torch.eval.tta import make_classifier_tta_predict
from adipose_tpu_torch.train.trainer_classifier import extract_slide_base


def _predict_dataset(predict, variables, dataset, device) -> tuple:
    """(probs, labels) of a ClassificationDataset, trimmed to its length:
    each uint8 batch (the last one padded by repeating its last tile) copied
    to ``device`` while the next one decodes; one copy back at the end."""
    device = torch.device(device)
    probs, labels = [], []
    for imgs, labs in prefetch_batches(dataset.epoch_batches(0, shuffle=False)):
        probs.append(predict(variables, copy_in_pinned(imgs, device)))
        labels.append(labs)
    n = len(dataset)
    return torch.cat(probs).cpu().numpy()[:n], np.concatenate(labels)[:n]


def predict_with_tta(predict_fn, variables, dataset, mode: str = "full",
                     device="cuda") -> tuple:
    """Predict a ClassificationDataset with geometric TTA; returns
    (probs, labels)."""
    return _predict_dataset(make_classifier_tta_predict(predict_fn, mode), variables,
                            dataset, device)


def ensemble_snapshots(prob_list) -> np.ndarray:
    """Logit-space snapshot averaging (``eval_adipose_classifier.py:324-336``)."""
    logits = [np.log(np.clip(p, 1e-7, 1) / np.clip(1 - p, 1e-7, 1)) for p in prob_list]
    return 1.0 / (1.0 + np.exp(-np.mean(logits, axis=0)))


def _to_logit(p: np.ndarray) -> np.ndarray:
    """Stable prob->logit with the reference's 1e-7 odds clip (:334,344)."""
    return np.log(p / np.clip(1.0 - p, 1e-7, 1.0))


# ---- calibration ----------------------------------------------------------------


def _fit_logistic(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """(w, b) minimizing sum_i log(1 + exp(z_i)) - y_i z_i + w^2 / 2, z =
    w x + b: ``LogisticRegression()``'s problem (L2, C = 1, the intercept
    not penalised), solved to its optimum in float64 by Newton's method
    with a backtracking line search (quadratic convergence: a few steps)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if not np.isfinite(x).all():
        # sklearn's input check, which the reference's fit runs first: a
        # probability of exactly 0 has the logit -inf
        raise ValueError("Input X contains infinity or NaN")
    if np.unique(y).size < 2:
        raise ValueError("logistic calibration needs samples of both classes")

    def objective(t):
        z = t[0] * x + t[1]
        return float(np.sum(np.logaddexp(0.0, z) - y * z) + 0.5 * t[0] * t[0])

    theta = np.zeros(2)
    f = objective(theta)
    for _ in range(100):
        p = expit(theta[0] * x + theta[1])
        r, s = p - y, p * (1.0 - p)
        grad = np.array([x @ r + theta[0], r.sum()])
        hess = np.array([[(x * x) @ s + 1.0, x @ s], [x @ s, s.sum()]])
        step = np.linalg.solve(hess, grad)
        t = 1.0
        while True:
            cand = theta - t * step
            f_cand = objective(cand)
            if f_cand <= f - 1e-4 * t * (grad @ step) or t < 1e-10:
                break
            t *= 0.5
        done = np.abs(cand - theta).max() <= 1e-15 * max(1.0, np.abs(theta).max())
        theta, f = cand, min(f, f_cand)
        if done:
            break
    return float(theta[0]), float(theta[1])


def _make_unique(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ties in sorted ``x`` pooled by mean ``y`` (``sklearn._isotonic._make_unique``,
    unit weights): a value within the dtype's resolution of its group's
    first x joins the group; sums in ``x``'s dtype."""
    dt = x.dtype.type
    eps, one = dt(np.finfo(x.dtype).resolution), dt(1)
    xs, ys, ws = [], [], []
    cur_x, cur_y, cur_w = x[0], dt(0), dt(0)
    for xj, yj in zip(x, y):
        if xj - cur_x >= eps:
            xs.append(cur_x)
            ws.append(cur_w)
            ys.append(cur_y / cur_w)
            cur_x, cur_w, cur_y = xj, one, yj * one
        else:
            cur_w += one
            cur_y += yj * one
    xs.append(cur_x)
    ws.append(cur_w)
    ys.append(cur_y / cur_w)
    return np.array(xs, x.dtype), np.array(ys, x.dtype), np.array(ws, x.dtype)


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The non-decreasing fit of ``y`` with weights ``w`` (float64): pool
    adjacent violators, each block the weighted mean of its members."""
    means, weights, counts = [], [], []
    for yi, wi in zip(y.astype(np.float64), w.astype(np.float64)):
        means.append(yi)
        weights.append(wi)
        counts.append(1)
        while len(means) > 1 and means[-2] >= means[-1]:
            m, wt, n = means.pop(), weights.pop(), counts.pop()
            total = weights[-1] + wt
            means[-1] = (weights[-1] * means[-1] + wt * m) / total
            weights[-1] = total
            counts[-1] += n
    return np.repeat(means, counts)


class _Isotonic:
    """``IsotonicRegression(out_of_bounds="clip")`` (increasing): fitted and
    evaluated in the dtype of ``x`` (float32 or float64), as sklearn does."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        y = np.asarray(y).astype(x.dtype)
        order = np.lexsort((y, x))
        ux, uy, uw = _make_unique(x[order], y[order])
        fit = _pava(uy, uw).astype(x.dtype)
        self.dtype, self.x_min, self.x_max = x.dtype, ux.min(), ux.max()
        # drop interior points whose value equals both neighbours'
        keep = np.ones(len(fit), bool)
        keep[1:-1] = (fit[1:-1] != fit[:-2]) | (fit[1:-1] != fit[2:])
        xs, ys = ux[keep], fit[keep]
        if len(ys) == 1:
            self._f = lambda t: ys.repeat(t.shape)
        else:
            self._f = interp1d(xs, ys, kind="linear", bounds_error=False)

    def __call__(self, t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t).astype(self.dtype).reshape(-1), self.x_min, self.x_max)
        return self._f(t).astype(t.dtype)


class Calibrator:
    """Fitted probability calibrator.

    The reference's three methods (``eval_adipose_classifier.py:339-370``):
    a sigmoid refit on logits ("temperature"), a sigmoid refit on raw
    probabilities ("platt"), and isotonic regression. The sigmoid refit is
    sklearn's default ``LogisticRegression`` solved to its optimum
    (:func:`_fit_logistic`); ``info`` holds ``coef`` [[w]] and ``intercept``
    [b], and the calibrated probability is ``sigmoid(w x + b)`` in float64.
    Isotonic is ``IsotonicRegression(out_of_bounds="clip")``: ties pooled
    by mean, interior points trimmed, linear interpolation clipped to the
    fitted range; ``info`` holds ``y_min`` and ``y_max``.
    """

    #: method -> feature map applied to probabilities before the 1-D fit.
    _FEATURES = {"temperature": _to_logit, "platt": lambda p: p}

    def __init__(self, method: str, probs: np.ndarray, labels: np.ndarray):
        self.method = method
        if method in self._FEATURES:
            self._w, self._b = _fit_logistic(self._FEATURES[method](probs), labels)
            self.info = {"coef": [[self._w]], "intercept": [self._b]}
        elif method == "isotonic":
            self._iso = _Isotonic(probs, labels)
            fitted = self(probs)
            self.info = {"y_min": float(fitted.min()), "y_max": float(fitted.max())}
        else:
            raise ValueError(f"unknown calibration method {method!r}")

    def __call__(self, probs: np.ndarray) -> np.ndarray:
        if self.method in self._FEATURES:
            feat = np.asarray(self._FEATURES[self.method](probs)).reshape(-1)
            return expit(feat.astype(np.float64) * self._w + self._b)
        return self._iso(probs)


def fit_calibrator(probs: np.ndarray, labels: np.ndarray, method: str) -> Calibrator:
    """Fit a :class:`Calibrator` (behavior of :339-370)."""
    return Calibrator(method, probs, labels)


def apply_calibrator(probs: np.ndarray, calibrator: Calibrator | None):
    """Identity when ``calibrator`` is None (:360-362)."""
    return probs if calibrator is None else calibrator(probs)


# ---- curves and scores ---------------------------------------------------------


def _binary_clf_curve(labels: np.ndarray, probs: np.ndarray) -> tuple:
    """(fps, tps, thresholds) at each distinct score, descending, float64
    counts (``sklearn.metrics.confusion_matrix_at_thresholds``)."""
    y = (np.asarray(labels).reshape(-1) == 1).astype(np.float64)
    s = np.asarray(probs).reshape(-1)
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, s[idx]


def roc_curve(labels: np.ndarray, probs: np.ndarray, drop_intermediate: bool = True) -> tuple:
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve``: collinear
    interior points dropped, a first point (0, 0) at threshold inf; NaN
    rates when a class is absent."""
    fps, tps, thr = _binary_clf_curve(labels, probs)
    if drop_intermediate and fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def precision_recall_curve(labels: np.ndarray, probs: np.ndarray) -> tuple:
    """(precision, recall, thresholds) as
    ``sklearn.metrics.precision_recall_curve``: ascending thresholds, a last
    point (recall 0, precision 1); recall 1 throughout without positives."""
    fps, tps, thr = _binary_clf_curve(labels, probs)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def roc_auc_score(labels: np.ndarray, probs: np.ndarray) -> float:
    """The trapezoidal area under :func:`roc_curve`; NaN with one class,
    as ``sklearn.metrics.roc_auc_score``."""
    if np.unique(labels).size != 2:
        warnings.warn("Only one class is present in labels: ROC AUC is not defined")
        return float("nan")
    fpr, tpr, _ = roc_curve(labels, probs)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())  # trapezoids


def average_precision_score(labels: np.ndarray, probs: np.ndarray) -> float:
    """sum_n (R_n - R_{n-1}) P_n over :func:`precision_recall_curve`, as
    ``sklearn.metrics.average_precision_score``."""
    precision, recall, _ = precision_recall_curve(labels, probs)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _confusion_sweep(labels: np.ndarray, probs: np.ndarray, thresholds: np.ndarray) -> dict:
    """Confusion counts + P/R/F1 for ALL thresholds in one vectorized pass.

    Returns arrays keyed tn/fp/fn/tp/precision/recall/f1, each shaped like
    ``thresholds``. sklearn ``zero_division=0`` semantics: an empty
    denominator yields 0.
    """
    pos = labels.astype(bool)
    pred = probs[None, :] >= np.asarray(thresholds).reshape(-1, 1)  # (T, N)
    tp = (pred & pos).sum(axis=1).astype(float)
    fp = (pred & ~pos).sum(axis=1).astype(float)
    fn = (~pred & pos).sum(axis=1).astype(float)
    tn = (~pred & ~pos).sum(axis=1).astype(float)
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(2 * tp + fp + fn > 0, 2 * tp / (2 * tp + fp + fn), 0.0)
    return {"tn": tn, "fp": fp, "fn": fn, "tp": tp,
            "precision": precision, "recall": recall, "f1": f1}


def evaluate_predictions(labels: np.ndarray, probs: np.ndarray) -> dict:
    """AUCs + 0.05..0.95 threshold sweep + confusion summaries.

    The reference's metrics.json contract (``eval_adipose_classifier.py:373-416``):
    ``roc_auc``/``pr_auc``, ``threshold_metrics.{default_0.5,best_f1,
    per_threshold}``, ``best_threshold``; first-maximum F1 tie-break;
    specificity with the reference's ``+1e-7`` denominator guard.
    """
    grid = np.linspace(0.05, 0.95, 19)
    sweep = _confusion_sweep(labels, probs, grid)
    best_idx = int(np.argmax(sweep["f1"]))  # first maximum, like the reference

    def summarize(s, i, thresh) -> dict:
        tn, fp = s["tn"][i], s["fp"][i]
        return {
            "threshold": float(thresh),
            "confusion_matrix": {k: int(s[k][i]) for k in ("tn", "fp", "fn", "tp")},
            "precision": float(s["precision"][i]),
            "recall": float(s["recall"][i]),
            "f1": float(s["f1"][i]),
            "specificity": float(tn / (tn + fp + 1e-7)),
        }

    # default_0.5 needs its own pass: grid[9] is 0.4999...94, not exactly 0.5
    half = _confusion_sweep(labels, probs, np.array([0.5]))
    return {
        "roc_auc": roc_auc_score(labels, probs),
        "pr_auc": average_precision_score(labels, probs),
        "threshold_metrics": {
            "default_0.5": summarize(half, 0, 0.5),
            "best_f1": summarize(sweep, best_idx, grid[best_idx]),
            "per_threshold": [
                {"threshold": float(t),
                 "precision": float(sweep["precision"][i]),
                 "recall": float(sweep["recall"][i]),
                 "f1": float(sweep["f1"][i])}
                for i, t in enumerate(grid)
            ],
        },
        "best_threshold": float(grid[best_idx]),
    }


def compute_class_statistics(labels: np.ndarray, probs: np.ndarray) -> dict:
    """(:419-442)."""
    out = {}
    for name, mask in (("adipose", labels == 1), ("not_adipose", labels == 0)):
        p = probs[mask]
        out[name] = {
            "count": int(mask.sum()),
            "mean_prob": float(p.mean()) if mask.any() else 0.0,
            "std_prob": float(p.std()) if mask.any() else 0.0,
            "median_prob": float(np.median(p)) if mask.any() else 0.0,
            "min_prob": float(p.min()) if mask.any() else 0.0,
            "max_prob": float(p.max()) if mask.any() else 0.0,
        }
    return out


def aggregate_by_slide(files, labels: np.ndarray, probs: np.ndarray,
                       slide_map: dict | None = None) -> dict:
    """Slide-level probability summary (:554-585).

    ``slide_map``: optional tile-stem -> slide-id mapping (the ``--slide-map``
    CSV, columns ``tile,slide_id``); tiles absent from the map are skipped,
    matching the reference. Without a map, slide ids are inferred from the
    filename.
    """
    groups: dict = {}
    for f, lab, p in zip(files, labels, probs):
        if slide_map is not None:
            slide = slide_map.get(Path(str(f)).stem)
            if slide is None:
                continue
        else:
            slide = extract_slide_base(str(f))
        groups.setdefault(slide, []).append((lab, p))
    out = {}
    for slide, items in groups.items():
        labs = np.array([l for l, _ in items])  # noqa: E741
        ps = np.array([p for _, p in items])
        out[slide] = {
            "n_tiles": len(items),
            "mean_prob": float(ps.mean()),
            "median_prob": float(np.median(ps)),
            "frac_positive_tiles": float(labs.mean()),
        }
    return out


def dump_examples(files, labels, probs, threshold: float, output_dir: Path,
                  max_per_category: int = 20, percentile_norm: bool = False,
                  p_low: float = 1.0, p_high: float = 99.0):
    """TP/FP/FN/TN example-image dumps (:582). ``percentile_norm`` renders
    the 1-99 percentile-normalized view instead of copying the raw tile
    (``--percentile-norm-examples``, eval_adipose_classifier.py:151)."""
    import cv2

    output_dir = Path(output_dir)
    preds = (probs >= threshold).astype(int)
    counts = {"TP": 0, "FP": 0, "FN": 0, "TN": 0}
    for f, lab, pr in zip(files, labels.astype(int), preds):
        cat = ("TP" if lab and pr else "FP" if pr else "FN" if lab else "TN")
        if counts[cat] >= max_per_category:
            continue
        d = output_dir / "examples" / cat
        d.mkdir(parents=True, exist_ok=True)
        if percentile_norm:
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            lo, hi = np.percentile(img, p_low), np.percentile(img, p_high)
            normed = np.clip((img - lo) / max(hi - lo, 1e-3), 0, 1) * 255
            cv2.imwrite(str(d / Path(f).name), normed.astype(np.uint8))
        else:
            shutil.copy2(f, d / Path(f).name)
        counts[cat] += 1
    return counts


# ---- plots ----------------------------------------------------------------------

# A 6.4 x 4.8 inch figure at 120 dpi, as the JAX package saves it.
_W, _H, _L, _R, _T, _B = 768, 576, 80, 24, 44, 64
_COLORS = ((180, 119, 31), (14, 127, 255), (44, 160, 44))  # BGR: blue, orange, green


class _Axes:
    """A blank chart with [x0, x1] x [y0, y1] data limits, axes, ticks,
    labels and a title; ``px`` maps data to pixels."""

    def __init__(self, xlim, ylim, xlabel: str, ylabel: str, title: str = ""):
        import cv2

        self.img = np.full((_H, _W, 3), 255, np.uint8)
        self.xlim, self.ylim = xlim, ylim
        font, black = cv2.FONT_HERSHEY_SIMPLEX, (0, 0, 0)
        cv2.rectangle(self.img, (_L, _T), (_W - _R, _H - _B), black, 1)
        for k in range(6):
            fx, fy = xlim[0] + (xlim[1] - xlim[0]) * k / 5, ylim[0] + (ylim[1] - ylim[0]) * k / 5
            px, py = self.px(fx, fy)
            cv2.line(self.img, (px, _H - _B), (px, _H - _B + 5), black, 1)
            cv2.putText(self.img, f"{fx:.3g}", (px - 12, _H - _B + 20), font, 0.4, black, 1,
                        cv2.LINE_AA)
            cv2.line(self.img, (_L - 5, py), (_L, py), black, 1)
            cv2.putText(self.img, f"{fy:.3g}", (_L - 48, py + 4), font, 0.4, black, 1,
                        cv2.LINE_AA)
        cv2.putText(self.img, xlabel, (_W // 2 - 40, _H - 18), font, 0.5, black, 1, cv2.LINE_AA)
        cv2.putText(self.img, ylabel, (6, _T - 12), font, 0.5, black, 1, cv2.LINE_AA)
        cv2.putText(self.img, title, (_W // 2 - 40, 24), font, 0.6, black, 1, cv2.LINE_AA)

    def px(self, x: float, y: float) -> tuple[int, int]:
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        fx = (x - x0) / (x1 - x0) if x1 > x0 else 0.5
        fy = (y - y0) / (y1 - y0) if y1 > y0 else 0.5
        return int(round(_L + fx * (_W - _R - _L))), int(round(_H - _B - fy * (_H - _B - _T)))

    def line(self, xs, ys, color, dashed: bool = False, markers: bool = False) -> None:
        """A polyline through the finite points; a NaN breaks it."""
        import cv2

        pts = [self.px(x, y) if np.isfinite(x) and np.isfinite(y) else None
               for x, y in zip(xs, ys)]
        for i, (a, b) in enumerate(zip(pts[:-1], pts[1:])):
            if a is not None and b is not None and not (dashed and i % 2):
                cv2.line(self.img, a, b, color, 2, cv2.LINE_AA)
        if markers:
            for p in pts:
                if p is not None:
                    cv2.circle(self.img, p, 4, color, -1, cv2.LINE_AA)

    def bars(self, edges, heights, color) -> None:
        """Histogram bars, blended at 0.6 opacity over what is drawn."""
        import cv2

        layer = self.img.copy()
        for lo, hi, h in zip(edges[:-1], edges[1:], heights):
            if h > 0:
                cv2.rectangle(layer, self.px(lo, h), self.px(hi, self.ylim[0]), color, -1)
        self.img = cv2.addWeighted(layer, 0.6, self.img, 0.4, 0)

    def legend(self, names) -> None:
        import cv2

        for i, name in enumerate(names):
            y = _T + 20 + 20 * i
            cv2.rectangle(self.img, (_W - _R - 140, y - 10), (_W - _R - 124, y), _COLORS[i], -1)
            cv2.putText(self.img, name, (_W - _R - 118, y), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                        (0, 0, 0), 1, cv2.LINE_AA)

    def save(self, path: Path) -> None:
        import cv2

        cv2.imwrite(str(path), self.img)


def save_plots(labels: np.ndarray, probs: np.ndarray, output_dir: Path):
    """ROC / PR / calibration / probability-histogram plots:
    ``roc_curve.png``, ``pr_curve.png``, ``calibration.png``,
    ``probability_histogram.png``."""
    output_dir = Path(output_dir)
    diagonal = ([0, 1], [0, 1])
    fpr, tpr, _ = roc_curve(labels, probs)
    ax = _Axes((0, 1), (0, 1), "FPR", "TPR", "ROC")
    ax.line(fpr, tpr, _COLORS[0])
    ax.line(*diagonal, _COLORS[1], dashed=True)
    ax.save(output_dir / "roc_curve.png")

    prec, rec, _ = precision_recall_curve(labels, probs)
    ax = _Axes((0, 1), (0, 1.05), "Recall", "Precision", "PR")
    ax.line(rec, prec, _COLORS[0])
    ax.save(output_dir / "pr_curve.png")

    bins = np.linspace(0, 1, 11)
    centers = (bins[:-1] + bins[1:]) / 2
    frac = [labels[(probs >= lo) & (probs < hi)].mean()
            if ((probs >= lo) & (probs < hi)).any() else np.nan
            for lo, hi in zip(bins[:-1], bins[1:])]
    ax = _Axes((0, 1), (0, 1), "Predicted prob", "Observed freq", "Calibration")
    ax.line(centers, frac, _COLORS[0], markers=True)
    ax.line(*diagonal, _COLORS[1], dashed=True)
    ax.save(output_dir / "calibration.png")

    hists = [np.histogram(probs[labels == c], bins=30) if (labels == c).any() else None
             for c in (1, 0)]
    top = max([h[0].max() for h in hists if h is not None] + [1])
    lo = min([h[1][0] for h in hists if h is not None] + [0.0])
    hi = max([h[1][-1] for h in hists if h is not None] + [1.0])
    ax = _Axes((lo, hi), (0, top * 1.05), "Probability", "Count")
    for i, h in enumerate(hists):
        if h is not None:
            ax.bars(h[1], h[0], _COLORS[i])
    ax.legend(["adipose", "not_adipose"])
    ax.save(output_dir / "probability_histogram.png")


def _write_predictions_csv(path: Path, files, labels: np.ndarray, probs: np.ndarray) -> None:
    """``file,label,probability``; each probability as the shortest decimal
    that reads back to its own float type."""
    with path.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["file", "label", "probability"])
        for name, lab, p in zip(files, labels.astype(int), probs):
            writer.writerow([str(name), int(lab), str(p)])


def run_classifier_evaluation(
    predict_fn,
    variables_list,
    dataset,
    output_dir: str | Path,
    tta_mode: str = "full",
    use_tta: bool = True,
    calibration: str | None = None,
    calibration_split: float = 0.3,
    calibration_dataset=None,
    save_examples: bool = True,
    num_examples: int = 20,
    slide_aggregate: bool = True,
    slide_map: dict | None = None,
    plots: bool = True,
    percentile_norm_examples: bool = False,
    example_p_low: float = 1.0,
    example_p_high: float = 99.0,
    seed: int = 865,
    device="cuda",
    timings: dict | None = None,
) -> dict:
    """Full evaluation driver. ``variables_list``: one or more model
    snapshots on ``device`` (>1 => logit-space ensembling).

    Calibration: with ``calibration_dataset`` (the reference flow,
    ``eval_adipose_classifier.py:790-814``), the calibrator is fit on that
    held-out set with the identical TTA+ensemble pipeline and the FULL test
    set is evaluated calibrated. Without one, an internal
    ``calibration_split`` of the test set drawn by
    ``np.random.RandomState(seed)`` (the JAX package's extension; the
    reference errors out instead).

    ``timings``, when given, receives the seconds of each stage by the host
    clock: predict_s (decode, upload, predict, copy back; the calibration
    set's too), calibration_s, metrics_s, plots_s, examples_s, csv_s.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    predict = make_classifier_tta_predict(predict_fn, tta_mode) if use_tta else predict_fn
    timings = {} if timings is None else timings
    clock = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        timings[stage] = timings.get(stage, 0.0) + now - clock
        clock = now

    def collect(ds):
        prob_list, labels = [], None
        for variables in variables_list:
            probs, labels = _predict_dataset(predict, variables, ds, device)
            prob_list.append(probs)
        return (ensemble_snapshots(prob_list) if len(prob_list) > 1 else prob_list[0]), labels

    probs, labels = collect(dataset)
    cal_probs, cal_labels = (collect(calibration_dataset)
                             if calibration and calibration_dataset is not None else (None, None))
    lap("predict_s")

    calibrator_info = None
    if cal_probs is not None:
        calibrator = fit_calibrator(cal_probs, cal_labels, calibration)
        cal_applied = apply_calibrator(cal_probs, calibrator)
        calibrator_info = {
            "method": calibrator.method, "info": calibrator.info,
            "val_calibrated_auc": roc_auc_score(cal_labels, cal_applied),
            "val_calibrated_pr_auc": average_precision_score(cal_labels, cal_applied),
        }
        probs_eval = apply_calibrator(probs, calibrator)
        labels_eval, files_eval = labels, list(dataset.files)
    elif calibration:
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(probs))
        n_cal = int(len(probs) * calibration_split)
        cal_idx, eval_idx = idx[:n_cal], idx[n_cal:]
        calibrator = fit_calibrator(probs[cal_idx], labels[cal_idx], calibration)
        calibrator_info = {"method": calibrator.method, "info": calibrator.info}
        probs_eval = apply_calibrator(probs[eval_idx], calibrator)
        labels_eval = labels[eval_idx]
        files_eval = [dataset.files[i] for i in eval_idx]
    else:
        probs_eval, labels_eval, files_eval = probs, labels, list(dataset.files)
    lap("calibration_s")

    results = evaluate_predictions(labels_eval, probs_eval)
    results["class_statistics"] = compute_class_statistics(labels_eval, probs_eval)
    results["calibration"] = calibrator_info
    if slide_aggregate:
        results["slide_level"] = aggregate_by_slide(files_eval, labels_eval, probs_eval,
                                                    slide_map)
    lap("metrics_s")
    if plots:
        save_plots(labels_eval, probs_eval, output_dir)
    lap("plots_s")
    if save_examples:
        results["example_counts"] = dump_examples(
            files_eval, labels_eval, probs_eval, results["best_threshold"], output_dir,
            max_per_category=num_examples, percentile_norm=percentile_norm_examples,
            p_low=example_p_low, p_high=example_p_high)
    lap("examples_s")
    _write_predictions_csv(output_dir / "predictions.csv", files_eval, labels_eval, probs_eval)
    (output_dir / "metrics.json").write_text(json.dumps(results, indent=2, default=float))
    lap("csv_s")
    return results
