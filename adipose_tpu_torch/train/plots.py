"""Training-history plot and per-epoch deltas: the port's copy of
``adipose_tpu/train/plots.py``, with the CSV logs read by ``csv`` and the
figure drawn by :mod:`adipose_tpu_torch.core.charts` (no pandas or
matplotlib on the card's machine).

Behavioral spec: ``src/utils/model.py:155-218`` (``KerasHistoryPlotCallback``
grid of per-metric train/val curves; ``KerasSimpleLoggerCallback`` per-epoch
metric deltas). The plot renders from the persisted CSV logs
(phase{1,2}_training.log), so it also works post hoc on any checkpoint dir.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

from adipose_tpu_torch.core.charts import Figure

_NOT_PLOTTED = ("epoch", "phase", "global_epoch", "epoch_time_s", "lr")


def _number(text: str) -> float:
    try:
        return float(text)
    except (TypeError, ValueError):
        return math.nan


def _read_log(path: Path, phase: int) -> tuple[list[str], list[dict]]:
    """(header + ``phase``, rows of floats) of one CSV log."""
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        rows = [{k: _number(v) for k, v in row.items()} | {"phase": phase} for row in reader]
        return [*(reader.fieldnames or []), "phase"], rows


def training_history(ckpt_dir: str | Path) -> tuple[list[str], list[dict]]:
    """(columns, rows) of the phase logs concatenated as the JAX package's
    ``pd.concat`` does: columns in first-seen order, ``phase`` and then
    ``global_epoch`` last, a missing cell NaN. Raises FileNotFoundError
    when the directory holds no log."""
    ckpt_dir = Path(ckpt_dir)
    frames = [_read_log(f, phase) for phase in (1, 2)
              if (f := ckpt_dir / f"phase{phase}_training.log").exists()]
    single = ckpt_dir / "training.log"
    if not frames and single.exists():
        frames = [_read_log(single, 1)]
    if not frames:
        raise FileNotFoundError(f"no training logs in {ckpt_dir}")
    columns: list[str] = []
    for header, _ in frames:
        columns += [k for k in header if k not in columns]
    rows = [{k: r.get(k, math.nan) for k in columns} for _, frame in frames for r in frame]
    for i, r in enumerate(rows):
        r["global_epoch"] = i
    return columns + ["global_epoch"], rows


def plot_training_history(ckpt_dir: str | Path, output: str | Path | None = None) -> Path:
    """Render train/val curves for every metric in the phase CSV logs: one
    panel a metric (TR and, where logged, VL; a dashed line at the phase
    boundary), ``min(3, n)`` columns; ``training_history.png`` by default."""
    ckpt_dir = Path(ckpt_dir)
    columns, rows = training_history(ckpt_dir)
    metrics = [c for c in columns if c not in _NOT_PLOTTED and not c.startswith("val_")]
    ncol = min(3, max(1, len(metrics)))
    nrow = max(1, math.ceil(len(metrics) / ncol))
    fig = Figure(4 * ncol, 3 * nrow, 120, nrow, ncol)
    epochs = np.array([r["global_epoch"] for r in rows], np.float64)
    phases = np.array([r["phase"] for r in rows])
    p1_len = int((phases == 1).sum())
    for idx, metric in enumerate(metrics):
        series = [np.array([r[metric] for r in rows], np.float64)]
        val = f"val_{metric}"
        if val in columns:
            series.append(np.array([r[val] for r in rows], np.float64))
        finite = np.concatenate(series)
        finite = finite[np.isfinite(finite)]
        lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
        pad = (hi - lo) * 0.05 or 0.5
        ax = fig.panel(idx // ncol, idx % ncol).axes(
            (0, max(1, len(rows) - 1)), (lo - pad, hi + pad), title=metric)
        for s, label, col in zip(series, ("TR", "VL"), (0, 1)):
            ax.line(epochs, s, col, label=label)
        if (phases == 2).any():
            ax.vline(p1_len - 0.5)
        ax.legend()
    out = Path(output) if output else ckpt_dir / "training_history.png"
    return fig.save(out)


def log_epoch_deltas(history: list) -> list:
    """Per-epoch metric deltas (``KerasSimpleLoggerCallback`` :200-218) as
    printable lines."""
    lines = []
    prev = None
    for row in history:
        if prev is None:
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    lines.append(f"{k:>20}: {v:15.4f}")
        else:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k in prev:
                    diff = v - prev[k]
                    sign = "+" if diff > 0 else "-"
                    lines.append(f"{k:>20}: {v:15.4f} {sign:>5} {abs(diff):15.4f}")
        prev = row
    return lines
