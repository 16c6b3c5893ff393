"""Checkpoint artifacts, with the JAX package's contract.

A checkpoint directory keeps the reference's layout
(``adipose_tpu/train/checkpoint.py``)::

  checkpoints/segmentation/<timestamp>_<name>_1024_finetune_v3/
    normalization_stats.json     train-set mean/std
    phase1_best/ phase2_best/    best params of each phase
    weights_best_overall/        the final model (phase-2 best)
    weights_ema/                 the best EMA snapshot
    phase{1,2}_training.log      per-epoch CSV metrics
    training_settings.log        hyperparameters and system capture

and the classifier's (``adipose_tpu/train/trainer_classifier.py``)::

  checkpoints/classifier_runs/<timestamp>_classifier_adipose_sybreosin[_percentile]<suffix>/
    config.json                  hyperparameters and the class weights
    training.log                 per-epoch CSV: loss, acc, val_auc, val_acc,
                                 lr, epoch_time_s (the last phase's rows)
    weights_best/                the best val AUC of the phase in progress
    weights_final/               the final model (phase-2 best)

The JAX package writes each weights entry as an orbax checkpoint; the port
writes and reads ``params.npz`` in the same directory, the Flax param tree as
numpy, which ``scripts/export_flax_params_npz.py`` writes from the orbax
files. So a run trained by the port is served by ``adipose-torch segment``
and its tree loads into the JAX package's ``DilatedUNet``.
"""

from __future__ import annotations

import datetime
import json
import platform
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.core.config import UNetConfig
from adipose_tpu_torch.models.convert import load_flax_npz, save_flax_npz

PARAMS_NPZ = "params.npz"
EXPORT_SCRIPT = "scripts/export_flax_params_npz.py"

# Ordered weight-resolution candidates, as in the JAX package.
WEIGHT_CANDIDATES_BEST = (
    "weights_best_overall",
    "phase2_best",
    "phase1_best",
    "best_model",
    "model_best",
    "weights_best",
)
WEIGHT_CANDIDATES_EMA = (
    "weights_ema",
    "ema_weights_phase2",
    "ema_weights",
)

_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def timestamp_now() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def checkpoint_dir_for(checkpoint_name: str, build_timestamp: str | None = None,
                       root: str | Path = "checkpoints/segmentation",
                       suffix: str = "_1024_finetune_v3") -> Path:
    """Timestamped run directory (``train_adipose_unet_v3.py:645-652``)."""
    d = Path(root) / f"{build_timestamp or timestamp_now()}_{checkpoint_name}{suffix}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def classifier_dir_for(root: str | Path, percentile_norm: bool, suffix: str = "",
                       timestamp: str | None = None) -> Path:
    """Timestamped classifier run directory, as the JAX trainer names it
    (``timestamp`` defaults to now)."""
    norm = "_percentile" if percentile_norm else ""
    d = Path(root) / f"{timestamp or timestamp_now()}_classifier_adipose_sybreosin{norm}{suffix}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def merge_matching(dst: dict, src: dict) -> dict:
    """By-name tree merge: take ``src`` leaves whose path and shape match
    ``dst``; everything else keeps ``dst`` (the reference's by_name +
    skip_mismatch loading, ``train_adipose_unet_v3.py:881-916``)."""
    if isinstance(dst, dict) and isinstance(src, dict):
        return {k: merge_matching(v, src[k]) if k in src else v for k, v in dst.items()}
    if np.shape(dst) == np.shape(src) and not isinstance(src, dict):
        return np.asarray(src)
    return dst  # shape mismatch / extra leaf: keep the fresh init


def _git_info() -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                timeout=5).stdout.strip()
        dirty = bool(subprocess.run(["git", "status", "--porcelain"], capture_output=True,
                                    text=True, timeout=5).stdout.strip())
        return {"commit": commit, "dirty": dirty}
    except (OSError, subprocess.SubprocessError):
        return {"commit": "unknown", "dirty": False}


def write_training_settings(ckpt_dir: str | Path, settings: dict) -> None:
    """``training_settings.log`` with a platform, device and git capture
    (``train_adipose_unet_v3.py:927-1053``); its ``use_deep_supervision:``
    and ``init_nb:`` lines are what :func:`detect_model_config` reads."""
    if torch.cuda.is_available():
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    lines = ["=== adipose_tpu training settings ===", ""]
    lines += [f"{k}: {v}" for k, v in settings.items()]
    lines += [
        "",
        "=== system ===",
        f"platform: {platform.platform()}",
        f"python: {sys.version.split()[0]}",
        f"torch: {torch.__version__}",
        f"devices: {devices}",
        f"git: {_git_info()}",
        f"timestamp: {datetime.datetime.now().isoformat()}",
    ]
    (Path(ckpt_dir) / "training_settings.log").write_text("\n".join(lines) + "\n")


class CsvLogger:
    """Per-epoch CSV metrics (Keras CSVLogger: the header from the first
    row). ``append=True`` adopts an existing file's header and appends, so a
    resumed phase keeps the rows logged before it stopped."""

    def __init__(self, path: str | Path, append: bool = False):
        self.path = Path(path)
        self._header = None
        if append and self.path.exists():
            first = self.path.read_text().splitlines()
            if first:
                self._header = first[0].split(",")

    def log(self, epoch: int, metrics: dict) -> None:
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        if self._header is None:
            self._header = list(row)
            self.path.write_text(",".join(self._header) + "\n")
        with self.path.open("a") as f:
            f.write(",".join(str(row.get(h, "")) for h in self._header) + "\n")


def _is_weights_dir(p: Path) -> bool:
    return (p / PARAMS_NPZ).exists() or any((p / m).exists() for m in _ORBAX_MARKERS)


def resolve_weights_path(weights_arg: str | Path, use_ema: bool = False) -> Path:
    """Find the best weights entry in a checkpoint dir (or take a weights
    dir as given), with the JAX package's candidate order and its EMA->best
    fallback."""
    p = Path(weights_arg)
    if not p.is_dir():
        raise FileNotFoundError(f"checkpoint directory not found: {p}")
    if _is_weights_dir(p):
        return p
    candidates = WEIGHT_CANDIDATES_EMA if use_ema else WEIGHT_CANDIDATES_BEST
    for name in candidates:
        c = p / name
        if c.is_dir():
            return c
    if use_ema:
        print("EMA weights not found, falling back to best weights")
        for name in WEIGHT_CANDIDATES_BEST:
            c = p / name
            if c.is_dir():
                return c
    subdirs = sorted(d for d in p.iterdir() if d.is_dir())
    if subdirs:
        return subdirs[0]
    raise FileNotFoundError(f"no weights found in {p}")


def save_params(ckpt_dir: str | Path, name: str, tree: dict) -> Path:
    """Write a Flax-layout param tree to ``<ckpt_dir>/<name>/params.npz``."""
    path = Path(ckpt_dir) / name
    path.mkdir(parents=True, exist_ok=True)
    save_flax_npz(tree, path / PARAMS_NPZ)
    return path


def load_params(path: str | Path) -> dict:
    """The Flax variable tree (numpy) of a weights directory: ``{"params"}``
    for a U-Net run, ``{"params", "batch_stats"}`` for a classifier run."""
    npz = Path(path) / PARAMS_NPZ
    if not npz.exists():
        raise FileNotFoundError(
            f"{npz} not found. An orbax checkpoint written by the JAX package "
            f"is exported with: python {EXPORT_SCRIPT} {path}")
    return load_flax_npz(npz)


def save_normalization_stats(ckpt_dir: str | Path, mean: float, std: float,
                             method: str = "zscore") -> dict:
    """``normalization_stats.json``, as the JAX package writes it."""
    stats = {"mean": float(mean), "std": float(std), "method": method}
    (Path(ckpt_dir) / "normalization_stats.json").write_text(json.dumps(stats, indent=2))
    return stats


def load_normalization_stats(ckpt_dir: str | Path) -> tuple[float, float]:
    """The training set's (mean, std); evaluation never uses its own."""
    path = Path(ckpt_dir) / "normalization_stats.json"
    if not path.exists():
        raise FileNotFoundError(f"Training normalization statistics not found: {path}")
    stats = json.loads(path.read_text())
    return float(stats["mean"]), float(stats["std"])


def detect_deep_supervision(ckpt_dir: str | Path) -> bool:
    f = Path(ckpt_dir) / "training_settings.log"
    if not f.exists():
        return False
    content = f.read_text()
    return "use_deep_supervision: True" in content or "deep_supervision: True" in content


def detect_model_config(ckpt_dir: str | Path) -> UNetConfig:
    """Rebuild the checkpoint's architecture from ``training_settings.log``;
    keys it lacks keep their defaults."""
    kwargs = {"use_deep_supervision": detect_deep_supervision(ckpt_dir)}
    f = Path(ckpt_dir) / "training_settings.log"
    if f.exists():
        text = f.read_text()

        def grab(key, cast):
            m = re.search(rf"^{key}: (.+)$", text, re.M)
            if m:
                try:
                    kwargs[key] = cast(m.group(1).strip())
                except (ValueError, SyntaxError):
                    pass

        grab("init_nb", int)
        grab("tile_size", int)
        grab("dropout_rate", float)
        grab("dilation_rates", lambda s: tuple(
            int(t) for t in s.strip("()[] ").split(",") if t.strip()))
    return UNetConfig(**kwargs)
