"""Checkpoint artifacts, read with the JAX package's contract.

A checkpoint directory keeps the reference's layout
(``adipose_tpu/train/checkpoint.py``): ``normalization_stats.json``,
``training_settings.log`` and one directory per weights entry
(``weights_best_overall``, ``phase2_best``, ...). The JAX package writes
each weights entry as an orbax checkpoint; the port reads ``params.npz``
in the same directory, the Flax param tree as numpy, which
``scripts/export_flax_params_npz.py`` writes from the orbax files.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

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
