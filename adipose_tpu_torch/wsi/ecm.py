"""ECM fluorescence-channel preprocessing: the port's copy of
``adipose_tpu/wsi/ecm.py``.

Behavioral spec: ``preprocess_small_MS_SIMs.py:462-760``
(``preprocess_ecm_image`` + ``process_directory``): composable stages,
debanding (fft | morphological | column_norm) -> normalization (percentile |
zscore) -> illumination correction (rolling_ball | polynomial/gaussian |
tophat | clahe) -> contrast CLAHE -> unsharp sharpening, with a
``processing_log.json`` audit trail. Every stage runs on ``device`` (default
the card); decode and encode stay on the host.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.core.config import ECMPreprocessConfig
from adipose_tpu_torch.ops.clahe import _clahe_any_shape
from adipose_tpu_torch.ops.fftops import (correct_illumination_polynomial,
                                          remove_banding_column_normalize,
                                          remove_banding_fft, sharpen_unsharp)
from adipose_tpu_torch.ops.morphology import (correct_illumination_rolling_ball,
                                              correct_illumination_tophat,
                                              remove_banding_morphological)
from adipose_tpu_torch.ops.normalize import percentile_stretch_255, zscore_to_target


# The JAX package's ecm.py repeats clahe.py's padding; here it is that function.
_clahe_padded = _clahe_any_shape


def preprocess_ecm_image(img: np.ndarray, cfg: ECMPreprocessConfig | None = None,
                         device="cuda") -> np.ndarray:
    """Run the configured stage stack on a grayscale uint8 image on
    ``device``; the uint8 result (clipped, truncated) comes back."""
    cfg = cfg or ECMPreprocessConfig()
    if img.ndim == 3:
        img = cv2.cvtColor(img[..., :3], cv2.COLOR_RGB2GRAY)
    # the chunk goes up at its own dtype and is cast there
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(torch.float32)
    return ecm_stages(x, cfg).clamp(0, 255).to(torch.uint8).cpu().numpy()


def ecm_stages(x: torch.Tensor, cfg: ECMPreprocessConfig) -> torch.Tensor:
    """The configured stage stack on an (H, W) float32 tensor, on its device."""
    if cfg.deband_method == "fft":
        x = remove_banding_fft(x, (cfg.fft_freq_low, cfg.fft_freq_high),
                               vertical_width=cfg.fft_width,
                               smooth_sigma_scale=cfg.fft_sigma_scale, blend=cfg.fft_blend)
    elif cfg.deband_method == "morphological":
        x = remove_banding_morphological(x, cfg.morph_width, cfg.morph_height)
    elif cfg.deband_method in ("column_norm", "column"):
        x = remove_banding_column_normalize(x, preserve_global=cfg.column_preserve_global)

    if cfg.normalization_method == "percentile":
        x = percentile_stretch_255(x, cfg.percentile_low, cfg.percentile_high)
    elif cfg.normalization_method == "zscore":
        x = zscore_to_target(x)

    if cfg.illumination_method == "rolling_ball":
        x = correct_illumination_rolling_ball(x, cfg.rolling_ball_radius)
    elif cfg.illumination_method in ("gaussian", "polynomial"):
        x = correct_illumination_polynomial(x, cfg.poly_sigma)
    elif cfg.illumination_method == "tophat":
        x = correct_illumination_tophat(x, cfg.tophat_kernel)
    elif cfg.illumination_method == "clahe":
        x = _clahe_padded(x, cfg.clahe_illum_clip, cfg.clahe_illum_tile)

    if cfg.apply_clahe:
        x = _clahe_padded(x, cfg.clahe_clip, cfg.clahe_grid)

    if cfg.sharpen:
        x = sharpen_unsharp(x, cfg.sharpen_sigma, cfg.sharpen_amount)
    return x


def process_directory(input_dir: str | Path, output_dir: str | Path,
                      cfg: ECMPreprocessConfig | None = None, pattern: str = "*.jpg",
                      visualize: bool = False, max_visualizations: int = 10,
                      test_mode: bool = False, test_samples: int = 5, seed: int = 865,
                      device="cuda") -> dict:
    """Batch driver with ``processing_log.json``
    (``preprocess_small_MS_SIMs.py:601-760``): ``pattern`` then ``*.png``
    then ``*.tif``, each sorted. ``visualize`` writes before/after
    side-by-sides into ``visualizations/`` (up to ``max_visualizations``);
    ``test_mode`` keeps the first image and ``test_samples`` drawn from the
    rest by ``RandomState(seed)`` (:936-945)."""
    cfg = cfg or ECMPreprocessConfig()
    torch.empty(0, device=device)  # a missing card raises here, not once per file
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(input_dir.glob(pattern)) + sorted(input_dir.glob("*.png")) + sorted(
        input_dir.glob("*.tif"))
    if test_mode and len(files) > test_samples + 1:
        rng = np.random.RandomState(seed)
        idx = rng.choice(len(files) - 1, test_samples, replace=False)
        files = [files[0]] + [files[i + 1] for i in sorted(idx)]
    log = {"timestamp": datetime.now().isoformat(), "config": vars(cfg).copy(),
           "processed": [], "errors": []}
    n_vis = 0
    for f in files:
        try:
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise ValueError("unreadable")
            out = preprocess_ecm_image(img, cfg, device)
            cv2.imwrite(str(output_dir / f.name), out, [cv2.IMWRITE_JPEG_QUALITY, 95])
            if visualize and n_vis < max_visualizations:
                vis_dir = output_dir / "visualizations"
                vis_dir.mkdir(exist_ok=True)
                cv2.imwrite(str(vis_dir / f"{f.stem}_before_after.jpg"),
                            np.concatenate([img, out], axis=1), [cv2.IMWRITE_JPEG_QUALITY, 90])
                n_vis += 1
            log["processed"].append(f.name)
        except Exception as e:  # per-item skip-and-continue (reference style)
            log["errors"].append({"file": f.name, "error": str(e)})
    (output_dir / "processing_log.json").write_text(json.dumps(log, indent=2, default=str))
    return log
