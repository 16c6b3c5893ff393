"""Modality comparison (Pseudocolored vs ECM) and ECM -> Pseudocolored
rescaling: the port's copy of ``adipose_tpu/wsi/compare.py``.

Behavioral spec:
  * ``pre-post-processing_tools/compare_pseudocolored_ecm_tiles.py``: MSE,
    SSIM and histogram correlation per tile pair (:81), stratified sampling
    (:266), side-by-side + diff-heatmap renders;
  * ``pre-post-processing_tools/ECM_scaling.py``: resample ECM images to the
    Pseudocolored reference dimensions (:114);
  * ``convert_tif_to_jpg.py``: 16-bit TIFF -> 8-bit JPEG.

SSIM is the Wang et al. windowed form with an 11x11 Gaussian (sigma 1.5),
as ``skimage.metrics.structural_similarity(gaussian_weights=True)``; its
five filters are one float32 convolution on ``device``, in full float32
whatever the global TF32 setting. Resampling, decode and encode are host cv2;
the metrics CSV is written with the ``csv`` module.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from adipose_tpu_torch.core.hostio import write_csv
from adipose_tpu_torch.ops.fftops import full_f32, recip
from adipose_tpu_torch.wsi.chunker import convert_16_to_8bit

_INTERP = {
    "nearest": cv2.INTER_NEAREST,
    "bilinear": cv2.INTER_LINEAR,
    "bicubic": cv2.INTER_CUBIC,
    "lanczos": cv2.INTER_LANCZOS4,
}


def resample_image(img: np.ndarray, target_hw, method: str = "bilinear") -> np.ndarray:
    """(``ECM_scaling.py:114``)."""
    if method not in _INTERP:
        raise ValueError(f"unknown interpolation: {method}")
    h, w = int(target_hw[0]), int(target_hw[1])
    return cv2.resize(img, (w, h), interpolation=_INTERP[method])


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x * recip(sigma)) ** 2)
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Windowed SSIM, the mean over the valid positions; a 0-dim tensor."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    w = _gaussian_window(device=a.device)[None, None]
    with full_f32():
        mu_a, mu_b, mu_aa, mu_bb, mu_ab = F.conv2d(
            torch.stack([a, b, a * a, b * b, a * b])[:, None], w)[:, 0]
    va = mu_aa - mu_a ** 2
    vb = mu_bb - mu_b ** 2
    cov = mu_ab - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return s.mean()


def histogram_correlation(a: torch.Tensor, b: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Pearson correlation of the two intensity histograms
    (cv2.compareHist HISTCMP_CORREL semantics); a 0-dim tensor."""
    def hist(x):
        idx = x.to(torch.int32).clamp(0, nbins - 1).reshape(-1).to(torch.int64)
        return torch.bincount(idx, minlength=nbins).to(torch.float32)

    ha, hb = hist(a), hist(b)
    ha = ha - ha.mean()
    hb = hb - hb.mean()
    return (ha * hb).sum() / torch.sqrt((ha ** 2).sum() * (hb ** 2).sum()).clamp_min(1e-10)


def compute_metrics(img_a: np.ndarray, img_b: np.ndarray, device="cuda") -> dict:
    """Per-pair MSE, SSIM and histogram correlation
    (``compare_..._tiles.py:81``) on ``device``; ``img_b`` is resampled to
    ``img_a``'s shape first where they differ."""
    if img_a.shape != img_b.shape:
        img_b = resample_image(img_b, img_a.shape[:2])
    a = torch.from_numpy(np.ascontiguousarray(img_a)).to(device).to(torch.float32)
    b = torch.from_numpy(np.ascontiguousarray(img_b)).to(device).to(torch.float32)
    return {
        "mse": float(((a - b) ** 2).mean()),
        "ssim": float(ssim(a, b)),
        "histogram_correlation": float(histogram_correlation(a, b)),
    }


def stratified_sample(paths, n: int, seed: int = 865):
    """Evenly strided deterministic sample (``compare_..._tiles.py:266``)."""
    paths = sorted(paths)
    if len(paths) <= n:
        return paths
    idx = np.linspace(0, len(paths) - 1, n).astype(int)
    return [paths[i] for i in idx]


def compare_directories(pseudo_dir: str | Path, ecm_dir: str | Path, output_dir: str | Path,
                        n_samples: int = 50, n_perfect: int | None = None,
                        n_mismatch: int | None = None, seed: int | None = None,
                        device="cuda") -> list:
    """Pairs by stem, with ``comparison_metrics.csv`` and diff heatmaps.

    ``n_perfect``/``n_mismatch`` sample separately from same-dimension pairs
    and dimension-mismatched pairs, in the directory's listing order, by
    ``RandomState(865 or seed)`` (``compare_pseudocolored_ecm_tiles.py:
    321-332``); without them, one stratified sample of ``n_samples`` of the
    sorted pairs."""
    pseudo_dir, ecm_dir = Path(pseudo_dir), Path(ecm_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    ecm_by_stem = {p.stem: p for p in ecm_dir.glob("*") if p.is_file()}
    pairs = [(p, ecm_by_stem[p.stem]) for p in pseudo_dir.glob("*")
             if p.is_file() and p.stem in ecm_by_stem]
    if n_perfect is not None or n_mismatch is not None:
        rng = np.random.RandomState(865 if seed is None else seed)
        perfect, mismatch = [], []
        for pp, ep in pairs:
            a, b = cv2.imread(str(pp)), cv2.imread(str(ep))
            if a is None or b is None:
                continue
            (perfect if a.shape[:2] == b.shape[:2] else mismatch).append((pp, ep))

        def pick(group, n):
            if n is None or len(group) <= n:
                return group
            idx = rng.choice(len(group), n, replace=False)
            return [group[i] for i in idx]

        pairs = pick(perfect, n_perfect) + pick(mismatch, n_mismatch)
    else:
        pairs = stratified_sample(pairs, n_samples)
    rows = []
    for pp, ep in pairs:
        a = cv2.imread(str(pp), cv2.IMREAD_GRAYSCALE)
        b = cv2.imread(str(ep), cv2.IMREAD_GRAYSCALE)
        if a is None or b is None:
            continue
        rows.append({"tile": pp.stem, **compute_metrics(a, b, device)})
        if b.shape != a.shape:
            b = resample_image(b, a.shape[:2])
        diff = cv2.applyColorMap(cv2.convertScaleAbs(cv2.absdiff(a, b)), cv2.COLORMAP_JET)
        side = np.concatenate([cv2.cvtColor(a, cv2.COLOR_GRAY2BGR),
                               cv2.cvtColor(b, cv2.COLOR_GRAY2BGR), diff], axis=1)
        cv2.imwrite(str(output_dir / f"{pp.stem}_comparison.jpg"), side)
    write_csv(output_dir / "comparison_metrics.csv", rows)
    return rows


def convert_tif_to_jpg(input_path: str | Path, output_path: str | Path, quality: int = 95,
                       invert: bool = False) -> bool:
    """16-bit -> 8-bit min-max and grayscale -> 3-channel JPEG on the host
    (``convert_tif_to_jpg.py:118``); ``invert`` flips intensities after the
    bit-depth conversion (:148)."""
    img = cv2.imread(str(input_path), cv2.IMREAD_UNCHANGED)
    if img is None:
        return False
    if img.dtype == np.uint16:
        img = convert_16_to_8bit(img)
    if invert:
        img = 255 - img
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return bool(cv2.imwrite(str(output_path), img, [cv2.IMWRITE_JPEG_QUALITY, quality]))
