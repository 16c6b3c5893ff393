"""Offline dataset analyses: the port's copy of ``adipose_tpu/data/analysis.py``.

Behavioral spec: the ``pre-post-processing_tools/analysis/`` script family
(tile-quality census, CLAHE/percentile/normalization comparisons,
preprocessing-pipeline visualizer), consolidated as parameterized drivers:

  * :func:`tile_quality_census`: batched QC statistics over a tile directory;
  * :func:`preprocessing_comparison`: enhancement variants (none / zscore /
    percentile / CLAHE / deband) with quality metrics per variant;
  * :func:`morphology_census`: cell-shape statistics over mask tiles ->
    post-processing parameters (host cv2);
  * :func:`contrast_group_census`: quality grouping -> adaptive-CLAHE cutoffs;
  * :func:`preprocessing_pipeline_visualization`: staged pipeline panels;
  * :func:`normalization_comparison` and
    :func:`comprehensive_normalization_analysis`: the reference's
    ``compare_*.py`` suites and its dataset-wide method scoring.

The pixel math runs on ``device`` (default the card) through the port's
ops; the per-image scalars, cv2 metrics and reports are host work, as in the
JAX package. Tables are written by :func:`~adipose_tpu_torch.core.hostio.
write_csv` with pandas' semantics (``value_counts`` order, ``groupby``
order and means) and figures by :mod:`adipose_tpu_torch.core.charts`.

The 15 x 15 local-contrast field sums in float64, so its box sums are
exact for integer-valued images (the JAX package's float32 cumulative sums
of x^2 reach ~6.7e7 > 2^24 over a 1030-pixel padded row and round there);
the card and the CPU then agree.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.core.charts import Figure, hist_panel, limits
from adipose_tpu_torch.core.hostio import write_csv
from adipose_tpu_torch.data.stain_select import shannon_entropy
from adipose_tpu_torch.ops.clahe import _clahe_any_shape
from adipose_tpu_torch.ops.fftops import reflect_pad, remove_banding_fft
from adipose_tpu_torch.ops.normalize import (_percentiles, percentile_stretch_255,
                                             zscore_to_target)
from adipose_tpu_torch.ops.qc import classify_tiles_batch, laplacian_variance


def _tile_files(tiles_dir: Path):
    exts = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    return sorted(p for p in Path(tiles_dir).rglob("*") if p.suffix.lower() in exts)


def _to_device(img: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(img, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _f32(v) -> float:
    """A device scalar as the float32 value JAX would return, as a float."""
    return float(np.float32(float(v)))


# ---- pandas' semantics over lists of rows --------------------------------------


def _kahan_mean(values) -> float:
    """``DataFrameGroupBy.mean`` of one group: pandas' Kahan-compensated sum
    in row order over the count (NaN skipped)."""
    total = comp = 0.0
    n = 0
    for v in values:
        if isinstance(v, float) and math.isnan(v):
            continue
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
        n += 1
    return total / n if n else math.nan


def _series_mean(values) -> float:
    """``Series.mean`` (numpy's pairwise sum over the count; NaN skipped)."""
    a = np.asarray(values, np.float64)
    a = a[~np.isnan(a)]
    return float(a.sum() / a.size) if a.size else math.nan


def _series_std(values) -> float:
    """``Series.std`` (ddof 1; NaN skipped, NaN below two values)."""
    a = np.asarray(values, np.float64)
    a = a[~np.isnan(a)]
    return float(np.std(a, ddof=1)) if a.size > 1 else math.nan


def _groups(rows: list[dict], key: str) -> dict:
    """``groupby(key, sort=False)``: key -> its rows, in first-seen order."""
    out: dict = {}
    for r in rows:
        out.setdefault(r[key], []).append(r)
    return out


def _value_counts(labels) -> dict:
    """``Series.value_counts()``: count descending, ties in first-seen order."""
    counts: dict = {}
    for v in labels:
        counts[v] = counts.get(v, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


# ---- tile census and preprocessing variants -------------------------------------


def tile_quality_census(
    tiles_dir: str | Path,
    output_dir: str | Path,
    batch_size: int = 16,
    max_tiles: int | None = None,
    device="cuda",
) -> dict:
    """QC census over a tile directory -> census.csv + census_summary.json;
    the verdicts of each batch of one shape on ``device``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = _tile_files(Path(tiles_dir))
    if max_tiles:
        files = files[:max_tiles]
    rows = []
    for i in range(0, len(files), batch_size):
        chunk = files[i : i + batch_size]
        imgs = []
        for f in chunk:
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is not None:
                imgs.append((f, img))
        if not imgs:
            continue
        shapes = {im.shape for _, im in imgs}
        for shape in shapes:
            sel = [(f, im) for f, im in imgs if im.shape == shape]
            batch = _to_device(np.stack([im for _, im in sel]), device)
            v = {k: t.cpu().numpy() for k, t in
                 classify_tiles_batch(batch, 235.0, 0.70, 7.5).items()}
            for j, (f, im) in enumerate(sel):
                rows.append({
                    "tile": f.name,
                    "white_ratio": float(v["white_ratio"][j]),
                    "laplacian_var": float(v["laplacian_var"][j]),
                    "is_empty": bool(v["is_empty"][j]),
                    "is_blurry": bool(v["is_blurry"][j]),
                    "is_good": bool(v["is_good"][j]),
                    "mean": float(im.mean()),
                    "std": float(im.std()),
                })
    write_csv(output_dir / "census.csv", rows)
    n = len(rows)
    summary = {
        "n_tiles": n,
        "n_good": sum(r["is_good"] for r in rows),
        "n_empty": sum(r["is_empty"] for r in rows),
        "n_blurry": sum(r["is_blurry"] for r in rows),
        "mean_intensity": _series_mean([r["mean"] for r in rows]) if n else None,
        "std_intensity": _series_mean([r["std"] for r in rows]) if n else None,
        "mean_laplacian_var": _series_mean([r["laplacian_var"] for r in rows]) if n else None,
    }
    (output_dir / "census_summary.json").write_text(json.dumps(summary, indent=2))
    return summary


VARIANTS = ("none", "zscore", "percentile", "clahe", "deband_fft")


def _apply_variant(img: np.ndarray, variant: str, device="cuda") -> np.ndarray:
    x = _to_device(img, device)
    if variant == "none":
        out = x
    elif variant == "zscore":
        out = zscore_to_target(x)
    elif variant == "percentile":
        out = percentile_stretch_255(x)
    elif variant == "clahe":
        out = _clahe_any_shape(x, 2.0, 8)
    elif variant == "deband_fft":
        out = remove_banding_fft(x)
    else:
        raise ValueError(variant)
    return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)


def preprocessing_comparison(
    tiles_dir: str | Path,
    output_dir: str | Path,
    variants: tuple = VARIANTS,
    n_samples: int = 10,
    save_images: bool = True,
    device="cuda",
) -> list:
    """Per-variant quality metrics over sample tiles -> comparison CSV, the
    per-variant means (``preprocessing_summary.csv``) and side-by-side
    renders."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = _tile_files(Path(tiles_dir))
    step = max(1, len(files) // max(n_samples, 1))
    samples = files[::step][:n_samples]
    rows = []
    for f in samples:
        img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        panels = []
        for variant in variants:
            out = _apply_variant(img, variant, device)
            rows.append({
                "tile": f.name,
                "variant": variant,
                "sharpness": float(cv2.Laplacian(out, cv2.CV_64F).var()),
                "entropy": shannon_entropy(out),
                "contrast": float(out.std()),
                "mean": float(out.mean()),
            })
            panels.append(out)
        if save_images:
            strip = np.concatenate(panels, axis=1)
            cv2.imwrite(str(output_dir / f"{f.stem}_variants.jpg"), strip)
    write_csv(output_dir / "preprocessing_comparison.csv", rows)
    # df.groupby("variant")[[...]].mean().to_csv(): sorted keys, an index column
    groups = _groups(rows, "variant")
    summary = [{"variant": v} | {k: _kahan_mean(r[k] for r in groups[v])
                                 for k in ("sharpness", "entropy", "contrast")}
               for v in sorted(groups)]
    if summary:
        write_csv(output_dir / "preprocessing_summary.csv", summary)
    else:  # pandas writes the header of an empty groupby
        (output_dir / "preprocessing_summary.csv").write_text(
            "variant,sharpness,entropy,contrast\n")
    return rows


# ---- morphology census (host cv2) ------------------------------------------------


def _component_shape_stats(binary: np.ndarray, min_area: int = 10) -> list[dict]:
    """Per-connected-component shape descriptors of a binary mask.

    cv2-native equivalent of skimage ``regionprops`` as used by the reference
    (``analysis/morphology parameter_analysis/analyze_training_data.py:91-117``):
    area, perimeter, circularity 4 pi A / P^2, major/minor ellipse axes ->
    aspect ratio and eccentricity. Components below ``min_area`` px are
    skipped (the reference skips area < 10, :106-108).
    """
    contours, _ = cv2.findContours(
        binary.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE
    )
    cells = []
    for c in contours:
        area = float(cv2.contourArea(c))
        if area < min_area:
            continue
        perimeter = float(cv2.arcLength(c, closed=True))
        circularity = 4.0 * np.pi * area / (perimeter**2 + 1e-10)
        if len(c) >= 5:
            (_, _), (d1, d2), _ = cv2.fitEllipse(c)
            major, minor = max(d1, d2), min(d1, d2)
        else:
            (_, _), (d1, d2), _ = cv2.minAreaRect(c)
            major, minor = max(d1, d2), min(d1, d2)
        aspect = major / (minor + 1e-10)
        ecc = float(np.sqrt(max(0.0, 1.0 - (minor / (major + 1e-10)) ** 2)))
        cells.append({
            "area": area, "perimeter": perimeter, "circularity": circularity,
            "aspect_ratio": float(aspect), "eccentricity": ecc,
        })
    return cells


def _dist_stats(values: list[float], percentiles: bool = False) -> dict:
    if not values:
        base = {"min": 0.0, "max": 0.0, "mean": 0.0, "median": 0.0}
        if percentiles:
            base.update({"std": 0.0, "percentile_5": 0.0, "percentile_95": 0.0})
        return base
    a = np.asarray(values, np.float64)
    base = {
        "min": float(a.min()), "max": float(a.max()),
        "mean": float(a.mean()), "median": float(np.median(a)),
    }
    if percentiles:
        base.update({
            "std": float(a.std()),
            "percentile_5": float(np.percentile(a, 5)),
            "percentile_95": float(np.percentile(a, 95)),
        })
    return base


def morphology_census(
    masks_dir: str | Path,
    output_dir: str | Path,
    n_samples: int = 10,
    min_area: int = 10,
) -> dict:
    """Adipose-cell morphology census -> optimized post-processing parameters.

    Behavioral spec: ``analysis/morphology parameter_analysis/
    analyze_training_data.py``: samples N masks evenly, measures every cell's
    area/circularity/aspect-ratio/eccentricity distribution, then derives the
    reference's post-processing envelope (:182-210): min/max cell size from
    the 5th/95th area percentiles with x0.5/x1.5 buffers clamped to [50,
    50000], circularity floor mean - 0.4 clamped >= 0.1, aspect-ratio ceiling
    mean + 1.5 clamped <= 6.0, kernel size 3, plus the fixed CRF constants
    the reference emits for 1024^2 meat tissue. Writes
    ``morphology_analysis.json``.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = _tile_files(Path(masks_dir))
    step = max(1, len(files) // max(n_samples, 1))
    samples = files[::step][:n_samples]

    all_cells: list[dict] = []
    sample_results: dict = {}
    for f in samples:
        mask = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        if mask is None:
            continue
        binary = (mask.astype(np.float32) > 0.5 * max(1.0, float(mask.max()))).astype(np.uint8)
        cells = _component_shape_stats(binary, min_area=min_area)
        sample_results[f.name] = {
            "num_cells": len(cells),
            "tissue_coverage": float(binary.mean()),
            "mean_area": float(np.mean([c["area"] for c in cells])) if cells else 0.0,
            "mean_circularity": (
                float(np.mean([c["circularity"] for c in cells])) if cells else 0.0
            ),
        }
        all_cells.extend(cells)

    stats = {
        "total_cells_analyzed": len(all_cells),
        "area_stats": _dist_stats([c["area"] for c in all_cells], percentiles=True),
        "circularity_stats": _dist_stats([c["circularity"] for c in all_cells]),
        "aspect_ratio_stats": _dist_stats([c["aspect_ratio"] for c in all_cells]),
        "eccentricity_stats": _dist_stats([c["eccentricity"] for c in all_cells]),
        "sample_results": sample_results,
    }
    area, circ, aspect = (
        stats["area_stats"], stats["circularity_stats"], stats["aspect_ratio_stats"]
    )
    optimized = {
        "morphological": {
            "min_cell_size": max(50, int(area["percentile_5"] * 0.5)),
            "max_cell_size": min(50000, int(area["percentile_95"] * 1.5)),
            "min_circularity": max(0.1, circ["mean"] - 2 * 0.2),
            "max_aspect_ratio": min(6.0, aspect["mean"] + 1.5),
            "morph_kernel_size": 3,
        },
        # fixed constants the reference emits for 1024^2 meat tissue (:204-210)
        "crf": {"bilateral_sxy": 25, "bilateral_srgb": 15, "gaussian_sxy": 4},
    }
    report = {"cell_statistics": stats, "optimized_parameters": optimized}
    (output_dir / "morphology_analysis.json").write_text(json.dumps(report, indent=2))
    return report


# ---- contrast grouping -> adaptive-CLAHE cutoffs ----------------------------------
# (analysis/contrast_and_normalization_analysis/analyze_contrast_groups.py)


def _box_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k sliding mean with reflect-101 borders (cv2.filter2D's default) of
    an (H, W) tensor, as two separable cumulative-sum passes, in float64:
    exact sums for integer-valued input on any device."""
    pad = k // 2
    xp = reflect_pad(x, pad, pad, pad, pad).to(torch.float64)

    def box1d(a, dim):
        c = torch.cat([torch.zeros_like(a.narrow(dim, 0, 1)), a.cumsum(dim)], dim)
        n = c.shape[dim]
        return c.narrow(dim, k, n - k) - c.narrow(dim, 0, n - k)

    return box1d(box1d(xp, 0), 1) / float(k * k)


def _histogram(x: torch.Tensor, hi: float, bins: int = 256) -> np.ndarray:
    """``jnp.histogram(x, bins, (0, hi))[0]`` as float32: float32 edges,
    each value in the bin of the last edge <= it, the top edge in the last
    bin, values outside the range dropped."""
    edges = torch.from_numpy(np.linspace(0.0, hi, bins + 1).astype(np.float32)).to(x.device)
    flat = x.reshape(-1).to(torch.float32)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1].cpu().numpy().astype(np.float32)


def _local_std(x: torch.Tensor) -> torch.Tensor:
    """The 15 x 15 local standard deviation field of an (H, W) float32
    tensor, float64 (x^2 rounded to float32 first, as the JAX package
    squares)."""
    local_mean = _box_mean(x, 15)
    local_sq = _box_mean(x * x, 15)
    return (local_sq - local_mean**2).clamp_min(0.0).sqrt()


def _quality_arrays(x: torch.Tensor):
    """The per-image quality metrics' device work: intensity moments, the
    15 x 15 local-contrast field's mean and std, and the 256-bin histogram.
    Moments in float64, each returned as its float32 value."""
    x64 = x.to(torch.float64)
    mean, std = x64.mean(), x64.std(correction=0)
    dyn = x.max() - x.min()
    local_std = _local_std(x)
    return (_f32(mean), _f32(std), _f32(dyn), _f32(local_std.mean()),
            _f32(local_std.std(correction=0)), _histogram(x, 255.0))


def image_quality_metrics(img: np.ndarray, device="cuda") -> dict:
    """The ten quality metrics of ``analyze_contrast_groups.py:34-90``:
    intensity moments, contrast ratio / dynamic range / CV, Laplacian-variance
    sharpness, 15 x 15 local-contrast statistics, histogram entropy, and
    smoothed-histogram peak prominence. Pixel math on ``device``; the
    histogram post-processing (5-tap Gaussian smooth + peak scan) is 256
    scalars on the host."""
    x = _to_device(img, device)
    mean, std, dyn, avg_lc, std_lc, hist = _quality_arrays(x)
    lap = float(laplacian_variance(x.clamp(0, 255).to(torch.uint8)[None])[0])
    p = hist / max(hist.sum(), 1.0)
    entropy = float(-np.sum(p * np.log2(p + 1e-10)))
    smooth = cv2.GaussianBlur(hist.reshape(-1, 1), (1, 5), 1.0).ravel()
    interior = smooth[1:-1]
    is_peak = (interior > smooth[:-2]) & (interior > smooth[2:])
    peaks = interior[is_peak]
    peak_prom = float(peaks.max() / (smooth.mean() + 1e-6)) if peaks.size else 0.0
    return {
        "mean_intensity": mean,
        "std_intensity": std,
        "contrast_ratio": std / (mean + 1e-6),
        "dynamic_range": dyn,
        "coefficient_variation": std / mean * 100 if mean else 0.0,
        "laplacian_variance": lap,
        "avg_local_contrast": avg_lc,
        "local_contrast_variation": std_lc / (avg_lc + 1e-6),
        "entropy": entropy,
        "peak_prominence": peak_prom,
    }


def _census_splits(dataset_dir: Path) -> dict:
    """dataset/{train,val,test}/images layout when present, else one flat
    split (the reference hard-codes the three-split layout, :101-114).
    A lone ``images/`` child is used directly so sibling ``masks/`` artifacts
    never enter the census."""
    splits = {}
    for name in ("train", "val", "test"):
        d = dataset_dir / name / "images"
        if d.is_dir():
            splits[name] = d
    if splits:
        return splits
    sub = dataset_dir / "images"
    return {"all": sub if sub.is_dir() else dataset_dir}


QUALITY_GROUPS = ("Poor Quality (Needs CLAHE)", "Good Quality (Percentile Only)",
                  "Medium Quality (Mild CLAHE)")


def quality_group(row: dict, cutoffs: dict) -> str:
    """Contrast primary, sharpness tiebreak on the good side (:229-243)."""
    if row["contrast_ratio"] < cutoffs["contrast_ratio"]["poor_cutoff"]:
        return QUALITY_GROUPS[0]
    if (row["contrast_ratio"] > cutoffs["contrast_ratio"]["good_cutoff"]
            and row["laplacian_variance"] > cutoffs["laplacian_variance"]["good_cutoff"]):
        return QUALITY_GROUPS[1]
    return QUALITY_GROUPS[2]


ADAPTIVE_MODULE = (
    "# Generated by adipose_tpu_torch contrast_group_census from {n} sample images.\n"
    "from adipose_tpu_torch.ops.clahe import adaptive_clahe_normalize\n\n"
    "CUTOFFS = {cutoffs}\n\n\n"
    'def adaptive_clahe_normalization(img, device="cuda"):\n'
    '    """Quality-adaptive CLAHE+percentile normalization -> [0,1] on device."""\n'
    "    out, _strategy = adaptive_clahe_normalize(img, CUTOFFS, device=device)\n"
    "    return out.cpu().numpy()\n"
)


def contrast_group_census(
    dataset_dir: str | Path,
    output_dir: str | Path,
    n_per_split: int = 2,
    seed: int = 865,
    device="cuda",
) -> dict:
    """Contrast-based quality grouping -> adaptive-CLAHE cutoffs.

    Behavioral spec: ``analysis/contrast_and_normalization_analysis/
    analyze_contrast_groups.py``: sample images per split (seed 865, :117),
    measure :func:`image_quality_metrics`, set poor/good cutoffs at the 33rd/
    67th percentile of contrast ratio, sharpness and local contrast
    (:189-196), classify each image (:229-243), and write
    ``image_quality_analysis.csv``, ``contrast_analysis_grouping.png``,
    ``adaptive_clahe_function.py`` (generated; it parameterizes the port's
    :func:`adipose_tpu_torch.ops.clahe.adaptive_clahe_normalize`, where the
    JAX package's imports the JAX package's), ``adaptive_clahe_cutoffs.json``
    and ``CONTRAST_GROUPING_ANALYSIS.md`` (:363-418).
    """
    dataset_dir, output_dir = Path(dataset_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rng = random.Random(seed)

    rows = []
    for split, img_dir in _census_splits(dataset_dir).items():
        files = sorted(img_dir.glob("*.jpg")) or [
            f for f in _tile_files(img_dir) if "masks" not in f.parent.parts
        ]
        if not files:
            continue
        for idx, f in enumerate(rng.sample(files, min(n_per_split, len(files)))):
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            m = image_quality_metrics(img.astype(np.float32), device)
            m.update(split=split, sample_id=f"{split}_sample{idx + 1}", filename=f.name)
            rows.append(m)
    if not rows:
        raise FileNotFoundError(f"no images under {dataset_dir}")

    cutoffs = {}
    for metric in ("contrast_ratio", "laplacian_variance", "avg_local_contrast"):
        lo, hi = np.percentile(np.array([r[metric] for r in rows]), [33, 67])
        cutoffs[metric] = {"poor_cutoff": float(lo), "good_cutoff": float(hi)}
    for r in rows:
        r["quality_group"] = quality_group(r, cutoffs)
    write_csv(output_dir / "image_quality_analysis.csv", rows)
    (output_dir / "adaptive_clahe_cutoffs.json").write_text(json.dumps(cutoffs, indent=2))
    (output_dir / "adaptive_clahe_function.py").write_text(
        ADAPTIVE_MODULE.format(n=len(rows), cutoffs=json.dumps(cutoffs, indent=4)))
    _plot_contrast_grouping(rows, output_dir / "contrast_analysis_grouping.png")

    counts = _value_counts(r["quality_group"] for r in rows)
    cr, lv = cutoffs["contrast_ratio"], cutoffs["laplacian_variance"]
    report = (
        "# Image Quality Analysis and Adaptive CLAHE Cutoffs\n\n"
        f"Based on {len(rows)} sample images ({n_per_split} per split, "
        f"seed {seed}).\n\n"
        "## Determined cutoffs\n\n"
        "**Contrast ratio (std/mean):**\n"
        f"- Poor (needs CLAHE): < {cr['poor_cutoff']:.3f}\n"
        f"- Medium (mild CLAHE): {cr['poor_cutoff']:.3f} – "
        f"{cr['good_cutoff']:.3f}\n"
        f"- Good (percentile only): > {cr['good_cutoff']:.3f}\n\n"
        "**Sharpness (Laplacian variance):**\n"
        f"- Poor: < {lv['poor_cutoff']:.1f}\n"
        f"- Medium: {lv['poor_cutoff']:.1f} – {lv['good_cutoff']:.1f}\n"
        f"- Good: > {lv['good_cutoff']:.1f}\n\n"
        "## Group distribution\n\n"
        + "\n".join(f"- {k}: {v}" for k, v in counts.items())
        + "\n\n## Strategy\n\n"
        "1. Poor: CLAHE clip 2.0 grid 8×8 + 5–95 percentile\n"
        "2. Medium: CLAHE clip 1.5 grid 12×12 + 5–95 percentile\n"
        "3. Good: 2–98 percentile only\n\n"
        "Generated: contrast_analysis_grouping.png, "
        "image_quality_analysis.csv, adaptive_clahe_function.py, "
        "adaptive_clahe_cutoffs.json\n"
    )
    (output_dir / "CONTRAST_GROUPING_ANALYSIS.md").write_text(report)
    return {"cutoffs": cutoffs, "n_images": len(rows), "groups": counts}


def _plot_contrast_grouping(rows: list[dict], out_path: Path) -> Path:
    """The 2 x 2 grouping figure (``analyze_contrast_groups.py:301-342``):
    metrics scatter by group, group counts, the two metrics' histograms."""
    fig = Figure(16, 12, 150, 2, 2)
    cr = [r["contrast_ratio"] for r in rows]
    lv = [r["laplacian_variance"] for r in rows]
    categories = sorted({r["quality_group"] for r in rows})  # .astype("category") codes
    codes = [categories.index(r["quality_group"]) for r in rows]
    ax = fig.panel(0, 0).axes(limits(cr), limits(lv), "Image Quality Metrics",
                              "Contrast Ratio (std/mean)", "Laplacian Variance (sharpness)",
                              grid=True)
    ax.scatter(cr, lv, codes, [r["sample_id"] for r in rows])
    counts = _value_counts(r["quality_group"] for r in rows)
    ax = fig.panel(0, 1).axes((-0.6, len(counts) - 0.4), (0, max(counts.values()) * 1.05),
                              "Quality Group Distribution", ylabel="Number of Images",
                              grid=True, xticks=False)
    ax.bars(list(counts.values()), list(counts))
    hist_panel(fig.panel(1, 0), cr, 8, title="Contrast Ratio Distribution",
               xlabel="Contrast Ratio", grid=True)
    hist_panel(fig.panel(1, 1), lv, 8, title="Sharpness Distribution",
               xlabel="Laplacian Variance (Sharpness)", grid=True)
    return fig.save(out_path)


# ---- preprocessing-pipeline visualizer (analysis/visualize_preprocessing_pipeline.py)


def preprocessing_pipeline_visualization(
    tiles_dir: str | Path,
    output_dir: str | Path,
    n_samples: int = 7,
    stats_path: str | Path | None = None,
    device="cuda",
) -> dict:
    """Original -> Reinhard -> z-score -> percentile panels for sample tiles.

    Behavioral spec: ``analysis/visualize_preprocessing_pipeline.py``:
    evenly spread sample tiles (:60-65), each through the four stages in
    color and grayscale (:73-151), drawn as an image row and a histogram row
    per tile with each stage's statistics, saved as
    ``preprocessing_pipeline_color.png`` / ``..._grayscale.png`` (:163-264).
    Reinhard and the two normalizations run on ``device``; the z-score
    statistics come from ``normalization_stats.json`` when given, else from
    the samples (:303-306).
    """
    from adipose_tpu_torch.data.stats import compute_dataset_statistics
    from adipose_tpu_torch.ops import stain
    from adipose_tpu_torch.ops.normalize import percentile_unit, zscore_dataset

    tiles_dir, output_dir = Path(tiles_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = _tile_files(tiles_dir)
    if not files:
        raise FileNotFoundError(f"no tiles under {tiles_dir}")
    step = max(1, len(files) // max(n_samples, 1))
    samples = files[::step][:n_samples]

    if stats_path is not None:
        stats = json.loads(Path(stats_path).read_text())
        mean, std = float(stats["mean"]), float(stats["std"])
    else:
        mean, std = compute_dataset_statistics([str(p) for p in samples])

    tiles_data = []
    for f in samples:
        bgr = cv2.imread(str(f), cv2.IMREAD_COLOR)
        if bgr is None:
            continue
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32)
        reinhard_rgb = stain.normalize_image(rgb, device=device).cpu().numpy()
        reinhard_gray = cv2.cvtColor(reinhard_rgb, cv2.COLOR_RGB2GRAY).astype(np.float32)
        rg = _to_device(reinhard_gray, device)
        zscore_gray = zscore_dataset(rg, mean, std).cpu().numpy()
        percentile_gray = percentile_unit(rg).cpu().numpy()
        gray3 = lambda g: np.repeat(g[..., None], 3, axis=-1)  # noqa: E731
        tiles_data.append({
            "name": f.stem,
            "color": [rgb.astype(np.float32), reinhard_rgb.astype(np.float32),
                      gray3(zscore_gray), gray3(percentile_gray)],
            "grayscale": [gray, reinhard_gray, zscore_gray, percentile_gray],
        })
    if not tiles_data:
        raise RuntimeError("no tiles could be processed")

    outputs = {}
    for version in ("color", "grayscale"):
        outputs[version] = str(_plot_pipeline_stages(tiles_data, output_dir, version))
    outputs["stats"] = {"mean": mean, "std": std}
    return outputs


_STAGE_NAMES = ("Original", "Reinhard Normalized", "Reinhard + Z-score",
                "Reinhard + Percentile")
_STAGE_COLORS = ("red", "green", "blue", "orange")


def stage_stats(img: np.ndarray) -> tuple[np.ndarray, str]:
    """(the values a stage's histogram counts, its mu / sigma / range text):
    a color stage through cv2's gray of its uint8 clip."""
    data = img
    if data.ndim == 3:
        data = cv2.cvtColor(np.clip(data, 0, 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    flat = np.asarray(data, np.float32).ravel()
    return flat, (f"μ={flat.mean():.2f}\nσ={flat.std():.2f}\n"
                  f"Range=[{flat.min():.2f}, {flat.max():.2f}]")


def _plot_pipeline_stages(tiles_data, output_dir: Path, version: str) -> Path:
    """Image row + histogram row per tile, four stages across
    (``visualize_preprocessing_pipeline.py:163-264``); 20 x (4n + 3) inches
    at 150 dpi."""
    n = len(tiles_data)
    title = "Original Colors" if version == "color" else "Grayscale (Network View)"
    fig = Figure(20, 4 * n + 3, 150, n * 2, 4,
                 title=f"Preprocessing Pipeline - {title}: "
                       "Original → Reinhard → Z-score → Percentile", footer=60)
    for ti, tile in enumerate(tiles_data):
        images = tile["color"] if version == "color" else tile["grayscale"]
        for si, (img, name, col) in enumerate(zip(images, _STAGE_NAMES, _STAGE_COLORS)):
            label = f"{name}\n{tile['name']}" if ti == 0 else name
            ax = fig.panel(2 * ti, si)
            if version == "color":
                ax.image(np.clip(img, 0, 255).astype(np.uint8), label, col)
            elif si <= 1:  # original / reinhard stay in [0, 255]
                ax.image(np.clip(img, 0, 255).astype(np.uint8), label, col, 0, 255)
            else:  # normalized stages: rescaled for display
                lo, hi = float(img.min()), float(img.max())
                disp = (img - lo) / (hi - lo) if hi > lo else img
                ax.image(disp, label, col, 0, 1)
            flat, text = stage_stats(img)
            hx = hist_panel(fig.panel(2 * ti + 1, si), flat, 50, col, density=True,
                            xlabel="Pixel Value", ylabel="Density")
            hx.text_box(text.split("\n"))
    fig.footer(f"Pipeline stages ({title}): 1. Original raw tile  "
               "2. Reinhard stain normalization  3. dataset z-score  4. 1–99 percentile")
    return fig.save(output_dir / f"preprocessing_pipeline_{version}.png")


# ---- normalization-method comparison suites: one named mode per reference script
# in analysis/contrast_and_normalization_analysis/ (the same method grids,
# per-sample comparison panels, metrics CSV and summary markdown)

_Z_MEAN, _Z_STD = 200.99, 25.26  # dataset stats (stain_normalization.py:348)

#: mode -> [(title, clahe (clip, grid) | "zscore" | None, percentile | None)].
#: Grids transcribed from the reference scripts (cited per mode).
NORM_COMPARISON_MODES = {
    # compare_clahe_percentile.py:48-90
    "clahe-percentile": (
        ("Original", None, None),
        ("CLAHE Only", (2.0, 8), None),
        ("Percentile (0.5-99.5)", None, (0.5, 99.5)),
        ("CLAHE + Percentile (0.5-99.5)", (2.0, 8), (0.5, 99.5)),
        ("Percentile (0.2-99.8)", None, (0.2, 99.8)),
        ("CLAHE + Percentile (0.2-99.8)", (2.0, 8), (0.2, 99.8)),
    ),
    # compare_normalization_methods.py:107-150
    "normalization-methods": (
        ("Original", None, None),
        ("CLAHE Only", (2.0, 8), None),
        ("Percentile Only (1-99)", None, (1.0, 99.0)),
        ("CLAHE + Percentile (Aggressive)", (2.0, 8), (1.0, 99.0)),
        ("Gentle Percentile (10-90)", None, (10.0, 90.0)),
        ("Light CLAHE + Wider Percentile", (1.2, 16), (5.0, 95.0)),
    ),
    # compare_requested_methods.py:52-95
    "requested-methods": (
        ("Current Z-score", "zscore", None),
        ("Percentile (0.01-99.99)", None, (0.01, 99.99)),
        ("Mild CLAHE + Percentile (0.01-99.99)", (1.5, 12), (0.01, 99.99)),
        ("Percentile (0.05-99.95)", None, (0.05, 99.95)),
        ("Mild CLAHE + Percentile (0.05-99.95)", (1.5, 12), (0.05, 99.95)),
        ("Mild CLAHE + Percentile (0.001-99.999)", (1.5, 12), (0.001, 99.999)),
    ),
    # compare_final_methods.py:47-90
    "final-methods": (
        ("Original", None, None),
        ("CLAHE", (2.0, 8), None),
        ("Percentile (0.1-99.9)", None, (0.1, 99.9)),
        ("Mild CLAHE", (1.5, 12), None),
        ("Percentile (0.05-99.95)", None, (0.05, 99.95)),
        ("Mild CLAHE + Percentile (0.05-99.95)", (1.5, 12), (0.05, 99.95)),
    ),
    # compare_very_final.py:47-86
    "very-final": (
        ("Original", None, None),
        ("CLAHE", (2.0, 8), None),
        ("Mild CLAHE", (1.5, 12), None),
        ("Mild CLAHE + Percentile (0.05-99.95)", (1.5, 12), (0.05, 99.95)),
        ("Mild CLAHE + Percentile (0.01-99.99)", (1.5, 12), (0.01, 99.99)),
    ),
}

#: reference output-file suffix per mode (``{sample}_{suffix}.png``)
_MODE_SUFFIX = {
    "clahe-percentile": "clahe_percentile_comparison",
    "normalization-methods": "normalization_comparison_updated",
    "requested-methods": "requested_comparison",
    "final-methods": "final_comparison",
    "very-final": "very_final_comparison",
}


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` by IEEE division on any device (the card's torch multiplies
    by the reciprocal of a Python scalar divisor; its CPU torch does not)."""
    return x / torch.tensor(v, dtype=torch.float32, device=x.device)


def apply_norm_method(img: np.ndarray, clahe_spec, perc, device="cuda") -> np.ndarray:
    """One comparison-grid method on a [0,255] grayscale image, on ``device``.

    Returns [0,1] floats for percentile methods, [0,1]-scaled for plain
    CLAHE/original panels, raw z-scores for the "zscore" method: the value
    ranges the reference scripts pass to their plots."""
    x = _to_device(img, device)
    if clahe_spec == "zscore":  # compare_requested_methods.py:40-43
        return _div(x - _Z_MEAN, _Z_STD + 1e-10).cpu().numpy()
    if clahe_spec is not None:
        clip, grid = clahe_spec
        x = _clahe_any_shape(x, clip, grid)  # the JAX package's _clahe_255
    if perc is not None:
        lo, hi = (v[0] for v in _percentiles(x.reshape(1, -1), *perc))
        return ((x - lo) / (hi - lo).clamp_min(1e-3)).clamp(0.0, 1.0).cpu().numpy()
    return _div(x, 255.0).cpu().numpy()


def _comparison_samples(tiles_dir: Path, n_samples: int) -> list:
    """(name, image) samples; dataset/{split}/images layouts yield the
    reference's ``{split}_sample{i}`` naming, flat dirs use file stems."""
    out = []
    for split, d in _census_splits(tiles_dir).items():
        for i, f in enumerate(_tile_files(d)[:n_samples]):
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            name = f"{split}_sample{i + 1}" if split != "all" else f.stem
            out.append((name, img.astype(np.float32)))
    return out


def normalization_comparison(
    tiles_dir: str | Path,
    output_dir: str | Path,
    mode: str,
    n_samples: int = 2,
    device="cuda",
) -> dict:
    """One reference ``compare_*.py`` suite: per-sample image + histogram
    panels for the mode's method grid, a per-method metrics CSV and a
    summary markdown."""
    if mode not in NORM_COMPARISON_MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from "
                         f"{sorted(NORM_COMPARISON_MODES)}")
    methods = NORM_COMPARISON_MODES[mode]
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    samples = _comparison_samples(Path(tiles_dir), n_samples)
    rows = []
    for name, img in samples:
        outs = [(t, apply_norm_method(img, c, p, device)) for t, c, p in methods]
        fig = Figure(4 * len(methods), 8, 120, 2, len(methods),
                     title=f"{mode} methods comparison — {name}")
        for idx, (title, arr) in enumerate(outs):
            disp = arr
            if "Z-score" in title:  # display-normalize (ref :115-118)
                disp = (arr - arr.min()) / (arr.max() - arr.min() + 1e-6)
            fig.panel(0, idx).image(disp, title, vmin=0, vmax=1)
            hist_panel(fig.panel(1, idx), arr, 50, "lightblue", title="Histogram", grid=True)
            u8 = np.clip(disp * 255, 0, 255).astype(np.uint8)
            rows.append({
                "sample": name, "method": title,
                "mean": float(arr.mean()), "std": float(arr.std()),
                "min": float(arr.min()), "max": float(arr.max()),
                "sharpness": float(cv2.Laplacian(u8, cv2.CV_64F).var()),
                "entropy": shannon_entropy(u8),
            })
        fig.save(output_dir / f"{name}_{_MODE_SUFFIX[mode]}.png")

    csv_path = output_dir / f"{mode.replace('-', '_')}_metrics.csv"
    write_csv(csv_path, rows)
    md = [f"# {mode} comparison summary", "",
          f"Samples: {len(samples)}; methods: {len(methods)}", "",
          "| method | mean | std | sharpness | entropy |", "|---|---|---|---|---|"]
    for title, g in _groups(rows, "method").items():
        md.append(f"| {title} | {_series_mean([r['mean'] for r in g]):.3f} | "
                  f"{_series_mean([r['std'] for r in g]):.3f} | "
                  f"{_series_mean([r['sharpness'] for r in g]):.1f} | "
                  f"{_series_mean([r['entropy'] for r in g]):.2f} |")
    summary_path = output_dir / f"{mode.upper().replace('-', '_')}_COMPARISON_SUMMARY.md"
    summary_path.write_text("\n".join(md) + "\n")
    return {"mode": mode, "n_samples": len(samples),
            "csv": str(csv_path), "summary": str(summary_path)}


# ---- comprehensive dataset-wide normalization analysis
# (comprehensive_normalization_analysis.py: 4 methods x sampled tiles ->
#  dataset_normalization_metrics.csv + dashboard PNG + report; optional
#  adipocyte-reference similarity scoring)

_COMPREHENSIVE_METHODS = {
    "current_zscore": ("zscore", None),
    "clahe_percentile": ((2.0, 8), (0.01, 99.99)),
    "mild_clahe_percentile": ((1.5, 12), (0.01, 99.99)),
    "percentile_only": (None, (0.01, 99.99)),
}

_QUALITY_METRICS = ("contrast_ratio", "laplacian_variance", "entropy",
                    "edge_density", "dynamic_range",
                    "local_contrast_consistency")


def _unit_quality_arrays(x: torch.Tensor):
    """Moments, the 15 x 15 local-std spread and the 256-bin [0,1] histogram
    on the tensor's device; each scalar as its float32 value."""
    x64 = x.to(torch.float64)
    dyn = x.max() - x.min()
    return (_f32(x64.mean()), _f32(x64.std(correction=0)), _f32(dyn),
            _f32(_local_std(x).std(correction=0)), _histogram(x, 1.0))


def comprehensive_metrics(img: np.ndarray, method_name: str = "", device="cuda") -> dict:
    """The 8 segmentation-oriented quality metrics of
    ``comprehensive_normalization_analysis.py:27-76`` ([0,1]-scaled input;
    a max above 1.1 is taken as [0,255] and rescaled, as the reference does)."""
    x = np.asarray(img, np.float32)
    if x.max() > 1.1:
        x = x / 255.0
    mean, std, dyn, std_lstd, hist = _unit_quality_arrays(_to_device(x, device))
    u8 = np.clip(x * 255, 0, 255).astype(np.uint8)
    lap = float(cv2.Laplacian(u8, cv2.CV_64F).var())
    edges = cv2.Canny(u8, 50, 150)
    p = hist / (hist.sum() + 1e-10)
    entropy = float(-np.sum(p * np.log2(p + 1e-10)))
    return {
        "method": method_name,
        "mean_intensity": mean,
        "std_intensity": std,
        "contrast_ratio": std / (mean + 1e-6),
        "laplacian_variance": lap,
        "entropy": entropy,
        "edge_density": float((edges > 0).sum()) / edges.size,
        "dynamic_range": dyn,
        "local_contrast_consistency": 1.0 / (std_lstd + 1e-6),
    }


def similarity_rows(rows: list[dict], adip_rows: list[dict]) -> list[dict]:
    """Each tile/method row's Gaussian similarity to the adipocyte
    references' mean and (ddof 1) std of each quality metric."""
    stats = {k: (_series_mean([r[k] for r in adip_rows]), _series_std([r[k] for r in adip_rows]))
             for k in _QUALITY_METRICS}
    out = []
    for row in rows:
        scores = {}
        for k in _QUALITY_METRICS:
            zd = abs((row[k] - stats[k][0]) / (stats[k][1] + 1e-6))
            scores[f"{k}_similarity"] = float(np.exp(-zd / 2))
        out.append({"filename": row["filename"], "split": row["split"],
                    "method": row["method"],
                    "overall_similarity": float(np.mean(list(scores.values()))),
                    **scores})
    return out


def comprehensive_normalization_analysis(
    dataset_dir: str | Path,
    output_dir: str | Path,
    n_per_split: int = 100,
    adipocyte_dir: str | Path | None = None,
    device="cuda",
) -> dict:
    """Dataset-wide method comparison: sample tiles per split, score each of
    the four normalization methods with the 8 quality metrics, and (with an
    adipocyte reference directory) Gaussian-similarity-score every
    tile/method against the adipocyte standards
    (``comprehensive_normalization_analysis.py:183-289``)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(42)  # ref: random.seed(42) (:158)
    rows = []
    for split, d in _census_splits(Path(dataset_dir)).items():
        files = _tile_files(d)
        if len(files) > n_per_split:
            files = [files[i] for i in
                     sorted(rng.choice(len(files), n_per_split, replace=False))]
        for f in files:
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            img = img.astype(np.float32)
            for method, (cl, pc) in _COMPREHENSIVE_METHODS.items():
                out = apply_norm_method(img, cl, pc, device)
                m = comprehensive_metrics(out, method, device)
                m.update({"filename": f.name, "split": split})
                rows.append(m)
    csv_path = output_dir / "dataset_normalization_metrics.csv"
    write_csv(csv_path, rows)
    result = {"n_rows": len(rows), "csv": str(csv_path)}

    adip_rows = None
    if adipocyte_dir is not None and Path(adipocyte_dir).is_dir():
        adip_rows = []
        for f in _tile_files(Path(adipocyte_dir)):
            img = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            z = apply_norm_method(img.astype(np.float32), "zscore", None, device)
            m = comprehensive_metrics(z, "adipocyte_reference", device)
            m["filename"] = f.name
            adip_rows.append(m)
        write_csv(output_dir / "adipocyte_reference_metrics.csv", adip_rows)
        if adip_rows and rows:
            sim_path = output_dir / "similarity_to_adipocytes.csv"
            write_csv(sim_path, similarity_rows(rows, adip_rows))
            result["similarity_csv"] = str(sim_path)

    # dashboard: per-method distribution of each quality metric
    if rows:
        fig = Figure(18, 10, 120, 2, 3, title="Comprehensive normalization analysis")
        by_method = _groups(rows, "method")
        for i, metric in enumerate(_QUALITY_METRICS):
            data = [[r[metric] for r in by_method.get(m, [])] for m in _COMPREHENSIVE_METHODS]
            ax = fig.panel(i // 3, i % 3).axes((0.5, len(data) + 0.5), limits(*data),
                                               metric, xticks=False)
            ax.boxplot(data, list(_COMPREHENSIVE_METHODS))
        fig.save(output_dir / "comprehensive_normalization_analysis.png")

    md = ["# Comprehensive normalization report", "",
          f"Tiles × methods scored: {len(rows)}", "",
          "| method | " + " | ".join(_QUALITY_METRICS) + " |",
          "|---" * (len(_QUALITY_METRICS) + 1) + "|"]
    for m, g in _groups(rows, "method").items():
        md.append("| " + m + " | " +
                  " | ".join(f"{_series_mean([r[k] for r in g]):.4g}" for k in _QUALITY_METRICS)
                  + " |")
    if adip_rows:
        md += ["", f"Adipocyte references scored: {len(adip_rows)}"]
    report = output_dir / "COMPREHENSIVE_NORMALIZATION_REPORT.md"
    report.write_text("\n".join(md) + "\n")
    result["report"] = str(report)
    return result
