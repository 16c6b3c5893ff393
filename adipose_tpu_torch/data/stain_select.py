"""Stain-reference selection and validation: the port's copy of
``adipose_tpu/data/stain_select.py``.

Behavioral spec:
  * ``pre-post-processing_tools/analysis/stain_normalization/
    select_stain_reference.py``: scores candidate tiles on technical quality
    (sharpness, entropy, contrast consistency, edge density), color
    characteristics (LAB stats, SYBR-Gold/Eosin separation and hue balance)
    and biological relevance (adipocyte coverage, structure variety,
    background quality); ranks by the weighted composite (0.4/0.35/0.25) and
    writes ``stain_reference_metadata.json``, which
    :meth:`adipose_tpu_torch.ops.stain.LabStats.from_metadata` reads.
  * ``validate_stain_normalization.py``: normalizes diverse samples with the
    chosen reference and checks that sharpness, entropy and the intensity
    range are preserved (``stain_normalization.py:206-260``).

The LAB conversion, the Laplacian variance and the Reinhard transfer run on
``device`` (default the card); Canny, the morphology, Sobel, HSV and the
histograms stay host cv2 and numpy, as in the JAX package.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.ops.color import rgb2lab
from adipose_tpu_torch.ops.qc import laplacian_variance

QUALITY_THRESHOLDS = {
    "min_laplacian_variance": 0.05,
    "min_entropy": 4.0,
    "min_local_contrast": 0.1,
    "max_edge_density": 0.30,
}
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def shannon_entropy(gray: np.ndarray) -> float:
    hist, _ = np.histogram(gray, bins=256, range=(0, 256))
    hist = hist[hist > 0]
    p = hist / hist.sum()
    return float(-np.sum(p * np.log2(p)))


def local_contrast_consistency(gray: np.ndarray, patch: int = 64, step: int = 32) -> float:
    """Inverse CV of patchwise Michelson contrast (selector :98-120)."""
    g = gray.astype(np.float32)
    h, w = g.shape
    contrasts = []
    for i in range(0, h - patch + 1, step):
        for j in range(0, w - patch + 1, step):
            p = g[i : i + patch, j : j + patch]
            if p.std() > 0:
                contrasts.append((p.max() - p.min()) / (p.max() + p.min() + 1e-10))
    if not contrasts:
        return 0.0
    c = np.asarray(contrasts)
    return float(min(1.0 / (c.std() / (c.mean() + 1e-10) + 1e-10), 1000))


def edge_density(gray: np.ndarray) -> float:
    edges = cv2.Canny(gray.astype(np.uint8), 100, 200)
    return float((edges > 0).mean())


def adipocyte_coverage(gray: np.ndarray) -> float:
    """Light-blob coverage after 20-px elliptical opening (selector :217-233)."""
    thr = np.percentile(gray, 70)
    mask = (gray > thr).astype(np.uint8)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (20, 20))
    cleaned = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    return float((cleaned > 0).mean())


def structure_variety(gray: np.ndarray) -> float:
    """Gradient-variance texture proxy (the selector's LBP fallback, :235-255),
    normalized to the selector's LBP-entropy scale."""
    sx = cv2.Sobel(gray, cv2.CV_64F, 1, 0, ksize=3)
    sy = cv2.Sobel(gray, cv2.CV_64F, 0, 1, ksize=3)
    mag = np.sqrt(sx**2 + sy**2)
    return float(min(np.log1p(mag.var()) / 3.0, 3.0))


def background_quality(gray: np.ndarray) -> float:
    mask = (gray < 30) | (gray > 220)
    if mask.sum() == 0:
        return 1.0
    return float(max(0.0, 1.0 - gray[mask].var() / 100.0))


def analyze_candidate(rgb: np.ndarray, device="cuda") -> dict:
    """Full metric set for one RGB uint8 candidate tile; LAB and the
    Laplacian variance on ``device``."""
    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    unit = torch.from_numpy(rgb.astype(np.float32) / 255.0).to(device)
    lab = rgb2lab(unit).cpu().numpy()
    a_ch, b_ch = lab[..., 1], lab[..., 2]
    b_bias = float(b_ch.mean())
    separation_score = float(
        (a_ch.max() - a_ch.min()) * (b_ch.max() - b_ch.min())
        * a_ch.var() * b_ch.var() * (1 + max(0.0, b_bias))
    )
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    hue_hist, _ = np.histogram(hsv[..., 0], bins=180, range=(0, 180))
    total = hsv[..., 0].size
    golden = hue_hist[25:42].sum() / total
    pink = (hue_hist[0:17].sum() + hue_hist[166:180].sum()) / total
    lap = laplacian_variance(torch.from_numpy(gray.astype(np.float32)).to(device)[None])
    return {
        "laplacian_variance": float(lap[0]) / 255.0**2,
        "entropy": shannon_entropy(gray),
        "local_contrast_consistency": local_contrast_consistency(gray),
        "edge_density": edge_density(gray),
        "lab_stats": {
            c: {"mean": float(lab[..., i].mean()), "std": float(lab[..., i].std())}
            for i, c in enumerate("LAB")
        },
        "stain_separation": {"separation_score": separation_score, "b_bias": b_bias},
        "color_balance": {
            "golden_ratio": float(golden),
            "pink_ratio": float(pink),
            "balance_score": float(min(golden, pink) * 2),
        },
        "adipocyte_coverage": adipocyte_coverage(gray),
        "structure_variety": structure_variety(gray),
        "background_quality": background_quality(gray),
    }


def composite_score(m: dict) -> dict:
    """Weighted 0.4/0.35/0.25 composite (selector :285-327)."""
    technical = (
        min(m["laplacian_variance"] / 0.3, 1.0) * 0.3
        + min(m["entropy"] / 8.0, 1.0) * 0.3
        + min(m["local_contrast_consistency"] / 1.0, 1.0) * 0.2
        + max(0.0, 1 - m["edge_density"] / 0.05) * 0.2
    )
    color = (
        min(m["lab_stats"]["B"]["std"] / 15.0, 1.0) * 0.4
        + min(m["stain_separation"]["separation_score"] / 2000.0, 1.0) * 0.4
        + m["color_balance"]["balance_score"] * 0.2
    )
    biological = (
        m["adipocyte_coverage"] * 0.4
        + min(m["structure_variety"] / 3.0, 1.0) * 0.3
        + m["background_quality"] * 0.3
    )
    return {
        "composite_score": technical * 0.4 + color * 0.35 + biological * 0.25,
        "technical_quality": technical,
        "color_characteristics": color,
        "biological_relevance": biological,
    }


def _image_files(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in IMAGE_EXTS)


def rank_candidates(candidate_dir: str | Path, max_candidates: int = 350,
                    device="cuda") -> list[dict]:
    """Every readable candidate's metrics and scores, best composite first
    (a stable sort, so ties keep path order)."""
    results = []
    for f in _image_files(Path(candidate_dir))[:max_candidates]:
        bgr = cv2.imread(str(f))
        if bgr is None:
            continue
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        metrics = analyze_candidate(rgb, device)
        results.append({"path": str(f), "name": f.name,
                        "metrics": metrics, "scores": composite_score(metrics)})
    results.sort(key=lambda r: r["scores"]["composite_score"], reverse=True)
    return results


def select_stain_reference(candidate_dir: str | Path, output_dir: str | Path,
                           max_candidates: int = 350, device="cuda") -> dict:
    """Rank candidates, write ``stain_reference_metadata.json`` and
    ``stain_reference_selection_report.md``."""
    candidate_dir, output_dir = Path(candidate_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = rank_candidates(candidate_dir, max_candidates, device)
    if not results:
        raise FileNotFoundError(f"no candidate tiles under {candidate_dir}")
    best = results[0]
    metadata = {
        "selected_reference": {
            "path": best["path"],
            "name": best["name"],
            "composite_score": best["scores"]["composite_score"],
            "stain_type": "SYBR Gold + Eosin",
        },
        "lab_statistics": best["metrics"]["lab_stats"],
        "selection_timestamp": datetime.now().isoformat(),
        "n_candidates": len(results),
    }
    (output_dir / "stain_reference_metadata.json").write_text(json.dumps(metadata, indent=2))
    report = [
        "# Stain reference selection report", "",
        f"candidates analyzed: {len(results)}", "",
        "| rank | tile | composite | technical | color | biological |",
        "|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(results[:20]):
        s = r["scores"]
        report.append(
            f"| {i + 1} | {r['name']} | {s['composite_score']:.3f} | "
            f"{s['technical_quality']:.3f} | {s['color_characteristics']:.3f} | "
            f"{s['biological_relevance']:.3f} |"
        )
    (output_dir / "stain_reference_selection_report.md").write_text("\n".join(report) + "\n")
    return metadata


def validate_normalization(source_rgb: np.ndarray, normalized_rgb: np.ndarray,
                           tolerance: float = 0.1) -> dict:
    """Metric-preservation validation (``stain_normalization.py:206-260``)."""
    def metrics(img):
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return {
            "sharpness": cv2.Laplacian(gray, cv2.CV_64F).var(),
            "entropy": shannon_entropy(gray),
            "mean_intensity": float(gray.mean()),
        }

    src, norm = metrics(source_rgb), metrics(normalized_rgb)
    out = {
        "sharpness_preserved": abs(norm["sharpness"] - src["sharpness"])
        / max(src["sharpness"], 1e-10) < tolerance,
        "entropy_preserved": abs(norm["entropy"] - src["entropy"])
        / max(src["entropy"], 1e-10) < tolerance,
        "intensity_reasonable": 50 <= norm["mean_intensity"] <= 200,
        "sharpness_ratio": norm["sharpness"] / max(src["sharpness"], 1e-10),
        "entropy_ratio": norm["entropy"] / max(src["entropy"], 1e-10),
        "mean_intensity_change": norm["mean_intensity"] - src["mean_intensity"],
    }
    out["overall_valid"] = (
        out["sharpness_preserved"] and out["entropy_preserved"]
        and out["intensity_reasonable"]
    )
    return out


def validate_stain_reference(metadata_path: str | Path, sample_dir: str | Path,
                             output_dir: str | Path, n_samples: int = 20,
                             device="cuda") -> dict:
    """Cross-validate the selected reference on diverse samples
    (``validate_stain_normalization.py`` behavior); Reinhard on ``device``."""
    from adipose_tpu_torch.ops.stain import LabStats, normalize_image

    ref = LabStats.from_metadata(metadata_path)
    sample_dir, output_dir = Path(sample_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for f in _image_files(sample_dir)[:n_samples]:
        bgr = cv2.imread(str(f))
        if bgr is None:
            continue
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        normed = normalize_image(rgb, ref, device=device).cpu().numpy()
        v = validate_normalization(rgb, normed)
        rows.append({"file": f.name,
                     **{k: (bool(x) if isinstance(x, (bool, np.bool_)) else float(x))
                        for k, x in v.items()}})
    summary = {
        "n_samples": len(rows),
        "n_valid": sum(r["overall_valid"] for r in rows),
        "samples": rows,
    }
    (output_dir / "stain_validation_report.json").write_text(
        json.dumps(summary, indent=2)
    )
    return summary
