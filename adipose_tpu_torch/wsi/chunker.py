"""WSI chunkers, adaptive (MS) and fixed grid (Lucy): the port's copy of
``adipose_tpu/wsi/chunker.py``.

Behavioral spec:
  * ``pre-post-processing_tools/large_wsi_to_small_wsi_MS.py``: greedy 6144^2
    primary tiles with 1024-multiple edge fallback (``generate_axis_segments``
    :486-511), 16->8-bit conversion (:119), optional inversion (:160),
    enhancement variants zscore/percentile/CLAHE (:182-298), coordinate-encoded
    names ``_x{X}_y{Y}_w{W}_h{H}``;
  * ``large_wsi_to_small_wsi_Lucy.py``: 2048-px tiles with 204-px overlap
    (stride 1844), the largest feasible grid 5x5 -> 2x2 under a size limit,
    names ``_grid_{N}x{N}_tile_{K}`` (:283-398).

Reading, slicing and writing stay on the host (cv2); the enhancement math
runs on ``device`` (default the card) and its uint8 result comes back.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.core.config import WSIChunkConfig
from adipose_tpu_torch.ops.clahe import _clahe_any_shape
from adipose_tpu_torch.ops.normalize import percentile_stretch_255, zscore_to_target


def generate_axis_segments(length: int, primary: int = 6144, multiple: int = 1024):
    """(offset, extent) spans tiling one axis, the MS coordinate contract
    (``..._MS.py:486-511``): greedy ``primary``-sized spans from 0, then one
    right-aligned trailing span whose extent is the remainder rounded up to
    ``multiple`` (capped at ``primary`` and at the axis length, so it may
    overlap the last full span)."""
    if length <= 0:
        return []
    spans = [(off, primary) for off in range(0, length - primary + 1, primary)]
    covered = len(spans) * primary
    if covered < length:
        extent = min(length, primary, -(-(length - covered) // multiple) * multiple)
        spans.append((length - extent, extent))
    return sorted(set(spans))


def convert_16_to_8bit(img: np.ndarray) -> np.ndarray:
    """Min-max 16->8-bit (``..._MS.py:119-158``; ``convert_tif_to_jpg.py:118``)
    on the host: ``(x - lo) / (hi - lo) * 255`` in float32, truncated; a
    constant image is all 0. Other integer depths are cast to uint8. The
    formula is evaluated once per value in [lo, hi], as a lookup table
    (``adipose_tpu/core/native.py``'s numpy path, value for value)."""
    if img.dtype != np.uint16:
        return img.astype(np.uint8) if img.dtype != np.uint8 else img
    lo, hi = int(img.min()), int(img.max())
    if hi == lo:
        return np.zeros(img.shape, np.uint8)
    lut = np.zeros(65536, np.uint8)
    lut[lo: hi + 1] = (np.arange(lo, hi + 1).astype(np.float32) - lo) / (hi - lo) * 255
    return lut[img]


def enhance(img: np.ndarray, method: str = "none", device="cuda") -> np.ndarray:
    """Enhancement variants (``..._MS.py:182-298``) on ``device``: the chunk
    goes up at its own dtype, the float32 result is truncated to uint8 there
    (each variant lies in [0, 255]) and comes back."""
    if method == "none":
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(torch.float32)
    if method == "zscore":
        out = zscore_to_target(x)
    elif method == "percentile":
        out = percentile_stretch_255(x)
    elif method == "clahe":
        out = _clahe_any_shape(x, 2.0, 8)
    else:
        raise ValueError(f"unknown enhancement: {method}")
    return out.to(torch.uint8).cpu().numpy()


def convert_bit_depth(img: np.ndarray, mode: str = "auto") -> np.ndarray:
    """``--bit-depth`` auto|8|16 (``..._MS.py:658-660``): auto/8 min-max to
    u8; 16 keeps the source depth."""
    if mode == "16":
        return img
    return convert_16_to_8bit(img)


def _chunk_ext(cfg: WSIChunkConfig) -> tuple:
    """(extension, imwrite params) from ``--output-format``."""
    fmt = cfg.output_format.lower()
    if fmt in ("png",):
        return ".png", []
    if fmt in ("tif", "tiff"):
        return ".tif", []
    return ".jpg", [cv2.IMWRITE_JPEG_QUALITY, 95]


def chunk_wsi_adaptive(image_path: str | Path, output_dir: str | Path,
                       cfg: WSIChunkConfig | None = None, dry_run: bool = False,
                       device="cuda") -> list:
    """MS adaptive chunker. Returns the written chunk paths; names carry
    ``_x{X}_y{Y}_w{W}_h{H}``. ``dry_run`` returns the planned paths and
    writes nothing (``..._MS.py:565-567``). With ``save_enhanced`` a gray
    chunk's enhanced form (CLAHE when no enhancement is set) also goes to
    ``enhanced/``."""
    cfg = cfg or WSIChunkConfig()
    image_path, output_dir = Path(image_path), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    img = cv2.imread(str(image_path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cannot read {image_path}")
    if cfg.convert_16to8:
        img = convert_bit_depth(img, cfg.bit_depth)
    if cfg.invert:
        img = (np.iinfo(img.dtype).max if np.issubdtype(img.dtype, np.integer)
               else 255) - img
    h, w = img.shape[:2]
    ext, params = _chunk_ext(cfg)
    written = []
    enhanced_dir = output_dir / "enhanced"
    for y, th in generate_axis_segments(h, cfg.primary_tile, cfg.edge_multiple):
        for x, tw in generate_axis_segments(w, cfg.primary_tile, cfg.edge_multiple):
            name = f"{image_path.stem}_x{x}_y{y}_w{tw}_h{th}{ext}"
            out = output_dir / name
            if dry_run:
                written.append(out)
                continue
            chunk = img[y: y + th, x: x + tw]
            if chunk.ndim == 2 and cfg.enhancement != "none":
                chunk = enhance(chunk, cfg.enhancement, device)
            cv2.imwrite(str(out), chunk, params)
            if cfg.save_enhanced and chunk.ndim == 2:
                enhanced_dir.mkdir(parents=True, exist_ok=True)
                # the chunk already holds the configured enhancement
                ev = chunk if cfg.enhancement != "none" else enhance(chunk, "clahe", device)
                cv2.imwrite(str(enhanced_dir / name), ev, params)
            written.append(out)
    return written


def chunk_directory(input_dir: str | Path, output_dir: str | Path,
                    cfg: WSIChunkConfig | None = None, mode: str = "adaptive",
                    extensions: tuple = (".tif", ".tiff", ".png", ".jpg", ".jpeg"),
                    skip_existing: bool = False, dry_run: bool = False,
                    device="cuda") -> dict:
    """Directory driver (``..._MS.py:686-828``): images whose dimensions
    exceed ``max_dimension_px`` or whose file size exceeds ``max_chunk_mb``
    are chunked; smaller ones are skipped as "small" (the reference gate,
    :754; ``--min-dimension-px`` is dead there and kept for flag parity).
    ``skip_existing`` skips inputs that already have chunks in the output
    dir. Dimensions come from the header (PIL), not a decode; a file PIL
    refuses, as it refuses one over 2 x ``Image.MAX_IMAGE_PIXELS`` pixels,
    is skipped as "unreadable", as in the JAX package."""
    cfg = cfg or WSIChunkConfig()
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {"processed": [], "skipped": [], "outputs": []}
    for p in sorted(input_dir.iterdir()):
        if not p.is_file() or p.suffix.lower() not in extensions:
            continue
        try:
            from PIL import Image

            with Image.open(p) as im:  # header only, no pixel decode
                w, h = im.size
        except Exception:
            report["skipped"].append({"file": p.name, "reason": "unreadable"})
            continue
        size_mb = p.stat().st_size / 2**20
        if w <= cfg.max_dimension_px and h <= cfg.max_dimension_px \
                and size_mb <= cfg.max_chunk_mb:
            report["skipped"].append({"file": p.name, "reason": "small"})
            continue
        marker = "_grid_" if mode == "grid" else "_x"
        if skip_existing and any(output_dir.glob(f"{p.stem}{marker}*")):
            report["skipped"].append({"file": p.name, "reason": "exists"})
            continue
        if mode == "adaptive":
            outs = chunk_wsi_adaptive(p, output_dir, cfg, dry_run=dry_run, device=device)
        else:
            outs = chunk_wsi_grid(p, output_dir, cfg, dry_run=dry_run)
        report["processed"].append({"file": p.name, "mode": mode, "n_chunks": len(outs)})
        report["outputs"].extend(str(o) for o in outs)
    return report


def chunk_wsi_grid(image_path: str | Path, output_dir: str | Path,
                   cfg: WSIChunkConfig | None = None, preferred_grids: tuple = (5, 4, 3, 2),
                   max_file_size_mb: float = 50.0, dry_run: bool = False) -> list:
    """Lucy fixed-grid chunker (host only): overlapping 2048/204 tiles grouped
    into the largest feasible N x N piece (``..._Lucy.py:283-398``). Names:
    ``_grid_{N}x{N}_tile_{K}`` with K row-major."""
    cfg = cfg or WSIChunkConfig()
    tile, overlap = cfg.grid_tile, cfg.grid_overlap
    stride = tile - overlap
    image_path, output_dir = Path(image_path), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    img = cv2.imread(str(image_path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cannot read {image_path}")
    if cfg.convert_16to8:
        img = convert_16_to_8bit(img)
    h, w = img.shape[:2]
    total_cols = 1 + max(0, int(np.ceil((w - tile) / stride)))
    total_rows = 1 + max(0, int(np.ceil((h - tile) / stride)))

    def piece_dim(g):
        return tile + (g - 1) * stride

    grid = None
    for g in preferred_grids:
        if g > total_cols or g > total_rows:
            continue
        d = piece_dim(g)
        est_mb = d * d * (img.itemsize if img.ndim == 2 else 3 * img.itemsize) * 0.15 / 2**20
        if est_mb <= max_file_size_mb:
            grid = g
            break
    if grid is None:
        grid = 1

    written = []
    k = 0
    for r0 in range(0, total_rows, grid):
        for c0 in range(0, total_cols, grid):
            d = piece_dim(min(grid, total_rows - r0, total_cols - c0))
            y = min(r0 * stride, max(0, h - d))
            x = min(c0 * stride, max(0, w - d))
            name = f"{image_path.stem}_grid_{grid}x{grid}_tile_{k}.jpg"
            if not dry_run:
                cv2.imwrite(str(output_dir / name), img[y: y + d, x: x + d],
                            [cv2.IMWRITE_JPEG_QUALITY, 95])
            written.append(output_dir / name)
            k += 1
    return written
