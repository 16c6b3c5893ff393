"""Tile planning and the segmentation dataset builder: the port's copy of
``adipose_tpu/data/tiling.py``, with its per-tile device work in plain
batched PyTorch on the builder's device.

Behavioral spec: ``Segmentation/build_dataset.py``:
  * ``tile_coords`` (:1287-1307): ceil-step grid with edge clamping;
  * pipeline (:1952-2110): slide discovery + slide-level confidence gate ->
    parallel mask rasterization -> target-mask prep (fat - bubbles +
    cleanup) -> tiling with white/blur QC (``classify_tiles_batch``
    :1253-1284) -> per-tile confidence filter -> ambiguous-tile exclusion
    (0 < ratio < min_mask_ratio, :1571) -> negative sampling so negatives
    are ``neg_pct`` of the kept set (:1589-1632) -> slide-grouped
    train/val/test split (:1654-1783) -> timestamped
    ``_build_YYYYMMDD_HHMMSS`` root with ``build_log.json``/
    ``build_summary.txt`` (:205-422);
  * tile names ``{base}_r{ri}_c{ci}.jpg``: the coordinate contract every
    downstream tool parses (eval slide grouping, WSI reconstruction).

On the device: the per-tile Reinhard stain transfer, the white/blur QC and
the grayscale, one chunk of ``qc_batch`` tiles at a time. A chunk goes up
once as uint8 RGB (3 MB a 1024^2 tile) and only the uint8 grayscale (1 MB)
and the QC verdicts come back. Rasterization, the negative sampling and the
split stay on the host, the last two with ``np.random.default_rng(seed)``
as in the JAX package, so both packages pick the same tiles.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

import cv2
import numpy as np
import torch

from adipose_tpu_torch.core.config import DataBuildConfig
from adipose_tpu_torch.data.rasterize import (
    create_binary_mask,
    get_tile_annotations,
    load_json_annotations,
    prepare_target_mask,
    slide_has_valid_annotations,
)
from adipose_tpu_torch.ops.qc import _cv2_gray, classify_tiles_batch
from adipose_tpu_torch.ops.stain import DEFAULT_REFERENCE, LabStats, reinhard_normalize_batch


def _device_rgb_qc(tiles_u8: torch.Tensor, ref_mean: torch.Tensor, ref_std: torch.Tensor,
                   white_t, white_r, blur_t, stain: bool):
    """The device work of one (B, H, W, 3) uint8 RGB chunk, on its device:
    optional per-tile Reinhard, QC verdicts, cv2-exact grayscale. Returns
    ((B, H, W) uint8 gray, the verdict dict of (B,) tensors).

    ``floor`` then ``clip`` reproduces the reference's host
    ``astype(np.uint8)`` truncation of the normalized tile (lab2rgb clips to
    [0, 1], so no value wraps)."""
    x = tiles_u8.to(torch.float32)
    if stain:
        n = reinhard_normalize_batch(x / 255.0, ref_mean, ref_std)
        x = torch.floor(n * 255.0).clamp(0.0, 255.0)
    v = classify_tiles_batch(x, white_t, white_r, blur_t)
    return _cv2_gray(x).to(torch.uint8), v


def _axis_offsets(extent: int, tile: int, stride: int) -> np.ndarray:
    """Edge-clamped ceil-step offsets along one axis: the last tile is pulled
    back so it ends exactly at ``extent`` (every offset is
    ``min(i * stride, extent - tile)``, ``build_dataset.py:1287-1307``)."""
    n = max(1, math.ceil((extent - tile) / stride) + 1)
    return np.minimum(np.arange(n) * stride, extent - tile)


def tile_coords(h: int, w: int, tile: int, stride: int):
    """(ri, ci, ys, xs) grid covering the image (``build_dataset.py:1287-1307``)."""
    if h < tile or w < tile:
        return []
    ys, xs = _axis_offsets(h, tile, stride), _axis_offsets(w, tile, stride)
    ri, ci = np.divmod(np.arange(ys.size * xs.size), xs.size)
    grid = np.stack([ri, ci, ys[ri], xs[ci]], axis=1)
    return [tuple(row) for row in grid.tolist()]


@dataclass
class SlideSource:
    """One input slide: image + target-class annotation JSON (+ optional
    subtract-class JSON). ``fat_json``/``bubble_json`` are the target and
    subtract annotations, named for the default classes (``--target-mask
    fat --subtract-class bubbles``)."""

    base: str
    image_path: Path
    fat_json: Path | None = None
    bubble_json: Path | None = None
    is_test: bool = False


def discover_slides(data_root: str | Path, min_confidence: int = 1,
                    target: str = "fat", subtract: str | None = "bubbles",
                    images_dir: str | Path | None = None,
                    masks_dir: str | Path | None = None,
                    include_test_set: bool = True,
                    exclude_test_duplicates: bool = True):
    """Reference layout discovery: ``Pseudocolored/`` images with
    ``Masks/<target>/<base>*.json`` annotations (+ ``Masks/<subtract>``), plus
    ``Pseudocolored/test/`` external test slides (``build_dataset.py:609-722``).
    Slides whose annotations all fall below ``min_confidence`` are skipped.
    ``images_dir``/``masks_dir`` override the default layout
    (``--input-images-dir``/``--input-masks-dir``, :1964-1974); main-folder
    slides duplicated in ``test/`` are dropped when ``exclude_test_duplicates``
    (:1941-1944)."""
    root = Path(data_root)
    pseudo = Path(images_dir) if images_dir else root / "Pseudocolored"
    masks_root = Path(masks_dir) if masks_dir else root / "Masks"
    img_exts = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    slides = []

    def _find_json(mask_dir: Path, base: str):
        if not mask_dir.exists():
            return None
        for cand in sorted(mask_dir.glob(f"{base}*.json")):
            return cand
        return None

    sources = [(pseudo, False)]
    test_bases: set = set()
    if include_test_set and (pseudo / "test").exists():
        sources.append((pseudo / "test", True))
        if exclude_test_duplicates:
            test_bases = {p.stem for p in (pseudo / "test").iterdir()
                          if p.suffix.lower() in img_exts}
    for subdir, is_test in sources:
        if not subdir.exists():
            continue
        for img in sorted(subdir.iterdir()):
            if img.suffix.lower() not in img_exts or not img.is_file():
                continue
            base = img.stem
            if not is_test and base in test_bases:
                continue
            tgt = _find_json(masks_root / target, base)
            sub = _find_json(masks_root / subtract, base) if subtract else None
            if tgt is not None and not slide_has_valid_annotations(tgt, min_confidence):
                continue
            slides.append(SlideSource(base, img, tgt, sub, is_test))
    return slides


@dataclass
class BuildStats:
    masks_built: int = 0
    tiles_total: int = 0
    tiles_kept_pos: int = 0
    tiles_kept_neg: int = 0
    tiles_skipped_empty: int = 0
    tiles_skipped_blurry: int = 0
    tiles_skipped_ambiguous: int = 0
    tiles_skipped_low_conf: int = 0
    neg_candidates: int = 0
    split_counts: dict = field(default_factory=dict)


class SegmentationDatasetBuilder:
    """``device``: where the per-tile stain, QC and grayscale run; a
    ``cuda`` builder runs them on the card or raises, never on the CPU.
    ``timings`` holds the last build's seconds by stage on the host clock:
    ``rasterize_s`` (waiting on the mask threads), ``tile_s`` (decode,
    device QC and the per-tile gates), ``write_s`` (JPEG/TIFF encode)."""

    def __init__(self, cfg: DataBuildConfig | None = None,
                 build_root: str | Path | None = None,
                 out_parent: str | Path = ".",
                 qc_batch: int = 16,
                 device="cuda"):
        self.cfg = cfg or DataBuildConfig()
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        # `_build{_ecm}_{timestamp}` naming (build_dataset.py:1977-1983)
        suffix = "_ecm" if self.cfg.channel == "ecm" else ""
        self.build_root = (
            Path(build_root)
            if build_root
            else Path(out_parent) / f"_build{suffix}_{ts}"
        )
        self.qc_batch = qc_batch
        self.device = torch.device(device)
        self.stats = BuildStats()
        self.timings: dict[str, float] = {}

    # -- stage 1: masks -------------------------------------------------------

    def _load_external_subtract(self, base: str, shape) -> np.ndarray | None:
        """``--subtract-masks-dir``: external mask files to subtract
        (``build_dataset.py:1149-1155``)."""
        d = self.cfg.subtract_masks_dir
        if not d:
            return None
        for cand in sorted(Path(d).glob(f"{base}*")):
            if cand.suffix.lower() in (".tif", ".tiff", ".png"):
                m = cv2.imread(str(cand), cv2.IMREAD_UNCHANGED)
                if m is not None and m.shape[:2] == shape:
                    return (m > 0).astype(np.uint8)
        return None

    def build_slide_mask(self, slide: SlideSource) -> np.ndarray | None:
        """Rasterize target - subtract into the slide-size mask, with the
        reference's cleanup knobs (``--morph-close-k``/``--min-cc-px``) and
        mask reuse under ``--no-make-masks`` (:1139-1194)."""
        img = cv2.imread(str(slide.image_path), cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        h, w = img.shape[:2]
        cfg = self.cfg
        mask_path = (self.build_root / "masks" / cfg.target_mask /
                     f"{slide.base}.tif")
        if not cfg.make_masks:
            m = cv2.imread(str(mask_path), cv2.IMREAD_UNCHANGED)
            if m is not None:
                return (m > 0).astype(np.uint8)
            # fall through: nothing to reuse, rasterize anyway
        if slide.fat_json is None:
            mask = np.zeros((h, w), np.uint8)
        else:
            polys, _ = load_json_annotations(slide.fat_json, cfg.min_confidence_train)
            target = create_binary_mask(polys, w, h)
            subtract = None
            if cfg.subtract:
                if slide.bubble_json is not None:
                    bpolys, _ = load_json_annotations(slide.bubble_json, 1)
                    subtract = create_binary_mask(bpolys, w, h)
                ext = self._load_external_subtract(slide.base, (h, w))
                if ext is not None:
                    subtract = ext if subtract is None else np.maximum(subtract, ext)
            mask = prepare_target_mask(
                target, subtract,
                close_kernel=cfg.morph_close_k,
                min_component_area=cfg.min_cc_px,
            )
        if cfg.make_masks:
            mask_path.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(mask_path), mask * 255, self._tiff_params())
        if cfg.make_overlays:
            self._write_overlay(slide, img, mask)
        return mask

    def _tiff_params(self):
        """cv2 TIFF compression params from ``--compression``
        (``build_dataset.py:186`` / ``_save_tiff_mask``)."""
        comp = {"auto": 5, "lzw": 5, "packbits": 32773, "none": 1}.get(
            self.cfg.compression, 5)
        return [cv2.IMWRITE_TIFF_COMPRESSION, comp]

    def _write_overlay(self, slide: SlideSource, img: np.ndarray,
                       mask: np.ndarray) -> None:
        """QA overlay: target contours on the slide (``build_dataset.py:
        954-959``; OVERLAY_COLORS :153-157, fat yellow in BGR)."""
        colors = {"bubbles": (255, 0, 0), "fat": (0, 255, 255),
                  "muscle": (0, 0, 255)}
        if img.dtype == np.uint16:
            img = (img / 257.0).astype(np.uint8)
        over = img if img.ndim == 3 else cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        over = over.copy()
        contours, _ = cv2.findContours(mask.astype(np.uint8),
                                       cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(over, contours, -1,
                         colors.get(self.cfg.target_mask, (0, 255, 255)), 2)
        d = self.build_root / "overlays"
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{slide.base}_overlay.jpg"), over,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])

    # -- stage 2: tiling + QC + filters ---------------------------------------

    @staticmethod
    def _to_host(verdicts: dict) -> list[dict]:
        """A chunk's (B,) verdict tensors as one dict of numpy scalars per
        tile (one copy per verdict)."""
        vh = {k: a.cpu().numpy() for k, a in verdicts.items()}
        return [{k: a[j] for k, a in vh.items()} for j in range(len(vh["is_good"]))]

    def _qc_batchwise(self, tiles: list) -> list:
        """QC over gray tiles on the device, ``qc_batch`` at a time; returns
        verdict dicts."""
        out = []
        cfg = self.cfg
        for i in range(0, len(tiles), self.qc_batch):
            # uploaded as uint8 (4x fewer bytes than float32); QC casts on the device
            chunk = torch.from_numpy(np.stack(tiles[i : i + self.qc_batch])).to(self.device)
            out.extend(self._to_host(classify_tiles_batch(
                chunk, cfg.white_threshold, cfg.white_ratio, cfg.blur_threshold)))
        return out

    def _rgb_qc(self, rgb: np.ndarray, coords) -> tuple[list, list]:
        """Crop, optional per-tile Reinhard, QC on the (normalized) colour
        tile and grayscale, one device call per ``qc_batch`` chunk
        (reference order, ``build_dataset.py:1211-1284``)."""
        cfg = self.cfg
        t = cfg.tile_size
        if cfg.apply_stain_norm:
            ref_mean, ref_std = self._stain_reference().as_arrays(self.device)
        else:  # unused: the stain branch is skipped
            ref_mean = ref_std = None
        tiles_gray, verdicts = [], []
        for i in range(0, len(coords), self.qc_batch):
            chunk = np.stack([rgb[ys : ys + t, xs : xs + t]
                              for (_, _, ys, xs) in coords[i : i + self.qc_batch]])
            gray, v = _device_rgb_qc(
                torch.from_numpy(chunk).to(self.device), ref_mean, ref_std,
                cfg.white_threshold, cfg.white_ratio, cfg.blur_threshold,
                stain=cfg.apply_stain_norm)
            tiles_gray.extend(gray.cpu().numpy())
            verdicts.extend(self._to_host(v))
        return tiles_gray, verdicts

    def tile_slide(self, slide: SlideSource, mask: np.ndarray):
        """Returns list of dicts: {name, image(2D u8), mask(2D u8), pos_ratio,
        keep status}. Applies QC, confidence, ambiguity gates with the
        reference's per-split semantics (``build_dataset.py:1454-1630``):
        test slides use ``test_stride``/``test_min_confidence``/
        ``test_min_mask_ratio``; white/blur verdicts route tiles OUT of the
        dataset (only 'tissue' gets a mask) with ``test_include_white/blurry``
        promoting them back for test; ``include_ambiguous`` keeps sub-threshold
        test tiles as zero-mask negatives."""
        cfg = self.cfg
        img = cv2.imread(str(slide.image_path), cv2.IMREAD_UNCHANGED)
        if img is None:
            return []
        if img.ndim == 3:
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            gray = img
            rgb = None
        if gray.dtype == np.uint16:
            gray = (gray / 257.0).astype(np.uint8)
        if cfg.invert_input:  # black-on-white inputs (:1853-1854)
            gray = 255 - gray
            if rgb is not None:
                rgb = 255 - rgb
        h, w = gray.shape
        stride = cfg.test_stride if slide.is_test else cfg.stride
        coords = tile_coords(h, w, cfg.tile_size, stride)
        if not coords:
            return []
        min_conf = (
            cfg.test_min_confidence if slide.is_test else cfg.min_confidence_train
        )
        min_ratio = cfg.test_min_mask_ratio if slide.is_test else cfg.ambiguous_high

        if rgb is not None:
            tiles_gray, verdicts = self._rgb_qc(rgb, coords)
        else:
            # host slicing (exact, as the JAX package's native gather)
            tiles_gray = [gray[ys : ys + cfg.tile_size, xs : xs + cfg.tile_size]
                          for (_, _, ys, xs) in coords]
            verdicts = self._qc_batchwise(tiles_gray)

        results = []
        for (ri, ci, ys, xs), tile_img, v in zip(coords, tiles_gray, verdicts):
            self.stats.tiles_total += 1
            name = f"{slide.base}_r{ri}_c{ci}"
            cls = ("empty" if bool(v["is_empty"])
                   else "blurry" if bool(v["is_blurry"]) else "tissue")
            if cfg.protect_positives and cls != "tissue":
                # class-build semantics: QC filters only negatives; kept
                # white/blurry tiles remain dataset-eligible (:692-702)
                pos_here = float(
                    mask[ys : ys + cfg.tile_size, xs : xs + cfg.tile_size].mean())
                keep_flag = cfg.keep_white if cls == "empty" else cfg.keep_blurry
                if not keep_flag and pos_here == 0:
                    if cls == "empty":
                        self.stats.tiles_skipped_empty += 1
                    else:
                        self.stats.tiles_skipped_blurry += 1
                    continue
                cls = "tissue"
            if cls == "empty" and not cfg.keep_white:
                self.stats.tiles_skipped_empty += 1
                continue
            if cls == "blurry" and not cfg.keep_blurry:
                self.stats.tiles_skipped_blurry += 1
                continue
            if slide.is_test:
                if cls == "empty" and cfg.test_include_white:
                    cls = "tissue"
                elif cls == "blurry" and cfg.test_include_blurry:
                    cls = "tissue"
            if cls != "tissue":
                # kept as QA artifact only, not dataset-eligible (:1546-1548)
                self._write_qa_tile(cls, name, tile_img)
                if cls == "empty":
                    self.stats.tiles_skipped_empty += 1
                else:
                    self.stats.tiles_skipped_blurry += 1
                continue
            m_tile = mask[ys : ys + cfg.tile_size, xs : xs + cfg.tile_size]
            pos_ratio = float(m_tile.mean())
            if pos_ratio > 0 and slide.fat_json is not None:
                bbox = (xs, ys, xs + cfg.tile_size, ys + cfg.tile_size)
                _, low_conf_only = get_tile_annotations(slide.fat_json, bbox, min_conf)
                if low_conf_only:
                    self.stats.tiles_skipped_low_conf += 1
                    continue
            if 0 < pos_ratio < min_ratio:
                if not (slide.is_test and cfg.include_ambiguous):
                    self.stats.tiles_skipped_ambiguous += 1
                    continue
                # test + include-ambiguous: zero-mask negative (:1625-1630)
                m_tile = np.zeros_like(m_tile)
                pos_ratio = 0.0
            results.append({
                "name": name,
                "image": tile_img,
                "mask": (m_tile > 0).astype(np.uint8) * 255,
                "pos_ratio": pos_ratio,
                "is_test": slide.is_test,
                "base": slide.base,
            })
        return results

    def _stain_reference(self) -> LabStats:
        """Resolve the Reinhard reference: ``--reference-path`` image ->
        ``--reference-metadata`` JSON -> built-in default
        (``build_dataset.py:1409-1436``)."""
        cfg = self.cfg
        if cfg.reference_path:
            ref_img = cv2.imread(str(cfg.reference_path), cv2.IMREAD_COLOR)
            if ref_img is not None:
                rgb = cv2.cvtColor(ref_img, cv2.COLOR_BGR2RGB)
                return LabStats.from_image(rgb.astype(np.float32) / 255.0, self.device)
        if cfg.reference_metadata:
            try:
                return LabStats.from_metadata(cfg.reference_metadata)
            except (OSError, KeyError, ValueError):
                pass
        return DEFAULT_REFERENCE

    def _write_qa_tile(self, cls: str, name: str, tile_img: np.ndarray) -> None:
        """Route white/blurry tiles into ``tiles/{empty,blurry}`` for QA
        (``build_dataset.py:1401-1403``)."""
        d = self.build_root / "tiles" / cls
        d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / f"{name}.jpg"), tile_img,
                    [cv2.IMWRITE_JPEG_QUALITY, self.cfg.jpeg_quality])

    # -- stage 3: negative sampling + split -----------------------------------

    def sample_negatives(self, tiles: list) -> list:
        """Keep positives; sample negatives per split semantics
        (``build_dataset.py:1589-1632``): the training pool targets
        ``negative_fraction`` of the FINAL set (n = f/(1-f) * n_pos); the
        external test set keeps ``test_neg_pct`` of its negative CANDIDATES
        (default 1.0 = all, :1611-1622)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        pool = [t for t in tiles if not t["is_test"]]
        test = [t for t in tiles if t["is_test"]]
        pos = [t for t in pool if t["pos_ratio"] > 0]
        neg = [t for t in pool if t["pos_ratio"] == 0]
        self.stats.neg_candidates = len(neg)
        f = max(0.0, min(cfg.negative_fraction, 0.99))
        target = int(round((f / max(1e-9, 1.0 - f)) * len(pos)))
        target = min(target, len(neg))
        chosen = (
            [neg[i] for i in rng.choice(len(neg), size=target, replace=False)]
            if target > 0
            else []
        )
        t_pos = [t for t in test if t["pos_ratio"] > 0]
        t_neg = [t for t in test if t["pos_ratio"] == 0]
        ft = max(0.0, min(cfg.test_neg_pct, 1.0))
        n_t = len(t_neg) if ft >= 1.0 else int(round(ft * len(t_neg)))
        t_chosen = (
            t_neg if n_t >= len(t_neg)
            else [t_neg[i] for i in rng.choice(len(t_neg), size=n_t, replace=False)]
        )
        self.stats.tiles_kept_pos = len(pos) + len(t_pos)
        self.stats.tiles_kept_neg = len(chosen) + len(t_chosen)
        return pos + chosen + t_pos + t_chosen

    def split_tiles(self, tiles: list) -> dict:
        """Slide-grouped split (``build_dataset.py:1710-1745``): external test
        tiles go to test; remaining slides shuffle-split by val/test ratios.
        ``--no-split-by-slide`` splits at tile level instead (:179)."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        external_test = [t for t in tiles if t["is_test"]]
        train_pool = [t for t in tiles if not t["is_test"]]
        groups: dict = {}
        if cfg.split_by_slide:
            for t in train_pool:
                groups.setdefault(t["base"], []).append(t)
        else:
            for i, t in enumerate(train_pool):
                groups[f"tile{i}"] = [t]
        slides = list(groups)
        rng.shuffle(slides)
        n_test = (
            max(1, int(len(slides) * cfg.test_fraction)) if cfg.test_fraction > 0 and slides else 0
        )
        n_test = min(n_test, len(slides))
        test_slides = set(slides[:n_test])
        remaining = slides[n_test:]
        n_val = (
            max(1, int(len(remaining) * cfg.val_fraction)) if cfg.val_fraction > 0 and remaining else 0
        )
        n_val = min(n_val, len(remaining))
        val_slides = set(remaining[:n_val])

        out = {"train": [], "val": [], "test": list(external_test)}
        for s, items in groups.items():
            if s in test_slides:
                out["test"].extend(items)
            elif s in val_slides:
                out["val"].extend(items)
            else:
                out["train"].extend(items)
        return out

    # -- driver ---------------------------------------------------------------

    def build(self, data_root: str | Path,
              images_dir: str | Path | None = None,
              masks_dir: str | Path | None = None,
              mark_all_test: bool = False) -> Path:
        """``mark_all_test`` builds an ISOLATED test set: every discovered
        slide routes to the test split with the test-specific gates, the
        standalone test-set builder (``build_test_dataset.py:113-135``)."""
        cfg = self.cfg
        slides = discover_slides(
            data_root, cfg.min_confidence_train,
            target=cfg.target_mask, subtract=cfg.subtract_class,
            images_dir=images_dir, masks_dir=masks_dir,
            include_test_set=cfg.include_test_set,
            exclude_test_duplicates=cfg.exclude_test_duplicates,
        )
        if mark_all_test:
            slides = [dataclasses.replace(s, is_test=True) for s in slides]
        if not slides:
            raise FileNotFoundError(f"no slides discovered under {data_root}")
        # rasterization runs on threads across slides (the reference's
        # multiprocessing.Pool stage, :1010-1018; cv2.fillPoly releases the
        # GIL); tiling stays serial (device QC chunks)
        n_workers = cfg.workers or max(1, (os.cpu_count() or 2) - 1)
        self.timings = {"rasterize_s": 0.0, "tile_s": 0.0, "write_s": 0.0}
        all_tiles = []
        # window by worker count: full-resolution slide masks are ~100s of MB
        # each, so rasterize at most n_workers concurrently and tile them
        # before the next window (no whole-dataset mask barrier)
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for i in range(0, len(slides), n_workers):
                window = slides[i : i + n_workers]
                masks = pool.map(self.build_slide_mask, window)
                for slide in window:
                    t0 = time.perf_counter()
                    mask = next(masks)
                    t1 = time.perf_counter()
                    self.timings["rasterize_s"] += t1 - t0
                    if mask is None:
                        continue
                    self.stats.masks_built += 1
                    all_tiles.extend(self.tile_slide(slide, mask))
                    self.timings["tile_s"] += time.perf_counter() - t1
        kept = self.sample_negatives(all_tiles)
        splits = self.split_tiles(kept)
        tiff_params = self._tiff_params()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for split, tiles in splits.items():
                img_dir = self.build_root / "dataset" / split / "images"
                msk_dir = self.build_root / "dataset" / split / "masks"
                img_dir.mkdir(parents=True, exist_ok=True)
                msk_dir.mkdir(parents=True, exist_ok=True)

                def write_tile(t, img_dir=img_dir, msk_dir=msk_dir):
                    cv2.imwrite(str(img_dir / f"{t['name']}.jpg"), t["image"],
                                [cv2.IMWRITE_JPEG_QUALITY, cfg.jpeg_quality])
                    cv2.imwrite(str(msk_dir / f"{t['name']}.tif"), t["mask"],
                                tiff_params)

                # JPEG/TIFF encode releases the GIL; writes are independent
                list(pool.map(write_tile, tiles))
                self.stats.split_counts[split] = len(tiles)
        self.timings["write_s"] = time.perf_counter() - t0
        self._write_logs(data_root, slides)
        return self.build_root

    def _write_logs(self, data_root, slides):
        """``build_log.json`` + ``build_summary.txt`` (``build_dataset.py:205-422``)."""
        log = {
            "timestamp": datetime.now().isoformat(),
            "data_root": str(data_root),
            "n_slides": len(slides),
            "config": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in vars(self.cfg).items()},
            "stats": vars(self.stats).copy(),
        }
        (self.build_root / "build_log.json").write_text(json.dumps(log, indent=2, default=str))
        # the standalone test-set builder's artifact name
        # (build_test_dataset.py:999); same content, kept for both flows
        (self.build_root / "build_summary.json").write_text(
            json.dumps(log, indent=2, default=str))
        s = self.stats
        summary = [
            "=== adipose_tpu dataset build summary ===",
            f"slides: {len(slides)}   masks built: {s.masks_built}",
            f"tiles examined: {s.tiles_total}",
            f"kept: {s.tiles_kept_pos} positive + {s.tiles_kept_neg} negative",
            f"skipped: {s.tiles_skipped_empty} empty/white, {s.tiles_skipped_blurry} blurry, "
            f"{s.tiles_skipped_ambiguous} ambiguous, {s.tiles_skipped_low_conf} low-confidence",
            f"splits: {s.split_counts}",
        ]
        (self.build_root / "build_summary.txt").write_text("\n".join(summary) + "\n")


def find_most_recent_build_dir(base: str | Path) -> Path:
    """The newest ``_build_<YYYYmmdd_HHMMSS>`` (or ``_build_ecm_...``) under
    ``base``, else ``base/_build`` (``train_adipose_unet_v3.py:128-165``)."""
    base = Path(base)
    builds = []
    for p in base.glob("_build*"):
        m = re.search(r"_build(?:_ecm)?_(\d{8}_\d{6})$", p.name)
        if m:
            builds.append((m.group(1), p))
    if builds:
        return sorted(builds, reverse=True)[0][1]
    if (base / "_build").exists():
        return base / "_build"
    raise FileNotFoundError(f"No build directories found in {base}")
