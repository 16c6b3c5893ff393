"""Classification tile-dataset builder (adipose / not_adipose folders): the
port's copy of ``adipose_tpu/data/class_builder.py``, on the segmentation
builder's device tiling.

Behavioral spec: ``Classification/build_class_dataset.py``:
  * slides tile into Keras-style class folders
    ``dataset/{train,val,test}/{adipose,not_adipose}/*.jpg`` (:639-720);
  * label = adipose when tile mask coverage >= 2.5 % (default) (:128-129,
    :683-690);
  * split-specific annotation confidence: train >= 1, val/test >= 2 (:639-647);
  * quality (white/blur) filters apply ONLY to negatives; positives are
    always kept (:692-702);
  * class balancing by undersampling negatives until adipose is ~40 % of the
    split (:721-784);
  * per-split manifest CSVs (:862-872) + balance report (:787-859) +
    ``config.json`` dump (:210-214).

The manifests are written byte for byte as pandas' ``to_csv(index=False)``
writes them in the JAX package (:func:`adipose_tpu_torch.core.hostio.write_csv`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

import cv2
import numpy as np

from adipose_tpu_torch.core.config import DataBuildConfig
from adipose_tpu_torch.core.hostio import thread_map, write_csv
from adipose_tpu_torch.data.tiling import SegmentationDatasetBuilder, discover_slides


@dataclass
class ClassBuildStats:
    tiles_total: int = 0
    adipose: int = 0
    not_adipose: int = 0
    negatives_dropped_quality: int = 0
    negatives_dropped_balance: int = 0
    split_counts: dict = field(default_factory=dict)


class ClassificationDatasetBuilder:
    """Reuses the segmentation builder's mask/tile/QC machinery (its device
    work on ``device``), then labels and balances tiles into class folders."""

    def __init__(self, cfg: DataBuildConfig | None = None,
                 build_root: str | Path | None = None,
                 out_parent: str | Path = ".",
                 device="cuda"):
        self.cfg = cfg or DataBuildConfig()
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        channel_tag = "_ecm" if self.cfg.channel == "ecm" else ""
        self.build_root = (
            Path(build_root) if build_root
            else Path(out_parent) / f"_build_class{channel_tag}_{ts}"
        )
        self.device = device
        self.stats = ClassBuildStats()

    def build(self, data_root: str | Path,
              images_dir: str | Path | None = None,
              masks_dir: str | Path | None = None,
              mark_all_test: bool = False) -> Path:
        """``mark_all_test``: isolated test class set from dedicated dirs;
        every slide routes to the test split with eval gates and no balancing
        (``build_test_class_dataset.py:117-150``)."""
        cfg = self.cfg
        # the seg builder is a tiling helper only: its mask/QA artifact
        # writes are suppressed (they would land in _tmp/).
        # class-build gating (build_class_dataset.py:683-702): train excludes
        # ambiguous (0 < cov < threshold); test keeps them as negatives only
        # under --include-ambiguous; QC filters only negatives
        seg = SegmentationDatasetBuilder(
            dataclasses.replace(
                cfg, make_masks=False, make_overlays=False,
                protect_positives=True,
                ambiguous_high=cfg.adipose_coverage_threshold,
                test_min_mask_ratio=cfg.adipose_coverage_threshold,
                test_min_confidence=cfg.min_confidence_eval,
                test_stride=cfg.stride,
            ),
            build_root=self.build_root / "_tmp",
            device=self.device,
        )
        slides = discover_slides(
            data_root, cfg.min_confidence_train,
            images_dir=images_dir, masks_dir=masks_dir,
            exclude_test_duplicates=cfg.exclude_test_duplicates,
        )
        if mark_all_test:
            slides = [dataclasses.replace(s, is_test=True) for s in slides]
        if not slides:
            raise FileNotFoundError(f"no slides discovered under {data_root}")

        # slide-level splits are assigned BEFORE tiling (the reference order,
        # build_class_dataset.py:573-647) so eval-split semantics (confidence
        # >= min_confidence_val and --include-ambiguous keep-as-negative)
        # apply to the internal val/test splits, not only external test/
        rng = np.random.default_rng(cfg.seed)
        seen: set = set()
        bases = [s.base for s in slides
                 if not s.is_test and not (s.base in seen or seen.add(s.base))]
        rng.shuffle(bases)
        n_test = (max(1, int(len(bases) * cfg.test_fraction))
                  if cfg.test_fraction > 0 and bases else 0)
        n_test = min(n_test, len(bases))
        test_bases = set(bases[:n_test])
        rest = bases[n_test:]
        n_val = (max(1, int(len(rest) * cfg.val_fraction))
                 if cfg.val_fraction > 0 and rest else 0)
        n_val = min(n_val, len(rest))
        val_bases = set(rest[:n_val])

        by_split: dict = {"train": [], "val": [], "test": []}
        for slide in slides:
            split = ("test" if slide.is_test
                     else "test" if slide.base in test_bases
                     else "val" if slide.base in val_bases else "train")
            # val/test slides tile with the eval-split gates (is_test=True)
            s_eff = (dataclasses.replace(slide, is_test=True)
                     if split != "train" else slide)
            mask = seg.build_slide_mask(s_eff)
            if mask is None:
                continue
            for t in seg.tile_slide(s_eff, mask):
                t["label"] = int(t["pos_ratio"] >= cfg.adipose_coverage_threshold)
                by_split[split].append(t)
        self.stats.tiles_total = sum(len(v) for v in by_split.values())

        # quality filters only drop negatives (protect_positives inside
        # tile_slide); balancing runs PER SPLIT (reference :925-945)
        splits = {k: self._balance(v) for k, v in by_split.items()}
        for split, tiles in splits.items():
            rows = []
            for t in tiles:
                cls = "adipose" if t["label"] else "not_adipose"
                d = self.build_root / "dataset" / split / cls
                d.mkdir(parents=True, exist_ok=True)
                rows.append({"file": f"{cls}/{t['name']}.jpg", "label": t["label"],
                             "pos_ratio": t["pos_ratio"], "base": t["base"]})
            # JPEG encode releases the GIL; writes are independent files
            thread_map(
                lambda t: cv2.imwrite(
                    str(self.build_root / "dataset" / split /
                        ("adipose" if t["label"] else "not_adipose") /
                        f"{t['name']}.jpg"),
                    t["image"], [cv2.IMWRITE_JPEG_QUALITY, cfg.jpeg_quality]),
                tiles,
            )
            self.stats.split_counts[split] = len(rows)
            (self.build_root / "dataset").mkdir(parents=True, exist_ok=True)
            write_csv(self.build_root / "dataset" / f"{split}_manifest.csv", rows)
        self._write_reports(data_root)
        # drop the seg builder's temp root if empty
        tmp = self.build_root / "_tmp"
        if tmp.exists() and not any(tmp.iterdir()):
            tmp.rmdir()
        return self.build_root

    def _balance(self, tiles: list) -> list:
        """Undersample negatives until adipose is ~ the target fraction
        (default 40 %) (``build_class_dataset.py:721-784``). Called once per
        split (:925-945); stats accumulate across calls."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        pos = [t for t in tiles if t["label"] == 1]
        neg = [t for t in tiles if t["label"] == 0]
        self.stats.adipose += len(pos)
        if not cfg.balance_classes or not pos:
            self.stats.not_adipose += len(neg)
            return pos + neg
        target_pos_frac = cfg.negative_fraction  # 0.40 adipose share
        max_neg = int(round(len(pos) * (1 - target_pos_frac) / target_pos_frac))
        if len(neg) > max_neg:
            idx = rng.choice(len(neg), size=max_neg, replace=False)
            self.stats.negatives_dropped_balance += len(neg) - max_neg
            neg = [neg[i] for i in idx]
        self.stats.not_adipose += len(neg)
        return pos + neg

    def _write_reports(self, data_root):
        cfg_dict = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in vars(self.cfg).items()}
        (self.build_root / "config.json").write_text(json.dumps(cfg_dict, indent=2))
        s = self.stats
        total = s.adipose + s.not_adipose
        frac = s.adipose / total if total else 0.0
        grade = ("excellent" if 0.35 <= frac <= 0.45 else
                 "good" if 0.25 <= frac <= 0.55 else "poor")
        report = {
            "timestamp": datetime.now().isoformat(),
            "data_root": str(data_root),
            "tiles_total": s.tiles_total,
            "adipose": s.adipose,
            "not_adipose": s.not_adipose,
            "adipose_fraction": round(frac, 4),
            "balance_grade": grade,
            "negatives_dropped_balance": s.negatives_dropped_balance,
            "split_counts": s.split_counts,
        }
        (self.build_root / "balance_report.json").write_text(json.dumps(report, indent=2))
