"""``adipose-torch``: the port's command line.

``adipose-torch segment`` (with ``--use-tta``), ``classify``, ``evaluate``,
``evaluate-checkpoints``, ``eval-classifier``, ``tile-classification-eval``,
``visualize-metrics``, ``pipeline``, ``train-unet``, ``train-classifier``,
the four dataset builds (``build-dataset``, ``build-test-dataset``,
``build-class-dataset``, ``build-test-class-dataset``), ``run-pipeline``,
``reconstruct``, ``classification-overlay`` and the WSI preparation tools
(``chunk-wsi``, ``preprocess-ecm``, ``scale-ecm``, ``compare-modalities``,
``tif2jpg``) and the stain and analysis tools (``select-stain-reference``,
``validate-stain``, ``analyze-tiles``, ``visualize-preprocessing``) and
serving (``export``, ``import-weights``; ``segment --bundle`` and ``classify
--bundle`` serve an export bundle) are those subcommands of ``adipose``
(``adipose_tpu/cli/main.py``) on a torch device, with the same flags plus
``--device`` where device work runs. They read and write ``params.npz``
weights (see :mod:`adipose_tpu_torch.train.checkpoint`).

``train-unet`` and ``train-classifier`` train on several devices as one
process each over ``torch.distributed`` (see :func:`_launch_ranks`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.core.host_copy import HostCopy
from adipose_tpu_torch.core.hostio import thread_map
from adipose_tpu_torch.models.convert import flax_inception_to_torch, flax_unet_to_torch
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import make_unet_predict
from adipose_tpu_torch.train.trainer_classifier import _make_val_step

OVERLAY_RGB = {"cyan": (0, 255, 255), "yellow": (255, 255, 0),
               "magenta": (255, 0, 255), "green": (0, 255, 0), "red": (255, 0, 0)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="adipose-torch", description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    s = sub.add_parser("segment", help="folder inference: masks + prob maps")
    s.add_argument("--weights", default=None)
    s.add_argument("--bundle", default=None,
                   help="export bundle (adipose-torch export): its program for --device, "
                        "the normalization baked in")
    s.add_argument("--input-dir", "--images-dir", dest="input_dir", required=True,
                   help="tile folder (reference name: --images-dir)")
    s.add_argument("--output-dir", required=True)
    s.add_argument("--use-tta", action="store_true",
                   help="D4 test-time augmentation; its views fold into --batch-size")
    s.add_argument("--tta-mode", choices=["minimal", "basic", "full"], default="basic")
    s.add_argument("--threshold", type=float, default=0.5)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--save-overlays", action="store_true",
                   help="write overlays/<stem>_overlay.png")
    s.add_argument("--overlay-color", default="cyan", choices=sorted(OVERLAY_RGB))
    s.add_argument("--save-probability", action="store_true",
                   help="write probability_maps/<stem>_prob.tif")
    s.add_argument("--device", default="cuda",
                   help="torch device; on 'cpu' the kernels' plain versions run")
    s.set_defaults(func=cmd_segment)

    pl = sub.add_parser("pipeline", help="end-to-end dual-model WSI pipeline")
    pl.add_argument("--wsi", default=None, help="a single WSI/chunk image")
    pl.add_argument("--wsi-dir", default=None,
                    help="directory of WSI chunks; chunks stream through a 1-deep "
                         "pipelined loop: chunk k+1 computes while chunk k's map "
                         "is copied and written")
    pl.add_argument("--classifier-weights", required=True)
    pl.add_argument("--segmenter-weights", required=True)
    pl.add_argument("--output-dir", required=True)
    pl.add_argument("--tile-size", type=int, default=1024)
    pl.add_argument("--classifier-threshold", type=float, default=0.5)
    pl.add_argument("--threshold", type=float, default=0.5)
    pl.add_argument("--batch-size", type=int, default=16)
    pl.add_argument("--transfer-dtype", choices=["uint8", "float16", "float32"],
                    default="float16",
                    help="final probability-map copy precision (uint8 copies the "
                         "exact PNG payload: smallest copy, 1/255-step probabilities)")
    pl.add_argument("--device", default="cuda",
                    help="torch device; on 'cpu' the kernels' plain versions run")
    pl.set_defaults(func=cmd_pipeline)
    _add_train_unet(sub)
    _add_train_classifier(sub)
    _add_evaluate(sub)
    _add_batch_evaluation(sub)
    _add_classifier_inference(sub)
    _add_builds(sub)
    _add_wsi_tools(sub)
    _add_wsi_prep(sub)
    _add_analysis(sub)
    _add_serving(sub)
    return parser


def _add_serving(sub) -> None:
    """``export`` and ``import-weights``: every flag name and default of the
    ``adipose`` subcommands; ``export`` adds ``--device``, ``import-weights``
    runs on the host."""
    ex = sub.add_parser("export", help="export a model for serving (torch.export)")
    ex.add_argument("--weights", required=True)
    ex.add_argument("--model", choices=["unet", "classifier"], default="unet")
    ex.add_argument("--output", required=True)
    ex.add_argument("--batch-size", type=int, default=1)
    ex.add_argument("--tile-size", type=int, default=1024)
    ex.add_argument("--platforms", nargs="+", default=["tpu", "cpu"],
                    help="one program per device: tpu, gpu and cuda mean --device, cpu "
                         "the CPU")
    _add_device(ex, cmd_export)

    iw = sub.add_parser("import-weights", help="TF .weights.h5 -> params.npz")
    iw.add_argument("--h5", required=True)
    iw.add_argument("--model", choices=["unet", "classifier"], default="unet")
    iw.add_argument("--output", required=True)
    iw.add_argument("--use-deep-supervision", action="store_true")
    iw.set_defaults(func=cmd_import_weights)


def _add_device(p, func) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; on 'cpu' the kernels' plain versions run")
    p.set_defaults(func=func)


def _add_builds(sub) -> None:
    """``build-dataset``, ``build-test-dataset``, ``build-class-dataset`` and
    ``build-test-class-dataset``: every flag name and default of the
    ``adipose`` subcommands plus ``--device`` (where the stain, QC and
    grayscale run)."""
    b = sub.add_parser("build-dataset", help="build segmentation tile dataset")
    b.add_argument("--data-root", required=True)
    b.add_argument("--input-images-dir", default=None,
                   help="override for the Pseudocolored/ images dir")
    b.add_argument("--input-masks-dir", default=None,
                   help="override for the Masks/ JSON dir")
    b.add_argument("--output-root", default=None,
                   help="parent for the _build_<ts> dir (default: data root)")
    b.add_argument("--out-parent", default=None,
                   help="alias of --output-root")
    # mask building (build_dataset.py DEFAULTS :159-198)
    b.add_argument("--make-masks", dest="make_masks", action="store_true",
                   default=True)
    b.add_argument("--no-make-masks", dest="make_masks", action="store_false")
    b.add_argument("--make-overlays", dest="make_overlays", action="store_true",
                   default=False)
    b.add_argument("--no-overlays", dest="make_overlays", action="store_false")
    b.add_argument("--target-mask", default="fat",
                   choices=["bubbles", "fat", "muscle"])
    b.add_argument("--subtract", dest="subtract", action="store_true", default=True)
    b.add_argument("--no-subtract", dest="subtract", action="store_false")
    b.add_argument("--subtract-class", default="bubbles",
                   choices=["bubbles", "fat", "muscle"])
    b.add_argument("--subtract-masks-dir", default=None)
    b.add_argument("--morph-close-k", type=int, default=0)
    b.add_argument("--min-cc-px", type=int, default=0)
    # tiling + filtering
    b.add_argument("--tile-size", type=int, default=1024)
    b.add_argument("--stride", type=int, default=1024)
    b.add_argument("--white-th", dest="white_threshold", type=int, default=235)
    b.add_argument("--white-ratio", dest="white_ratio_limit", type=float,
                   default=0.70)
    b.add_argument("--blur-th", dest="blurry_threshold", type=float, default=7.5)
    b.add_argument("--min-mask-ratio", type=float, default=0.05)
    b.add_argument("--keep-white", action="store_true", default=True)
    b.add_argument("--drop-white", action="store_false", dest="keep_white")
    b.add_argument("--keep-blurry", action="store_true", default=True)
    b.add_argument("--drop-blurry", action="store_false", dest="keep_blurry")
    b.add_argument("--jpeg-quality", type=int, default=100)
    b.add_argument("--invert-input", action="store_true")
    # split
    b.add_argument("--val-ratio", type=float, default=0.20)
    b.add_argument("--test-ratio", type=float, default=0.0)
    b.add_argument("--seed", type=int, default=None)
    b.add_argument("--split-by-slide", dest="split_by_slide",
                   action="store_true", default=True)
    b.add_argument("--no-split-by-slide", dest="split_by_slide",
                   action="store_false")
    b.add_argument("--include-test-set", dest="include_test_set",
                   action="store_true", default=False)
    b.add_argument("--no-include-test-set", dest="include_test_set",
                   action="store_false")
    b.add_argument("--exclude-test-duplicates", type=_bool, default=True)
    b.add_argument("--channel", choices=["ecm", "pseudocolored"],
                   default="pseudocolored")
    # IO/perf
    b.add_argument("--compression", choices=["auto", "lzw", "packbits", "none"],
                   default="auto")
    b.add_argument("--workers", type=int, default=None)
    b.add_argument("--neg-pct", type=float, default=0.40)
    # stain normalization
    b.add_argument("--stain-normalize", dest="stain_normalize",
                   action="store_true", default=True)
    b.add_argument("--no-stain-normalize", dest="stain_normalize",
                   action="store_false")
    b.add_argument("--apply-stain-norm", type=_bool, default=None,
                   help="alias of --stain-normalize/--no-stain-normalize")
    b.add_argument("--reference-path", default=None)
    b.add_argument("--reference-metadata", default=None)
    # confidence
    b.add_argument("--min-confidence-train", type=int, default=1,
                   choices=[1, 2, 3])
    b.add_argument("--min-confidence-val", "--min-confidence-eval",
                   dest="min_confidence_val", type=int, default=2,
                   choices=[1, 2, 3])
    # test-split-specific
    b.add_argument("--test-min-mask-ratio", type=float, default=0.0)
    b.add_argument("--test-stride", type=int, default=1024)
    b.add_argument("--test-neg-pct", type=float, default=1.0)
    b.add_argument("--test-min-confidence", type=int, default=2,
                   choices=[1, 2, 3])
    b.add_argument("--test-include-white", action="store_true", default=False)
    b.add_argument("--test-include-blurry", action="store_true", default=False)
    b.add_argument("--include-ambiguous", action="store_true", default=False)
    _add_device(b, cmd_build_dataset)

    bt = sub.add_parser("build-test-dataset",
                        help="build an ISOLATED test set from dedicated dirs "
                             "(build_test_dataset.py)")
    bt.add_argument("--images-dir", required=True)
    bt.add_argument("--masks-dir", required=True,
                    help="JSON annotation root (Masks/-style, per-class subdirs)")
    bt.add_argument("--output-dir", required=True)
    bt.add_argument("--target-mask", default="fat",
                    choices=["bubbles", "fat", "muscle"])
    bt.add_argument("--subtract", dest="subtract", action="store_true",
                    default=False)  # TEST_DEFAULTS :115
    bt.add_argument("--no-subtract", dest="subtract", action="store_false")
    bt.add_argument("--subtract-class", default="bubbles",
                    choices=["bubbles", "fat", "muscle"])
    bt.add_argument("--morph-close-k", type=int, default=0)
    bt.add_argument("--min-cc-px", type=int, default=0)
    bt.add_argument("--tile-size", type=int, default=1024)
    bt.add_argument("--stride", type=int, default=1024)
    bt.add_argument("--white-threshold", type=int, default=235)
    bt.add_argument("--white-ratio-limit", type=float, default=0.70)
    bt.add_argument("--blurry-threshold", type=float, default=7.5)
    bt.add_argument("--min-mask-ratio", type=float, default=0.0)
    bt.add_argument("--include-white", dest="include_white",
                    action="store_true", default=True)
    bt.add_argument("--exclude-white", dest="include_white",
                    action="store_false")
    bt.add_argument("--include-blurry", dest="include_blurry",
                    action="store_true", default=True)
    bt.add_argument("--exclude-blurry", dest="include_blurry",
                    action="store_false")
    bt.add_argument("--include-ambiguous", dest="include_ambiguous",
                    action="store_true", default=False)
    bt.add_argument("--exclude-ambiguous", dest="include_ambiguous",
                    action="store_false")
    bt.add_argument("--jpeg-quality", type=int, default=100)
    bt.add_argument("--compression", choices=["auto", "lzw", "packbits", "none"],
                    default="auto")
    bt.add_argument("--workers", type=int, default=None)
    bt.add_argument("--neg-pct", type=float, default=1.0)
    bt.add_argument("--min-confidence", type=int, choices=[1, 2, 3], default=2)
    bt.add_argument("--seed", type=int, default=None)
    bt.add_argument("--stain-normalize", dest="stain_normalize",
                    action="store_true", default=True)
    bt.add_argument("--no-stain-normalize", dest="stain_normalize",
                    action="store_false")
    bt.add_argument("--reference-metadata", default=None)
    bt.add_argument("--reference-path", default=None)
    _add_device(bt, cmd_build_test_dataset)

    c = sub.add_parser("build-class-dataset", help="build classification tile dataset")
    c.add_argument("--data-root", required=True)
    c.add_argument("--tile-size", type=int, default=1024)
    c.add_argument("--stride", type=int, default=1024)
    c.add_argument("--adipose-threshold", type=float, default=0.025)
    c.add_argument("--channel", choices=["pseudocolored", "ecm"], default="pseudocolored")
    c.add_argument("--val-ratio", type=float, default=0.20)
    c.add_argument("--test-ratio", type=float, default=0.0)
    c.add_argument("--white-threshold", type=int, default=245)
    c.add_argument("--white-ratio-limit", type=float, default=0.70)
    c.add_argument("--blurry-threshold", type=float, default=7.5)
    c.add_argument("--min-confidence-train", type=int, choices=[1, 2, 3],
                   default=1)
    c.add_argument("--min-confidence-val", type=int, choices=[1, 2, 3],
                   default=2)
    c.add_argument("--include-ambiguous", type=_bool, default=False)
    c.add_argument("--jpeg-quality", type=int, default=100)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--keep-white", type=_bool, default=True)
    c.add_argument("--keep-blurry", type=_bool, default=True)
    c.add_argument("--balance-classes", dest="balance_classes",
                   action="store_true", default=True)
    c.add_argument("--no-balance", dest="balance_classes", action="store_false")
    c.add_argument("--target-adipose-ratio", "--neg-pct", dest="neg_pct",
                   type=float, default=0.40,
                   help="adipose share of the balanced set "
                        "(build_class_dataset.py:155-156)")
    c.add_argument("--stain-normalize", type=_bool, default=None)
    c.add_argument("--apply-stain-norm", type=_bool, default=None,
                   help="alias of --stain-normalize")
    c.add_argument("--reference-path", default=None)
    c.add_argument("--reference-metadata", default=None)
    c.add_argument("--exclude-test-duplicates", type=_bool, default=True)
    c.add_argument("--out-parent", "--output-root", dest="out_parent",
                   default=None)
    _add_device(c, cmd_build_class_dataset)

    btc = sub.add_parser("build-test-class-dataset",
                         help="build an ISOLATED classification test set "
                              "(build_test_class_dataset.py)")
    btc.add_argument("--images-dir", required=True)
    btc.add_argument("--masks-dir", required=True)
    btc.add_argument("--output-dir", required=True)
    btc.add_argument("--tile-size", type=int, default=1024)
    btc.add_argument("--stride", type=int, default=1024)
    btc.add_argument("--adipose-threshold", type=float, default=0.025)
    btc.add_argument("--white-threshold", type=int, default=245)
    btc.add_argument("--white-ratio-limit", type=float, default=0.70)
    btc.add_argument("--blurry-threshold", type=float, default=7.5)
    btc.add_argument("--keep-white", type=_bool, default=True)
    btc.add_argument("--keep-blurry", type=_bool, default=True)
    btc.add_argument("--jpeg-quality", type=int, default=100)
    btc.add_argument("--min-confidence", type=int, choices=[1, 2, 3], default=2)
    btc.add_argument("--include-ambiguous", type=_bool, default=False)
    btc.add_argument("--stain-normalize", type=_bool, required=True,
                     help="required true/false — the reference forces an "
                          "explicit choice (build_test_class_dataset.py:145)")
    btc.add_argument("--reference-metadata", default=None)
    btc.add_argument("--reference-path", default=None)
    btc.add_argument("--seed", type=int, default=None)
    _add_device(btc, cmd_build_test_class_dataset)


def _add_wsi_tools(sub) -> None:
    """``reconstruct``, ``classification-overlay`` and ``run-pipeline``: every
    flag name and default of the ``adipose`` subcommands plus ``--device``
    where a model runs (not ``classification-overlay``, which is host cv2)."""
    r = sub.add_parser("reconstruct", help="rebuild full slides from tiles")
    r.add_argument("--weights", required=True)
    r.add_argument("--images-dir", required=True)
    r.add_argument("--masks-dir", default=None)
    r.add_argument("--output-dir", required=True)
    r.add_argument("--tile-size", type=int, default=1024)
    r.add_argument("--stride", type=int, default=1024)
    r.add_argument("--min-coverage", type=float, default=0.9)
    r.add_argument("--data-root", default=None)
    r.add_argument("--batch-size", type=int, default=16)
    r.add_argument("--use-tta", action="store_true",
                   help="D4 TTA per tile (reconstruct_full_images.py:903)")
    r.add_argument("--tta-mode", choices=["minimal", "basic", "full"],
                   default="basic")
    r.add_argument("--boundary-refine", action="store_true")
    r.add_argument("--refine-kernel", type=int, default=5)
    r.add_argument("--threshold", type=float, default=0.5)
    r.add_argument("--blend-mode", choices=["gaussian", "linear", "none"],
                   default="gaussian")
    r.add_argument("--max-tiles", type=int, default=None,
                   help="limit each slide to its top-left NxN tile grid "
                        "(reconstruct_full_images.py:663-678)")
    r.add_argument("--save-masks", dest="save_masks", action="store_true",
                   default=True)
    r.add_argument("--no-save-masks", dest="save_masks", action="store_false")
    r.add_argument("--save-overlays", action="store_true")
    r.add_argument("--save-comparisons", action="store_true")
    r.add_argument("--save-metrics", action="store_true",
                   help="accepted for parity; per-slide metrics.json is "
                        "always written when ground truth exists")
    _add_device(r, cmd_reconstruct)

    ov = sub.add_parser("classification-overlay",
                        help="render TP/FP/FN/TN tile overlay on a WSI")
    ov.add_argument("--wsi", default=None, help="a single WSI file")
    ov.add_argument("--wsi-dir", default=None,
                    help="directory of WSIs — one overlay per slide whose "
                         "predictions match its stem "
                         "(reconstruct_wsi_classification.py:97)")
    ov.add_argument("--tiles-dir", default=None,
                    help="accepted for parity; tile coords come from the "
                         "prediction filenames")
    ov.add_argument("--predictions-csv", required=True)
    ov.add_argument("--metrics-json", default=None,
                    help="take the threshold from its best_threshold")
    ov.add_argument("--output", default=None, help="output file (single-WSI)")
    ov.add_argument("--output-dir", default=None,
                    help="output directory (multi-WSI)")
    ov.add_argument("--tile-size", type=int, default=1024)
    ov.add_argument("--combine", "--combine-patches", dest="combine",
                    type=int, default=3)
    ov.add_argument("--overlay-alpha", type=float, default=0.4)
    ov.add_argument("--downsample", type=int, default=8)
    ov.add_argument("--save-original", dest="save_original",
                    action="store_true", default=False)
    ov.add_argument("--no-save-original", dest="save_original",
                    action="store_false")
    ov.add_argument("--threshold", type=float, default=None,
                    help="default: metrics-json best_threshold, else 0.5")
    ov.set_defaults(func=cmd_classification_overlay)

    rp = sub.add_parser("run-pipeline",
                        help="build → train → val-eval → test-eval "
                             "(run_complete_pipeline.sh analog)")
    rp.add_argument("--data-root", required=True)
    rp.add_argument("--epochs-phase1", type=int, default=50)
    rp.add_argument("--epochs-phase2", type=int, default=100)
    rp.add_argument("--batch-size", type=int, default=2)
    rp.add_argument("--skip-build", action="store_true")
    rp.add_argument("--use-tta", action="store_true")
    rp.add_argument("--min-train-tiles", type=int, default=10)
    rp.add_argument("--tile-size", type=int, default=1024)
    rp.add_argument("--stride", type=int, default=None,
                    help="build stride (default: tile size)")
    rp.add_argument("--init-nb", type=int, default=44)
    rp.add_argument("--val-ratio", type=float, default=0.15)
    rp.add_argument("--test-ratio", type=float, default=0.15)
    _add_device(rp, cmd_run_pipeline)


def _add_wsi_prep(sub) -> None:
    """``chunk-wsi``, ``preprocess-ecm``, ``scale-ecm``, ``compare-modalities``
    and ``tif2jpg``: every flag name and default of the ``adipose``
    subcommands plus ``--device`` where device work runs (not ``scale-ecm``
    and ``tif2jpg``, which are host cv2)."""
    ch = sub.add_parser("chunk-wsi", help="cut huge WSIs into chunks")
    ch.add_argument("--input", default=None, help="a single WSI file")
    ch.add_argument("--input-dir", default=None,
                    help="directory of WSIs (reference driver, "
                         "large_wsi_to_small_wsi_MS.py:642)")
    ch.add_argument("--output-dir", required=True)
    ch.add_argument("--mode", choices=["adaptive", "grid"], default="adaptive")
    ch.add_argument("--primary-tile", type=int, default=6144)
    ch.add_argument("--grid-tile", type=int, default=2048)
    ch.add_argument("--grid-overlap", type=int, default=204)
    ch.add_argument("--max-file-size-mb", type=float, default=50.0)
    ch.add_argument("--max-dimension-px", type=int, default=13112)
    ch.add_argument("--min-dimension-px", type=int, default=13112)
    ch.add_argument("--extensions", default=".tif,.tiff,.png,.jpg,.jpeg")
    ch.add_argument("--output-format", choices=["auto", "jpg", "jpeg", "png", "tif", "tiff"],
                    default="auto")
    ch.add_argument("--bit-depth", choices=["auto", "8", "16"], default="auto")
    ch.add_argument("--enhancement", "--enhancement-method", dest="enhancement",
                    choices=["none", "zscore", "percentile", "clahe"], default="none")
    ch.add_argument("--save-enhanced", action="store_true")
    ch.add_argument("--invert", action="store_true")
    ch.add_argument("--skip-existing", action="store_true")
    ch.add_argument("--dry-run", action="store_true")
    _add_device(ch, cmd_chunk_wsi)

    pe = sub.add_parser("preprocess-ecm", help="ECM channel cleanup (deband etc.)")
    pe.add_argument("--input-dir", required=True)
    pe.add_argument("--output-dir", required=True)
    # banding removal (preprocess_small_MS_SIMs.py:853-878)
    pe.add_argument("--deband", "--banding-method", dest="deband",
                    choices=["fft", "morphological", "column_norm", "column", "none"],
                    default="none")
    pe.add_argument("--fft-freq-low", type=float, default=0.01)
    pe.add_argument("--fft-freq-high", type=float, default=0.05)
    pe.add_argument("--fft-width", type=int, default=3)
    pe.add_argument("--fft-sigma-scale", type=float, default=0.5)
    pe.add_argument("--fft-blend", type=float, default=1.0)
    pe.add_argument("--morph-width", type=int, default=1)
    pe.add_argument("--morph-height", type=int, default=512)
    pe.add_argument("--column-preserve-global", action="store_true", default=True)
    # normalization (:881-889)
    pe.add_argument("--normalization-method", choices=["percentile", "zscore", "none"],
                    default="none")
    pe.add_argument("--percentile-low", type=float, default=1.0)
    pe.add_argument("--percentile-high", type=float, default=99.0)
    # illumination correction (:892-914)
    pe.add_argument("--illumination", "--illumination-method", dest="illumination",
                    choices=["rolling_ball", "rolling-ball", "gaussian", "polynomial", "tophat",
                             "clahe", "none"],
                    default="none")
    pe.add_argument("--rolling-ball-radius", type=int, default=100)
    pe.add_argument("--poly-sigma", type=float, default=150.0)
    pe.add_argument("--tophat-kernel", type=int, default=301)
    pe.add_argument("--clahe-illum-tile", type=int, default=16)
    pe.add_argument("--clahe-illum-clip", type=float, default=2.0)
    # contrast + sharpening (:917-932)
    pe.add_argument("--clahe", "--enhance-contrast", dest="clahe", action="store_true")
    pe.add_argument("--clahe-tile-size", type=int, default=16)
    pe.add_argument("--clahe-clip-limit", type=float, default=3.0)
    pe.add_argument("--sharpen", action="store_true")
    pe.add_argument("--sharpen-sigma", type=float, default=1.0)
    pe.add_argument("--sharpen-amount", type=float, default=0.5)
    # visualization / test mode (:935-945)
    pe.add_argument("--visualize", action="store_true")
    pe.add_argument("--max-visualizations", type=int, default=10)
    pe.add_argument("--test-mode", action="store_true")
    pe.add_argument("--test-samples", type=int, default=5)
    _add_device(pe, cmd_preprocess_ecm)

    se = sub.add_parser("scale-ecm", help="resample ECM images to reference dims")
    se.add_argument("--input-dir", "--target-dir", dest="input_dir", required=True,
                    help="ECM images to resample (reference name: --target-dir, "
                         "ECM_scaling.py:201)")
    se.add_argument("--reference-dir", required=True)
    se.add_argument("--output-dir", required=True)
    se.add_argument("--interpolation", choices=["nearest", "bilinear", "bicubic", "lanczos"],
                    default="bilinear")
    se.add_argument("--dry-run", action="store_true")
    se.set_defaults(func=cmd_scale_ecm)

    cm = sub.add_parser("compare-modalities", help="Pseudocolored vs ECM metrics")
    cm.add_argument("--pseudo-dir", required=True)
    cm.add_argument("--ecm-dir", required=True)
    cm.add_argument("--output-dir", required=True)
    cm.add_argument("--n-samples", type=int, default=50)
    cm.add_argument("--n-perfect", type=int, default=None,
                    help="sample N same-dimension pairs separately")
    cm.add_argument("--n-mismatch", type=int, default=None,
                    help="sample N dimension-mismatched pairs separately")
    cm.add_argument("--seed", type=int, default=None)
    _add_device(cm, cmd_compare_modalities)

    tj = sub.add_parser("tif2jpg", help="16-bit TIFF -> 8-bit JPEG")
    tj.add_argument("--input-dir", required=True)
    tj.add_argument("--output-dir", required=True)
    tj.add_argument("--quality", type=int, default=95)
    tj.add_argument("--invert", action="store_true")
    tj.add_argument("--dry-run", action="store_true")
    tj.set_defaults(func=cmd_tif2jpg)


def _add_analysis(sub) -> None:
    """``analyze-tiles``, ``visualize-preprocessing``, ``select-stain-reference``
    and ``validate-stain``: every flag name and default of the ``adipose``
    subcommands plus ``--device``."""
    an = sub.add_parser("analyze-tiles", help="tile-quality census + "
                        "preprocessing-variant comparison")
    an.add_argument("--tiles-dir", required=True)
    an.add_argument("--output-dir", required=True)
    an.add_argument("--census", action="store_true")
    an.add_argument("--compare-preprocessing", action="store_true")
    an.add_argument("--morphology", action="store_true",
                    help="cell-morphology census over MASK tiles -> "
                         "optimized post-processing parameters")
    an.add_argument("--contrast-groups", action="store_true",
                    help="quality grouping -> adaptive-CLAHE cutoffs "
                         "(image_quality_analysis.csv + generated function)")
    an.add_argument("--compare-normalization", metavar="MODE",
                    choices=["clahe-percentile", "normalization-methods",
                             "requested-methods", "final-methods",
                             "very-final", "all"],
                    help="one reference compare_*.py suite (panels + metrics "
                         "CSV + summary md); 'all' runs every mode")
    an.add_argument("--comprehensive-normalization", action="store_true",
                    help="dataset-wide 4-method quality scoring -> "
                         "dataset_normalization_metrics.csv + dashboard")
    an.add_argument("--adipocyte-dir", default=None,
                    help="adipocyte reference tiles for similarity scoring "
                         "(comprehensive mode)")
    an.add_argument("--n-samples", "--samples-per-split", dest="n_samples",
                    type=int, default=10)
    an.add_argument("--n-per-split", type=int, default=2,
                    help="contrast-group samples per train/val/test split")
    an.add_argument("--max-tiles", type=int, default=None)
    _add_device(an, cmd_analyze_tiles)

    vp = sub.add_parser("visualize-preprocessing",
                        help="Original->Reinhard->z-score->percentile pipeline "
                             "panels (color + grayscale)")
    vp.add_argument("--tiles-dir", required=True)
    vp.add_argument("--output-dir", required=True)
    vp.add_argument("--n-samples", type=int, default=7)
    vp.add_argument("--stats", default=None,
                    help="normalization_stats.json for the z-score stage "
                         "(default: computed over the samples)")
    _add_device(vp, cmd_visualize_preprocessing)

    ss = sub.add_parser("select-stain-reference",
                        help="rank candidate tiles, write stain metadata")
    ss.add_argument("--candidate-dir", required=True)
    ss.add_argument("--output-dir", required=True)
    ss.add_argument("--max-candidates", type=int, default=350)
    _add_device(ss, cmd_select_stain_reference)

    sv = sub.add_parser("validate-stain", help="cross-validate a stain reference")
    sv.add_argument("--metadata", required=True)
    sv.add_argument("--sample-dir", required=True)
    sv.add_argument("--output-dir", required=True)
    sv.add_argument("--n-samples", type=int, default=20)
    _add_device(sv, cmd_validate_stain)


def _add_eval_opts(p) -> None:
    """The shared eval-config flag set (full_evaluation_enhanced.py:2011-2046)
    of evaluate-checkpoints and visualize-metrics."""
    p.add_argument("--use-tta", action="store_true")
    p.add_argument("--tta-mode", choices=["minimal", "basic", "full"], default="basic")
    p.add_argument("--sliding-window", action="store_true")
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--blend-mode", choices=["gaussian", "linear", "none"], default="gaussian")
    p.add_argument("--boundary-refine", action="store_true")
    p.add_argument("--refine-kernel", type=int, default=5)
    p.add_argument("--adaptive-threshold", action="store_true")
    p.add_argument("--ema", action="store_true")


def _add_dataset_selectors(p) -> None:
    """--val/--test/--human-test/--clean-test x --stain/--original
    (evaluate_all_checkpoints.py:531-549), resolved under --data-root as
    <root>/<stain_normalized|original>/<name> when that layout exists."""
    p.add_argument("--data-root", default=None)
    p.add_argument("--val", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--human-test", action="store_true")
    p.add_argument("--clean-test", action="store_true")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--stain", action="store_true")
    g.add_argument("--original", action="store_true")


def _add_batch_evaluation(sub) -> None:
    """``evaluate-checkpoints``, ``tile-classification-eval`` and
    ``visualize-metrics``: every flag name and default of the ``adipose``
    subcommands plus ``--device`` where a model runs."""
    ec = sub.add_parser("evaluate-checkpoints", help="batch-evaluate all checkpoints")
    ec.add_argument("--checkpoints-root", default="checkpoints/segmentation")
    ec.add_argument("--test-dataset", default=None,
                    help="direct dataset path (or use the selector flags)")
    _add_eval_opts(ec)
    _add_dataset_selectors(ec)
    ec.add_argument("--no-images", action="store_true",
                    help="skip per-tile visualization images")
    ec.add_argument("--parallel", action="store_true")
    ec.add_argument("--max-workers", type=int, default=2)
    ec.add_argument("--n-bootstrap", type=int, default=2000)
    ec.add_argument("--transfer-dtype", choices=["float16", "float32"], default="float16")
    _add_device(ec, cmd_evaluate_checkpoints)

    tce = sub.add_parser("tile-classification-eval",
                         help="score the segmenter as a tile classifier")
    tce.add_argument("--weights", required=True)
    tce.add_argument("--test-dataset", "--data-root", dest="test_dataset", required=True)
    tce.add_argument("--coverage-threshold", type=float, default=None,
                     help="fat coverage fraction for 'has fat'")
    tce.add_argument("--threshold", type=float, default=10.0,
                     help="fat PERCENTAGE threshold (tile_classification_evaluation.py:616)")
    tce.add_argument("--mask-threshold", type=float, default=0.5,
                     help="pixel threshold for the binary mask")
    tce.add_argument("--multi-threshold", nargs="?", const=True, default=None,
                     help="sweep thresholds; optionally a comma list of percentages, "
                          "e.g. \"1,5,10,15,25\"")
    tce.add_argument("--use-tta", action="store_true")
    tce.add_argument("--tta-mode", choices=["minimal", "basic", "full"], default="basic")
    tce.add_argument("--boundary-refine", action="store_true")
    tce.add_argument("--refine-kernel", type=int, default=5)
    tce.add_argument("--transfer-dtype", choices=["float16", "float32"], default="float16")
    tce.add_argument("--output", "--output-dir", dest="output", default=None)
    _add_device(tce, cmd_tile_classification_eval)

    vm = sub.add_parser("visualize-metrics", help="compare checkpoint metrics")
    vm.add_argument("--checkpoints-root", default="checkpoints/segmentation")
    vm.add_argument("--checkpoints", nargs="+", default=None,
                    help="restrict to these checkpoint dir names")
    vm.add_argument("--name", default=None,
                    help="output filename stem (visualize_checkpoint_metrics.py:739)")
    vm.add_argument("--metric", default="Dice Score")
    vm.add_argument("--output", default="checkpoint_comparison.png")
    _add_eval_opts(vm)
    _add_dataset_selectors(vm)
    vm.set_defaults(func=cmd_visualize_metrics)


def _add_classifier_inference(sub) -> None:
    """``eval-classifier`` and ``classify``: every flag name and default of
    the ``adipose`` subcommands plus ``--device``."""
    cl = sub.add_parser("eval-classifier", help="classifier test evaluation")
    cl.add_argument("--weights", required=True)
    cl.add_argument("--dataset-root", default=None)
    cl.add_argument("--split", default="test")
    cl.add_argument("--test-dir", default=None,
                    help="a dir with adipose/ and not_adipose/ (overrides "
                         "--dataset-root/--split)")
    cl.add_argument("--batch-size", type=int, default=64)
    cl.add_argument("--dropout", type=float, default=0.4,
                    help="head dropout rate; inference does not use it")
    cl.add_argument("--use-tta", type=_bool, default=True)
    cl.add_argument("--tta-mode", choices=["basic", "full"], default="full")
    cl.add_argument("--tta", choices=["none", "basic", "full"], default=None,
                    help="reference-style mode (overrides --use-tta/--tta-mode; "
                         "'none' disables TTA)")
    cl.add_argument("--calibration", choices=["temperature", "platt", "isotonic"],
                    default=None)
    cl.add_argument("--calibration-val-root", default=None,
                    help="dataset root whose split supplies calibration tiles "
                         "(eval_adipose_classifier.py:790-795); without it, "
                         "calibration splits the test set internally")
    cl.add_argument("--calibration-val-split", default="val")
    cl.add_argument("--snapshot", action="append", default=[],
                    help="extra checkpoint(s) to ensemble in logit space (repeatable)")
    cl.add_argument("--slide-map", default=None,
                    help="CSV tile,slide_id map for slide-level aggregation")
    cl.add_argument("--save-plots", action="store_true", default=True)
    cl.add_argument("--no-plots", dest="save_plots", action="store_false")
    cl.add_argument("--save-examples", action="store_true", default=True)
    cl.add_argument("--no-examples", dest="save_examples", action="store_false")
    cl.add_argument("--num-examples", type=int, default=10)
    cl.add_argument("--percentile-norm-examples", type=_bool, default=True,
                    help="render example dumps percentile-normalized")
    cl.add_argument("--percentile-norm", type=_bool, default=True)
    cl.add_argument("--percentile-low", type=float, default=1.0)
    cl.add_argument("--percentile-high", type=float, default=99.0)
    cl.add_argument("--output", "--output-dir", dest="output", default=None)
    _add_device(cl, cmd_eval_classifier)

    ci = sub.add_parser("classify", help="folder classification -> CSV")
    ci.add_argument("--weights", default=None)
    ci.add_argument("--bundle", default=None,
                    help="export bundle (adipose-torch export): its program for --device "
                         "after the preprocessing; its batch overrides --batch-size")
    ci.add_argument("--input-dir", required=True)
    ci.add_argument("--output-dir", default="classification_outputs",
                    help="dir for predictions_{mode}{_tta}.csv "
                         "(classification_inference.py:120-124)")
    ci.add_argument("--output-csv", default=None,
                    help="explicit CSV path (overrides --output-dir naming)")
    ci.add_argument("--pattern", default="**/*.jpg",
                    help="glob pattern for image files (recursive)")
    ci.add_argument("--use-rgb", action="store_false", dest="use_grayscale",
                    help="feed RGB directly (legacy-classifier preprocessing)")
    ci.add_argument("--use-grayscale", action="store_true", dest="use_grayscale",
                    default=True, help="grayscale -> 3-channel tile preprocessing (default)")
    ci.add_argument("--threshold", type=float, default=0.5)
    ci.add_argument("--dropout", type=float, default=0.4,
                    help="head dropout rate; inference does not use it")
    ci.add_argument("--percentile-norm", action="store_true",
                    help="apply 1-99 percentile normalization before resize "
                         "(the reference inference CLI skips it, "
                         "classification_inference.py:288-320)")
    ci.add_argument("--use-tta", action="store_true")
    ci.add_argument("--tta-mode", choices=["basic", "full"], default="basic")
    ci.add_argument("--save-visualizations", action="store_true",
                    help="save positive tiles annotated with their probability")
    ci.add_argument("--gpu", default=None,
                    help="accepted for the JAX CLI and ignored: --device picks the device "
                         "(classification_inference.py:182-186)")
    ci.add_argument("--batch-size", type=int, default=32)
    _add_device(ci, cmd_classify)


def _add_evaluate(sub) -> None:
    """``evaluate``: every flag name and default of ``adipose evaluate`` plus
    ``--device``."""
    e = sub.add_parser("evaluate", help="publication-quality segmentation eval")
    e.add_argument("--weights", required=True)
    e.add_argument("--test-dataset", required=True)
    e.add_argument("--output", default=None)
    e.add_argument("--optimize-threshold", action="store_true")
    e.add_argument("--adaptive-threshold", action="store_true")
    e.add_argument("--use-tta", action="store_true")
    e.add_argument("--tta-mode", choices=["minimal", "basic", "full"], default="basic")
    e.add_argument("--sliding-window", action="store_true")
    e.add_argument("--overlap", type=float, default=0.5)
    e.add_argument("--blend-mode", choices=["gaussian", "linear", "none"], default="gaussian")
    e.add_argument("--boundary-refine", action="store_true")
    e.add_argument("--ema", action="store_true")
    e.add_argument("--n-bootstrap", type=int, default=10000)
    e.add_argument("--batch-size", type=int, default=16,
                   help="device batch of forward images; TTA views fold into it")
    e.add_argument("--transfer-dtype", choices=["float16", "float32"], default="float16",
                   help="prediction copy precision (float16 halves the device-to-host "
                        "copy; error <= 5e-4)")
    e.add_argument("--save-visualizations", dest="save_visualizations",
                   action="store_true", default=True)
    e.add_argument("--no-visualizations", dest="save_visualizations", action="store_false")
    e.add_argument("--n-vis-samples", type=int, default=10)
    e.add_argument("--refine-kernel", type=int, default=5)
    e.add_argument("--save-overlays", action="store_true",
                   help="Dice-bucketed 4-panel dumps over a sampled pos/neg subset "
                        "(full_evaluation_enhanced.py:1801-1876)")
    e.add_argument("--n-positive", type=int, default=120)
    e.add_argument("--n-negative", type=int, default=30)
    e.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (evaluate_trace.json)")
    e.add_argument("--device", default="cuda",
                   help="torch device; on 'cpu' the kernels' plain versions run")
    e.set_defaults(func=cmd_evaluate)


def _bool(x: str) -> bool:
    # required-boolean flag style (train_adipose_classifier_v0.py:124)
    return str(x).lower() in ("1", "true", "yes", "y")


def _add_train_classifier(sub) -> None:
    """``train-classifier``: every flag name and default of ``adipose
    train-classifier`` plus ``--device``."""
    tc = sub.add_parser("train-classifier", help="two-phase InceptionV3 classifier")
    tc.add_argument("--dataset-root", required=True)
    tc.add_argument("--train-split", default="train")
    tc.add_argument("--val-split", default="val")
    tc.add_argument("--pretrained-weights", default=None,
                    help="by-name transfer from a run or weights dir holding params.npz "
                         "(train_adipose_classifier_v0.py:322-353), or a TF .h5")
    tc.add_argument("--warmup-epochs", type=int, default=6)
    tc.add_argument("--finetune-epochs", type=int, default=20)
    tc.add_argument("--batch-size", type=int, default=32)
    tc.add_argument("--base-lr", type=float, default=1e-3)
    tc.add_argument("--finetune-lr", type=float, default=1e-4)
    tc.add_argument("--dropout", type=float, default=0.4)
    tc.add_argument("--unfreeze-from", default="mixed7")
    tc.add_argument("--patience", type=int, default=4)
    tc.add_argument("--label-smoothing", type=float, default=0.1)
    tc.add_argument("--percentile-norm", type=_bool, default=True)
    tc.add_argument("--percentile-low", type=float, default=1.0)
    tc.add_argument("--percentile-high", type=float, default=99.0)
    tc.add_argument("--use-class-weights", action="store_true")
    tc.add_argument("--augment-low-res", action="store_true",
                    help="augment AFTER the 299 resize (opt-in deviation, PARITY.md #15: "
                         "the reference augments at native resolution)")
    tc.add_argument("--pos-weight-multiplier", type=float, default=1.0)
    tc.add_argument("--prep-megabatch", type=int, default=4,
                    help="accepted for the JAX CLI; no effect on a GPU (the JAX package "
                         "groups prep dispatches for the TPU; the draws never depend on it)")
    tc.add_argument("--save-best-only", dest="save_best_only", action="store_true",
                    default=True)
    tc.add_argument("--no-save-best-only", dest="save_best_only", action="store_false")
    tc.add_argument("--checkpoint-dir", default="checkpoints/classifier_runs")
    tc.add_argument("--suffix", default="")
    tc.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the run (train_classifier_trace.json)")
    tc.add_argument("--device", default="cuda",
                    help="torch device; on 'cpu' the kernels' plain versions run")
    tc.set_defaults(func=cmd_train_classifier)


def _add_train_unet(sub) -> None:
    """``train-unet``: every flag name and default of ``adipose train-unet``
    plus ``--device``."""
    t = sub.add_parser("train-unet", help="two-phase U-Net fine-tuning")
    t.add_argument("--data-root", required=True)
    t.add_argument("--pretrained-weights", default=None,
                   help="by-name weight transfer before phase 1 from a run or weights dir "
                        "holding params.npz, or a TF .h5 / .weights.h5")
    t.add_argument("--epochs-phase1", type=int, default=75)
    t.add_argument("--epochs-phase2", type=int, default=150)
    t.add_argument("--batch-size", type=int, default=2)
    t.add_argument("--use-deep-supervision", dest="use_deep_supervision",
                   action="store_true", default=True)
    t.add_argument("--no-deep-supervision", dest="use_deep_supervision",
                   action="store_false")
    t.add_argument("--use-hard-example-mining", "--use-hard-mining",
                   dest="use_hard_mining", action="store_true", default=True)
    t.add_argument("--no-hard-mining", dest="use_hard_mining", action="store_false")
    t.add_argument("--ohem-ratio", "--hard-example-ratio", dest="ohem_ratio",
                   type=float, default=0.7)
    t.add_argument("--use-label-smoothing", "--label-smoothing",
                   dest="use_label_smoothing", action="store_true", default=False)
    t.add_argument("--no-label-smoothing", dest="use_label_smoothing", action="store_false")
    t.add_argument("--epsilon-pos", "--label-smooth-epsilon-pos", dest="epsilon_pos",
                   type=float, default=0.03)
    t.add_argument("--epsilon-neg", "--label-smooth-epsilon-neg", dest="epsilon_neg",
                   type=float, default=0.07)
    t.add_argument("--use-ema", dest="use_ema", action="store_true", default=True,
                   help="EMA weights (the reference always tracks them, :410-505)")
    t.add_argument("--no-ema", dest="use_ema", action="store_false")
    t.add_argument("--ema-decay", type=float, default=0.995)
    t.add_argument("--use-adamw", action="store_true")
    t.add_argument("--optimizer", choices=["adam", "adamw"], default=None,
                   help="reference name (overrides --use-adamw)")
    t.add_argument("--weight-decay", type=float, default=0.01)
    t.add_argument("--use-cosine-schedule", dest="use_cosine_schedule",
                   action="store_true", default=True)
    t.add_argument("--no-cosine-schedule", dest="use_cosine_schedule", action="store_false")
    t.add_argument("--warmup-epochs", "--warmup-epochs-phase1", dest="warmup_epochs",
                   type=int, default=5)
    t.add_argument("--warmup-epochs-phase2", type=int, default=3)
    t.add_argument("--ds-weight-main", type=float, default=1.0)
    t.add_argument("--ds-weight-aux1", type=float, default=0.4)
    t.add_argument("--ds-weight-aux2", type=float, default=0.3)
    t.add_argument("--augment-level", "--augmentation-level", dest="augment_level",
                   choices=["none", "light", "moderate", "heavy", "tta_style", "tta-style"],
                   default="moderate")
    t.add_argument("--normalization-method", choices=["zscore", "percentile"],
                   default="percentile")
    t.add_argument("--percentile-low", type=float, default=1.0)
    t.add_argument("--percentile-high", type=float, default=99.0)
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (train_unet_trace.json)")
    t.add_argument("--resume-from", default=None)
    t.add_argument("--auto-resume", action="store_true",
                   help="resume mid-phase from the run dir's latest epoch state (pair with "
                        "--run-timestamp so the restarted process finds the same dir)")
    t.add_argument("--run-timestamp", default=None,
                   help="pin the checkpoint dir timestamp (default: now)")
    t.add_argument("--checkpoint-name", default="adipose_sybreosin")
    t.add_argument("--checkpoint-suffix", default="",
                   help="appended to the run directory name (:1524)")
    t.add_argument("--checkpoint-root", default="checkpoints/segmentation")
    t.add_argument("--cache-limit-mb", type=int, default=4096,
                   help="RAM tile-cache budget per dataset (0 disables)")
    t.add_argument("--num-devices", type=int, default=0,
                   help="devices to train on, one process each: the largest count up to "
                        "it that divides --batch-size (0: all visible GPUs; with --device "
                        "cpu, that many gloo ranks on the CPU, 0 meaning one process); "
                        "under torchrun the launcher's ranks")
    t.add_argument("--shard-spatial", action="store_true",
                   help="shard image rows over leftover devices when the batch is smaller "
                        "than the device count (the ranks of a data x model plan; each "
                        "rank holds a slab of every tile's rows)")
    t.add_argument("--device", default="cuda",
                   help="torch device; on 'cpu' the kernels' plain versions run")
    t.set_defaults(func=cmd_train_unet)


def _load_segmenter(weights, use_ema: bool = False, device="cuda"):
    """``(predict, params, mean, std)`` for a checkpoint dir: ``predict(params,
    tiles)`` z-scores (B, H, W) uint8/float32 tiles on ``device`` with the
    checkpoint's statistics and returns (B, H, W) float32 probabilities."""
    weights_path = ckpt.resolve_weights_path(weights, use_ema)
    ckpt_dir = weights_path.parent
    mean, std = ckpt.load_normalization_stats(ckpt_dir)
    mcfg = ckpt.detect_model_config(ckpt_dir)
    model = DilatedUNet(
        init_nb=mcfg.init_nb,
        use_deep_supervision=mcfg.use_deep_supervision,
        dilation_rates=tuple(mcfg.dilation_rates),
        compute_dtype=torch.bfloat16,
        device="meta",  # predict() runs on the params it is given
    )
    params = {k: v.to(device) for k, v in
              flax_unet_to_torch(ckpt.load_params(weights_path)).items()}
    base = make_unet_predict(model)

    def predict(p, tiles):
        with tracing.span("model.prep"):
            x, _stats = fused_zscore_normalize(tiles, mean, std, out_dtype=model.compute_dtype)
        return base(p, x)

    return predict, params, mean, std


def _classifier_state(weights, device="cuda") -> dict[str, torch.Tensor]:
    """The classifier state dict of a checkpoint dir, on ``device``."""
    variables = ckpt.load_params(ckpt.resolve_weights_path(weights))
    return {k: v.to(device) for k, v in flax_inception_to_torch(variables).items()}


def _load_classifier(weights, device="cuda", percentile_norm: bool = True,
                     p_low: float = 1.0, p_high: float = 99.0):
    """``(predict, state)`` for a classifier checkpoint dir:
    ``predict(state, tiles)`` percentile-stretches (B, H, W) uint8/float32
    tiles on ``device`` (unless ``percentile_norm`` is off), resizes them to
    299^2 and runs the bf16 InceptionV3; it returns (B,) float32
    probabilities. (B, H, W, 3) RGB tiles are resized without channel
    tiling."""
    # predict() runs on the state it is given
    model = InceptionV3Classifier(compute_dtype=torch.bfloat16, device="meta")
    return (_make_val_step(model, percentile_norm, p_low, p_high),
            _classifier_state(weights, device))


def segment_batch(predict, params, batch: np.ndarray, batch_size: int, device) -> np.ndarray:
    """The device step of ``segment``: pad a chunk of (n, H, W) tiles to
    ``batch_size`` by repeating the last, predict, return the n real
    (n, H, W) float32 probability maps. From a card they come back into
    pinned host memory (:class:`HostCopy`), which the returned array holds."""
    with tracing.span("segment.batch"):
        n = batch.shape[0]
        if n < batch_size:
            batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - n, 0)])
        with tracing.span("entry.h2d"):
            host = np.ascontiguousarray(batch)
            tracing.count("h2d_bytes", host.nbytes)
            tiles = torch.from_numpy(host).to(device)
        copy = HostCopy.start(predict(params, tiles)[:n])
        out = copy.numpy()
        tracing.count("d2h_bytes", out.nbytes)
        if copy.ready is not None:
            tracing.count("d2h_pinned_bytes", out.nbytes)
        return out


def cmd_segment(args) -> None:
    import cv2

    from adipose_tpu_torch.eval.evaluator import read_image_gray
    from adipose_tpu_torch.eval.visualize import color_overlay

    if args.bundle:
        from adipose_tpu_torch.serving.export import load_exported

        call, params, _manifest = load_exported(args.bundle, args.device)
        # normalization baked in; the program takes float32 gray
        predict = lambda p, tiles: call(p, tiles.to(torch.float32))  # noqa: E731
    elif args.weights:
        predict, params, _, _ = _load_segmenter(args.weights, device=args.device)
    else:
        raise SystemExit("segment requires --weights or --bundle")
    if args.use_tta:
        from adipose_tpu_torch.eval.tta import make_tta_predict
        from adipose_tpu_torch.ops.d4 import MODE_IDS

        predict = make_tta_predict(predict, args.tta_mode)
        # the views fold into the device batch: divide the tile chunk so the
        # forward batch stays at --batch-size
        views = len(MODE_IDS.get(args.tta_mode, MODE_IDS["basic"]))
        args.batch_size = max(1, args.batch_size // views)
    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    # output contract: masks/ always; probability_maps/ and overlays/ behind flags
    masks_dir = out_dir / "masks"
    masks_dir.mkdir(parents=True, exist_ok=True)
    if args.save_probability:
        (out_dir / "probability_maps").mkdir(exist_ok=True)
    if args.save_overlays:
        (out_dir / "overlays").mkdir(exist_ok=True)
    overlay_rgb = OVERLAY_RGB[args.overlay_color]
    files = sorted(
        p for p in in_dir.iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    )

    def write_outputs(item):
        p, img, pred = item
        mask = (pred > args.threshold).astype(np.uint8)
        cv2.imwrite(str(masks_dir / f"{p.stem}_mask.tif"), mask)
        if args.save_probability:
            cv2.imwrite(str(out_dir / "probability_maps" / f"{p.stem}_prob.tif"),
                        (np.clip(pred, 0, 1) * 255).astype(np.uint8))
        if args.save_overlays:
            ov = color_overlay(img, mask, overlay_rgb, alpha=0.4)
            cv2.imwrite(str(out_dir / "overlays" / f"{p.stem}_overlay.png"),
                        cv2.cvtColor(ov, cv2.COLOR_RGB2BGR))

    for i in range(0, len(files), args.batch_size):
        chunk = files[i : i + args.batch_size]
        # codec work is thread-parallel (cv2 releases the GIL)
        batch = np.stack(thread_map(lambda p: read_image_gray(str(p)), chunk))
        t0 = time.time()
        preds = segment_batch(predict, params, batch, args.batch_size, args.device)
        dt = time.time() - t0
        thread_map(write_outputs, list(zip(chunk, batch, preds)))
        print(f"[{i + len(chunk)}/{len(files)}] {dt / len(chunk):.3f}s/img")


def cmd_pipeline(args) -> None:
    from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

    seg_predict, seg_params, _, _ = _load_segmenter(args.segmenter_weights,
                                                    device=args.device)
    cls_predict, cls_state = _load_classifier(args.classifier_weights, device=args.device)
    pipe = DualModelWSIPipeline(
        cls_predict, cls_state, seg_predict, seg_params,
        tile_size=args.tile_size,
        classifier_threshold=args.classifier_threshold,
        batch_size=args.batch_size,
        transfer_dtype=args.transfer_dtype,
        device=args.device,
    )
    if args.wsi_dir:
        exts = (".tif", ".tiff", ".png", ".jpg", ".jpeg")
        paths = sorted(p for p in Path(args.wsi_dir).iterdir()
                       if p.suffix.lower() in exts and p.is_file())
        if not paths:
            raise SystemExit(f"no chunk images in {args.wsi_dir}")
        summaries = pipe.run_files(paths, args.output_dir, args.threshold)
        print(json.dumps({
            "n_chunks": len(summaries),
            "n_tiles": sum(s["n_tiles"] for s in summaries),
            "n_positive": sum(s["n_positive"] for s in summaries),
        }, indent=2))
    elif args.wsi:
        result = pipe.run_file(args.wsi, args.output_dir, args.threshold)
        print(json.dumps({"n_tiles": result.n_tiles, "n_good": result.n_good,
                          "n_positive": result.n_positive,
                          "timings": result.timings}, indent=2))
    else:
        raise SystemExit("pipeline requires --wsi or --wsi-dir")


def _plan(device: str, batch_size: int, num_devices: int, shard_spatial: bool = False):
    """The JAX planner's plan for the batch: ``make_mesh_for_batch``, or
    ``make_mesh_spatial`` over the default tile size (``UNetConfig``, as
    the JAX CLI plans it) with ``shard_spatial``; over the visible GPUs
    for a CUDA device, on the CPU over ``num_devices`` gloo ranks (0: one
    process)."""
    from adipose_tpu_torch.core.config import UNetConfig
    from adipose_tpu_torch.parallel.mesh import make_mesh_for_batch, make_mesh_spatial

    count = max(torch.cuda.device_count() if torch.device(device).type == "cuda"
                else max(num_devices, 1), 1)
    if shard_spatial:
        return make_mesh_spatial(batch_size, num_devices, UNetConfig().tile_size, count)
    return make_mesh_for_batch(batch_size, num_devices, count)


def _launch_ranks(rank_fn, args, batch_size: int, num_devices: int,
                  shard_spatial: bool = False):
    """Run ``rank_fn(rank, args)`` on every rank of the plan; rank 0's result.

    Under a launcher (torchrun) this process joins its group as one rank.
    Otherwise the ranks follow :func:`_plan`: one rank runs here, more are
    spawned (NCCL on CUDA, gloo on the CPU; they meet at a file store in the
    spawn's temporary directory), and a failing rank fails the command."""
    from adipose_tpu_torch.parallel.multihost import (initialize_multihost,
                                                      launched_world_size, process_index,
                                                      spawn_ranks)

    cuda = torch.device(args.device).type == "cuda"
    if launched_world_size() > 1:
        initialize_multihost(backend="nccl" if cuda else "gloo")
        return rank_fn(process_index(), args)
    plan = _plan(args.device, batch_size, num_devices, shard_spatial)
    n = plan.size
    print(f"[ranks] {n} of batch {batch_size} as data {plan.data} x model {plan.model} "
          f"({'NCCL, one GPU each' if cuda else 'gloo'})"
          if n > 1 else f"[ranks] 1 process for batch {batch_size}")
    if n == 1:
        return rank_fn(0, args)
    return spawn_ranks(rank_fn, n, (args,), "nccl" if cuda else "gloo")


def _rank_device(args) -> str:
    """This rank's device: ``cuda:LOCAL_RANK`` in a process group on CUDA,
    else ``--device``."""
    from adipose_tpu_torch.parallel.multihost import local_rank, process_count

    if torch.device(args.device).type == "cuda" and process_count() > 1:
        torch.cuda.set_device(local_rank())
        return f"cuda:{local_rank()}"
    return args.device


def cmd_train_unet(args) -> dict:
    return _launch_ranks(_train_unet_rank, args, args.batch_size, args.num_devices,
                         args.shard_spatial)


def _train_unet_rank(rank: int, args) -> dict:
    from adipose_tpu_torch.core.config import TrainConfig, UNetConfig
    from adipose_tpu_torch.data.tiling import find_most_recent_build_dir
    from adipose_tpu_torch.train.trainer_unet import UNetTrainer

    data_root = Path(args.data_root)
    if not (data_root / "dataset").exists():
        data_root = find_most_recent_build_dir(data_root)
    cfg = TrainConfig(
        batch_size=args.batch_size,
        epochs_phase1=args.epochs_phase1, epochs_phase2=args.epochs_phase2,
        optimizer=args.optimizer or ("adamw" if args.use_adamw else "adam"),
        weight_decay=args.weight_decay,
        use_hard_mining=args.use_hard_mining, ohem_ratio=args.ohem_ratio,
        use_label_smoothing=args.use_label_smoothing,
        epsilon_pos=args.epsilon_pos, epsilon_neg=args.epsilon_neg,
        ds_weight_main=args.ds_weight_main, ds_weight_aux1=args.ds_weight_aux1,
        ds_weight_aux2=args.ds_weight_aux2,
        use_ema=args.use_ema, ema_decay_phase2=args.ema_decay,
        use_cosine_schedule=args.use_cosine_schedule,
        warmup_epochs=args.warmup_epochs, warmup_epochs_phase2=args.warmup_epochs_phase2,
        augment_level=args.augment_level.replace("-", "_"),
        normalization_method=args.normalization_method,
        percentile_low=args.percentile_low, percentile_high=args.percentile_high,
        num_devices=args.num_devices, shard_spatial=args.shard_spatial,
        cache_limit_mb=args.cache_limit_mb,
    )
    trainer = UNetTrainer(data_root, cfg, UNetConfig(use_deep_supervision=args.use_deep_supervision),
                          checkpoint_name=args.checkpoint_name + args.checkpoint_suffix,
                          checkpoint_root=args.checkpoint_root,
                          build_timestamp=args.run_timestamp, auto_resume=args.auto_resume,
                          device=_rank_device(args))
    with _profiled(args.profile_dir if rank == 0 else None, "train_unet_trace.json"):
        result = trainer.train(resume_from=args.resume_from,
                               pretrained_weights=args.pretrained_weights)
    if rank == 0:
        print(json.dumps(result, indent=2))
    return result


def cmd_train_classifier(args) -> dict:
    # no --num-devices, as in the JAX CLI: TrainConfig.num_devices = 0, all devices
    return _launch_ranks(_train_classifier_rank, args, args.batch_size, 0)


def _train_classifier_rank(rank: int, args) -> dict:
    from adipose_tpu_torch.core.config import ClassifierConfig, TrainConfig
    from adipose_tpu_torch.train.trainer_classifier import ClassifierTrainer

    cfg = TrainConfig(batch_size=args.batch_size, lr_phase1=args.base_lr,
                      lr_phase2=args.finetune_lr, percentile_low=args.percentile_low,
                      percentile_high=args.percentile_high)
    mcfg = ClassifierConfig(unfreeze_from=args.unfreeze_from, dropout_rate=args.dropout)
    trainer = ClassifierTrainer(
        args.dataset_root, cfg, mcfg,
        label_smoothing=args.label_smoothing,
        percentile_norm=args.percentile_norm,
        use_class_weights=args.use_class_weights,
        pos_weight_multiplier=args.pos_weight_multiplier,
        checkpoint_root=args.checkpoint_dir, suffix=args.suffix,
        train_split=args.train_split, val_split=args.val_split,
        patience=args.patience, save_best_only=args.save_best_only,
        pretrained_weights=args.pretrained_weights,
        augment_low_res=args.augment_low_res,
        prep_megabatch=args.prep_megabatch,
        device=_rank_device(args),
    )
    with _profiled(args.profile_dir if rank == 0 else None, "train_classifier_trace.json"):
        result = trainer.train(args.warmup_epochs, args.finetune_epochs)
    if rank == 0:
        print(json.dumps(result, indent=2))
    return result


def _eval_config(args):
    from adipose_tpu_torch.core.config import EvalConfig

    return EvalConfig(
        use_tta=args.use_tta, tta_mode=args.tta_mode,
        use_sliding_window=args.sliding_window, sliding_overlap=args.overlap,
        blend_mode=args.blend_mode,
        use_boundary_refinement=args.boundary_refine,
        optimize_threshold=args.optimize_threshold or args.adaptive_threshold,
        adaptive_threshold=args.adaptive_threshold,
        n_bootstrap=args.n_bootstrap, use_ema_weights=args.ema,
        batch_size=args.batch_size,
        transfer_dtype=args.transfer_dtype,
        refine_kernel=args.refine_kernel,
        save_overlays=args.save_overlays,
        n_positive=args.n_positive,
        n_negative=args.n_negative,
    )


def cmd_evaluate(args) -> dict:
    from adipose_tpu_torch.eval.evaluator import PublicationEvaluator

    ev = PublicationEvaluator(args.weights, _eval_config(args), device=args.device)
    with _profiled(args.profile_dir, "evaluate_trace.json"):
        results = ev.evaluate(args.test_dataset, Path(args.test_dataset).name,
                              output_dir=args.output,
                              save_visualizations=args.save_visualizations,
                              n_vis_samples=args.n_vis_samples)
    print(json.dumps({k: results[k] for k in ("n_slides", "n_tiles", "optimal_threshold")},
                     indent=2))
    for k, v in results["metrics"].items():
        print(f"{k:>16}: {v['mean']:.4f} [{v['ci_lower']:.4f}, {v['ci_upper']:.4f}]")
    return results


def _selected_names(args) -> list[str]:
    """Dataset names picked by --val/--test/--human-test/--clean-test."""
    return [n for n in ("val", "test", "human_test", "clean_test") if getattr(args, n)]


def _selected_datasets(args) -> list[Path]:
    """The selector flags resolved under --data-root: <root>/<stain_normalized|
    original>/<name>, else <root>/<name> (evaluate_all_checkpoints.py:531-549,607)."""
    names = _selected_names(args)
    root = Path(args.data_root or ".")
    source = "stain_normalized" if args.stain else "original"
    return [root / source / n if (root / source / n).exists() else root / n for n in names]


def _batch_eval_config(args, **kw):
    from adipose_tpu_torch.core.config import EvalConfig

    return EvalConfig(
        use_tta=args.use_tta, tta_mode=args.tta_mode,
        use_sliding_window=args.sliding_window, sliding_overlap=args.overlap,
        blend_mode=args.blend_mode, use_boundary_refinement=args.boundary_refine,
        refine_kernel=args.refine_kernel, adaptive_threshold=args.adaptive_threshold,
        use_ema_weights=args.ema, **kw)


def cmd_evaluate_checkpoints(args) -> list:
    from adipose_tpu_torch.eval.batch_eval import CheckpointBatchEvaluator

    cfg = _batch_eval_config(args, optimize_threshold=True, n_bootstrap=args.n_bootstrap,
                             transfer_dtype=args.transfer_dtype)
    datasets = _selected_datasets(args) or (
        [Path(args.test_dataset)] if args.test_dataset else [])
    if not datasets:
        raise SystemExit("evaluate-checkpoints needs --test-dataset or a selector "
                         "(--val/--test/--human-test/--clean-test)")
    records = []
    for ds in datasets:
        be = CheckpointBatchEvaluator(args.checkpoints_root, ds, cfg,
                                      save_images=not args.no_images, parallel=args.parallel,
                                      max_workers=args.max_workers, device=args.device)
        records.extend(be.run(ds.name))
    for r in records:
        status = r["status"]
        extra = (f" dice={r['dice']:.4f}" if status == "success"
                 else f" {r.get('error', '')[:60]}")
        print(f"{status:>8}  {Path(r['checkpoint']).name}{extra}")
    return records


def cmd_visualize_metrics(args):
    from adipose_tpu_torch.eval.batch_eval import (collect_checkpoint_metrics,
                                                   plot_checkpoint_comparison)

    rows = collect_checkpoint_metrics(args.checkpoints_root, _batch_eval_config(args))
    if args.checkpoints:
        rows = [r for r in rows if r["checkpoint"] in args.checkpoints]
    # dataset and source selectors filter on the eval-dir name
    # ({dataset}_{source}_..., full_evaluation_enhanced.py:2060-2101)
    names = _selected_names(args)
    if names:
        rows = [r for r in rows if any(r["eval_dir"].startswith(f"{n}_") for n in names)]
    if args.stain or args.original:
        source = "stain" if args.stain else "original"
        rows = [r for r in rows if f"_{source}" in r["eval_dir"]]
    if not rows:
        print("no evaluated checkpoints found")
        return None
    out = plot_checkpoint_comparison(rows, f"{args.name}.png" if args.name else args.output,
                                     args.metric)
    print(f"wrote {out}")
    return out


def cmd_tile_classification_eval(args) -> dict:
    from adipose_tpu_torch.core.config import EvalConfig
    from adipose_tpu_torch.eval.evaluator import (PublicationEvaluator, load_validation_data,
                                                  read_image_gray)
    from adipose_tpu_torch.eval.tile_classification import run_tile_classification_evaluation

    ev = PublicationEvaluator(
        args.weights,
        EvalConfig(batch_size=8, transfer_dtype=args.transfer_dtype, use_tta=args.use_tta,
                   tta_mode=args.tta_mode, use_boundary_refinement=args.boundary_refine,
                   refine_kernel=args.refine_kernel),
        device=args.device)
    pairs = load_validation_data(args.test_dataset)
    _, preds = ev.predict_tiles([p for p, _ in pairs])
    trues = [(read_image_gray(m) > 127).astype(np.float32) for _, m in pairs]
    out = args.output or (ev.checkpoint_dir / "evaluation" / "tile_classification")
    # --threshold is a percentage (the reference's); --coverage-threshold a fraction
    coverage = (args.coverage_threshold if args.coverage_threshold is not None
                else args.threshold / 100.0)
    multi = args.multi_threshold
    if isinstance(multi, str):
        multi = [float(x) / 100.0 for x in multi.split(",") if x.strip()]
    results = run_tile_classification_evaluation(preds, trues, out, coverage, multi,
                                                 pixel_threshold=args.mask_threshold)
    print(json.dumps(results, indent=2, default=float))
    return results


def cmd_eval_classifier(args) -> dict:
    import csv

    from adipose_tpu_torch.data.loader import ClassificationDataset
    from adipose_tpu_torch.eval.classifier_eval import run_classifier_evaluation

    if args.tta is not None:  # reference-style --tta none|basic|full
        args.use_tta = args.tta != "none"
        if args.use_tta:
            args.tta_mode = args.tta
    if not (args.test_dir or args.dataset_root):
        raise SystemExit("eval-classifier requires --test-dir or --dataset-root")
    weights_path = ckpt.resolve_weights_path(args.weights)
    predict, state = _load_classifier(args.weights, args.device, args.percentile_norm,
                                      args.percentile_low, args.percentile_high)
    snapshots = [state] + [_classifier_state(extra, args.device) for extra in args.snapshot]
    test_dir = Path(args.test_dir) if args.test_dir else Path(args.dataset_root) / args.split
    ds = ClassificationDataset(test_dir, args.batch_size)
    cal_ds = None
    if args.calibration and args.calibration_val_root:
        cal_ds = ClassificationDataset(
            Path(args.calibration_val_root) / args.calibration_val_split, args.batch_size)
    slide_map = None
    if args.slide_map:
        with open(args.slide_map, newline="") as f:
            slide_map = {row["tile"]: row["slide_id"] for row in csv.DictReader(f)}
    out = args.output or (weights_path.parent / "evaluation" /
                          f"{test_dir.name}_tta_{args.tta_mode}")
    results = run_classifier_evaluation(
        predict, snapshots, ds, out,
        tta_mode=args.tta_mode, use_tta=args.use_tta,
        calibration=args.calibration, calibration_dataset=cal_ds,
        save_examples=args.save_examples, num_examples=args.num_examples,
        slide_map=slide_map, plots=args.save_plots,
        percentile_norm_examples=args.percentile_norm_examples,
        example_p_low=args.percentile_low, example_p_high=args.percentile_high,
        device=args.device)
    print(json.dumps({k: results[k] for k in ("roc_auc", "pr_auc", "best_threshold")},
                     indent=2))
    return results


def cmd_classify(args) -> list[dict]:
    import csv

    import cv2

    from adipose_tpu_torch.eval.evaluator import read_image_gray
    from adipose_tpu_torch.eval.tta import make_classifier_tta_predict

    # the reference inference CLI's preprocessing (classification_inference.py:
    # 288-320): no percentile stretch unless asked
    if args.bundle:
        # the exported classifier takes inception-preprocessed (B, 299, 299, 3)
        from adipose_tpu_torch.ops.d4 import CLASSIFIER_MODE_IDS
        from adipose_tpu_torch.serving.export import load_exported, read_manifest
        from adipose_tpu_torch.train.trainer_classifier import make_inception_preprocess

        mb = int(read_manifest(args.bundle).get("batch_size", args.batch_size))
        if mb != args.batch_size:
            print(f"bundle exported at batch {mb}; overriding --batch-size")
            args.batch_size = mb
        if args.use_tta:
            # the views fold into the fixed exported batch: chunk so that
            # views * chunk == the manifest's batch
            views = len(CLASSIFIER_MODE_IDS[args.tta_mode])
            if args.batch_size % views:
                raise SystemExit(f"--use-tta with --bundle needs the exported batch "
                                 f"({args.batch_size}) divisible by {views} TTA views")
            args.batch_size //= views
        call, state, _manifest = load_exported(args.bundle, args.device)
        pre = make_inception_preprocess(args.percentile_norm)

        def predict(variables, images):
            with torch.inference_mode():
                return call(variables, pre(images))
    elif args.weights:
        predict, state = _load_classifier(args.weights, args.device, args.percentile_norm)
    else:
        raise SystemExit("classify requires --weights or --bundle")
    if args.use_tta:
        predict = make_classifier_tta_predict(predict, args.tta_mode)
    in_dir = Path(args.input_dir)
    exts = (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    files = sorted(p for p in in_dir.glob(args.pattern)
                   if p.is_file() and p.suffix.lower() in exts)
    if not files and args.pattern == "**/*.jpg":
        # only the default pattern widens to every image type
        files = sorted(p for p in in_dir.rglob("*")
                       if p.is_file() and p.suffix.lower() in exts)
    if not files:
        raise SystemExit(f"no images match pattern {args.pattern!r} under {in_dir}")

    def read(p):
        if args.use_grayscale:
            return read_image_gray(str(p))
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)

    rows = []
    for i in range(0, len(files), args.batch_size):
        chunk = files[i:i + args.batch_size]
        batch = np.stack(thread_map(read, chunk))  # cv2 releases the GIL
        n = batch.shape[0]
        if n < args.batch_size:  # a fixed batch: repeat the last tile
            batch = np.concatenate([batch, np.repeat(batch[-1:], args.batch_size - n, 0)])
        probs = predict(state, torch.from_numpy(batch).to(args.device))[:n].cpu().numpy()
        for p, pr in zip(chunk, probs):
            bp = int(pr >= args.threshold)
            rows.append({"image_path": str(p), "adipose_probability": float(pr),
                         "binary_prediction": bp,
                         "is_adipose": "adipose" if bp else "not_adipose"})

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.output_csv:
        csv_path = Path(args.output_csv)
        csv_path.parent.mkdir(parents=True, exist_ok=True)
    else:  # predictions_{mode}{_tta}.csv (classification_inference.py:482-484)
        mode_str = "grayscale" if args.use_grayscale else "rgb"
        csv_path = out_dir / f"predictions_{mode_str}{'_tta' if args.use_tta else ''}.csv"
    with csv_path.open("w", newline="") as f:
        writer = csv.DictWriter(f, ["image_path", "adipose_probability", "binary_prediction",
                                    "is_adipose"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} predictions to {csv_path}")

    if args.save_visualizations:  # positive tiles annotated with their probability
        viz = out_dir / "visualizations"
        viz.mkdir(exist_ok=True)
        for r in rows:
            if not r["binary_prediction"]:
                continue
            img = cv2.imread(r["image_path"], cv2.IMREAD_COLOR)
            if img is None:
                continue
            cv2.putText(img, f"p={r['adipose_probability']:.3f}", (8, 28),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.9, (0, 255, 255), 2)
            cv2.imwrite(str(viz / Path(r["image_path"]).name), img)

    probs_all = np.array([r["adipose_probability"] for r in rows])
    n_pos = int(sum(r["binary_prediction"] for r in rows))
    print(f"total {len(rows)} | adipose {n_pos} ({100 * n_pos / len(rows):.1f}%) | "
          f"mean prob {probs_all.mean():.4f}")
    return rows


def cmd_export(args) -> Path:
    from adipose_tpu_torch.serving.export import export_model

    path = export_model(args.weights, args.model, args.output, batch_size=args.batch_size,
                        tile_size=args.tile_size, platforms=tuple(args.platforms),
                        device=args.device)
    print(f"exported {args.model} → {path}")
    return path


def cmd_import_weights(args) -> Path:
    """A TF ``.h5`` onto the full-size model's init (the port's seeded init
    for the leaves the file lacks), written as ``<output>/params.npz``."""
    from adipose_tpu_torch.core.seeding import generator_for
    from adipose_tpu_torch.models.convert import torch_inception_to_flax, torch_unet_to_flax
    from adipose_tpu_torch.models.tf_import import import_inception_weights, import_unet_weights

    if args.model == "unet":
        model = DilatedUNet(use_deep_supervision=args.use_deep_supervision,
                            compute_dtype=torch.float32)
        model.init_params(generator_for("unet.init", 0))
        variables = import_unet_weights(args.h5, torch_unet_to_flax(model.state_dict()))
    else:
        model = InceptionV3Classifier(compute_dtype=torch.float32)
        model.init_flax(generator_for("classifier.init", 0))
        variables = import_inception_weights(args.h5, torch_inception_to_flax(model.state_dict()))
    out = Path(args.output)
    ckpt.save_params(out.parent, out.name, variables)
    print(f"imported {args.h5} → {args.output}")
    return out


def _seed(args) -> int:
    from adipose_tpu_torch.core.seeding import get_project_seed

    return args.seed if args.seed is not None else get_project_seed()


def cmd_build_dataset(args):
    from adipose_tpu_torch.core.config import DataBuildConfig
    from adipose_tpu_torch.data.tiling import SegmentationDatasetBuilder

    if args.subtract and args.subtract_class == args.target_mask:
        raise SystemExit(f"cannot subtract '{args.subtract_class}' from itself "
                         f"(use --no-subtract)")
    stain = (args.apply_stain_norm if args.apply_stain_norm is not None
             else args.stain_normalize)
    cfg = DataBuildConfig(
        tile_size=args.tile_size, stride=args.stride,
        min_confidence_train=args.min_confidence_train,
        min_confidence_eval=args.min_confidence_val,
        white_threshold=args.white_threshold,
        white_ratio=args.white_ratio_limit,
        blur_threshold=args.blurry_threshold,
        negative_fraction=args.neg_pct, ambiguous_high=args.min_mask_ratio,
        val_fraction=args.val_ratio, test_fraction=args.test_ratio,
        apply_stain_norm=stain, seed=_seed(args),
        make_masks=args.make_masks, make_overlays=args.make_overlays,
        target_mask=args.target_mask, subtract=args.subtract,
        subtract_class=args.subtract_class,
        subtract_masks_dir=args.subtract_masks_dir,
        morph_close_k=args.morph_close_k, min_cc_px=args.min_cc_px,
        jpeg_quality=args.jpeg_quality, invert_input=args.invert_input,
        keep_white=args.keep_white, keep_blurry=args.keep_blurry,
        compression=args.compression, workers=args.workers,
        split_by_slide=args.split_by_slide,
        include_test_set=args.include_test_set,
        exclude_test_duplicates=args.exclude_test_duplicates,
        channel=args.channel,
        reference_path=args.reference_path,
        reference_metadata=args.reference_metadata,
        test_min_mask_ratio=args.test_min_mask_ratio,
        test_stride=args.test_stride, test_neg_pct=args.test_neg_pct,
        test_min_confidence=args.test_min_confidence,
        test_include_white=args.test_include_white,
        test_include_blurry=args.test_include_blurry,
        include_ambiguous=args.include_ambiguous,
    )
    out_parent = args.output_root or args.out_parent or args.data_root
    builder = SegmentationDatasetBuilder(cfg, out_parent=out_parent, device=args.device)
    root = builder.build(args.data_root, images_dir=args.input_images_dir,
                         masks_dir=args.input_masks_dir)
    print(f"build complete: {root}")
    print((root / "build_summary.txt").read_text())
    return builder


def cmd_build_test_dataset(args):
    from adipose_tpu_torch.core.config import DataBuildConfig
    from adipose_tpu_torch.data.tiling import SegmentationDatasetBuilder

    cfg = DataBuildConfig(
        tile_size=args.tile_size, stride=args.stride,
        test_stride=args.stride,
        target_mask=args.target_mask, subtract=args.subtract,
        subtract_class=args.subtract_class,
        morph_close_k=args.morph_close_k, min_cc_px=args.min_cc_px,
        white_threshold=args.white_threshold,
        white_ratio=args.white_ratio_limit,
        blur_threshold=args.blurry_threshold,
        test_min_mask_ratio=args.min_mask_ratio,
        test_include_white=args.include_white,
        test_include_blurry=args.include_blurry,
        include_ambiguous=args.include_ambiguous,
        jpeg_quality=args.jpeg_quality, compression=args.compression,
        workers=args.workers, test_neg_pct=args.neg_pct,
        min_confidence_train=args.min_confidence,
        test_min_confidence=args.min_confidence,
        apply_stain_norm=args.stain_normalize,
        reference_metadata=args.reference_metadata,
        reference_path=args.reference_path,
        seed=_seed(args),
        val_fraction=0.0, test_fraction=0.0,
    )
    builder = SegmentationDatasetBuilder(cfg, out_parent=args.output_dir, device=args.device)
    root = builder.build(args.images_dir, images_dir=args.images_dir,
                         masks_dir=args.masks_dir, mark_all_test=True)
    print(f"test-set build complete: {root}")
    print((root / "build_summary.txt").read_text())
    return builder


def cmd_build_class_dataset(args):
    from adipose_tpu_torch.core.config import DataBuildConfig
    from adipose_tpu_torch.data.class_builder import ClassificationDatasetBuilder

    stain = next((v for v in (args.apply_stain_norm, args.stain_normalize)
                  if v is not None), False)
    cfg = DataBuildConfig(
        tile_size=args.tile_size, stride=args.stride,
        adipose_coverage_threshold=args.adipose_threshold,
        channel=args.channel, negative_fraction=args.neg_pct,
        apply_stain_norm=stain,
        val_fraction=args.val_ratio, test_fraction=args.test_ratio,
        white_threshold=args.white_threshold,
        white_ratio=args.white_ratio_limit,
        blur_threshold=args.blurry_threshold,
        min_confidence_train=args.min_confidence_train,
        min_confidence_eval=args.min_confidence_val,
        include_ambiguous=args.include_ambiguous,
        jpeg_quality=args.jpeg_quality, seed=_seed(args),
        keep_white=args.keep_white, keep_blurry=args.keep_blurry,
        balance_classes=args.balance_classes,
        reference_path=args.reference_path,
        reference_metadata=args.reference_metadata,
        exclude_test_duplicates=args.exclude_test_duplicates,
    )
    builder = ClassificationDatasetBuilder(
        cfg, out_parent=args.out_parent or args.data_root, device=args.device)
    root = builder.build(args.data_root)
    print(f"build complete: {root}")
    return builder


def cmd_build_test_class_dataset(args):
    from adipose_tpu_torch.core.config import DataBuildConfig
    from adipose_tpu_torch.data.class_builder import ClassificationDatasetBuilder

    cfg = DataBuildConfig(
        tile_size=args.tile_size, stride=args.stride, test_stride=args.stride,
        adipose_coverage_threshold=args.adipose_threshold,
        white_threshold=args.white_threshold,
        white_ratio=args.white_ratio_limit,
        blur_threshold=args.blurry_threshold,
        keep_white=args.keep_white, keep_blurry=args.keep_blurry,
        jpeg_quality=args.jpeg_quality,
        min_confidence_train=args.min_confidence,
        min_confidence_eval=args.min_confidence,
        include_ambiguous=args.include_ambiguous,
        apply_stain_norm=args.stain_normalize,
        reference_metadata=args.reference_metadata,
        reference_path=args.reference_path,
        seed=_seed(args),
        balance_classes=False,  # isolated test sets keep every tile
        val_fraction=0.0, test_fraction=0.0,
    )
    builder = ClassificationDatasetBuilder(cfg, out_parent=args.output_dir, device=args.device)
    root = builder.build(args.images_dir, images_dir=args.images_dir,
                         masks_dir=args.masks_dir, mark_all_test=True)
    print(f"test class-set build complete: {root}")
    return builder


def cmd_reconstruct(args) -> dict:
    from adipose_tpu_torch.wsi.reconstruct import reconstruct_all_slides

    predict, params, _, _ = _load_segmenter(args.weights, device=args.device)
    batch = args.batch_size
    if args.use_tta:
        from adipose_tpu_torch.eval.tta import make_tta_predict
        from adipose_tpu_torch.ops.d4 import MODE_IDS

        predict = make_tta_predict(predict, args.tta_mode)
        # keep the device batch at --batch-size: the views fold into it
        batch = max(1, batch // len(MODE_IDS.get(args.tta_mode, MODE_IDS["basic"])))
    log = reconstruct_all_slides(
        args.images_dir, args.masks_dir, args.output_dir, predict, params,
        tile_size=args.tile_size, stride=args.stride,
        min_coverage=args.min_coverage, threshold=args.threshold,
        data_root=args.data_root,
        batch_size=batch, use_refinement=args.boundary_refine,
        blend_mode=args.blend_mode, refine_kernel=args.refine_kernel,
        max_tiles=args.max_tiles, save_masks=args.save_masks,
        save_overlays=args.save_overlays,
        save_comparisons=args.save_comparisons,
        device=args.device,
    )
    print(json.dumps({"slides": list(log["slides"]), "skipped": log["skipped"]},
                     indent=2))
    return log


# pandas' read_csv default missing-value strings: such a cell counts as absent
_NA_STRINGS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                         "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
                         "n/a", "nan", "null"})


def cmd_classification_overlay(args):
    import csv
    import re

    import cv2

    from adipose_tpu_torch.wsi.overlay import create_overlay

    threshold = args.threshold
    if threshold is None and args.metrics_json:
        threshold = float(json.loads(Path(args.metrics_json).read_text())
                          .get("best_threshold", 0.5))
    if threshold is None:
        threshold = 0.5

    with open(args.predictions_csv, newline="") as f:
        table = list(csv.DictReader(f))

    # three CSV dialects: the reference evaluator's (path/label/prob,
    # reconstruct_wsi_classification.py:223-225), the inference CLI's
    # (image_path/adipose_probability/binary_prediction), and bare
    # file/probability/prediction
    def col(row, *names, default=None):
        for nm in names:
            if row.get(nm) is not None and row[nm] not in _NA_STRINGS:
                return row[nm]
        return default

    results = []
    for row in table:
        fname = Path(str(col(row, "path", "image_path", "file"))).name
        prob = col(row, "prob", "adipose_probability", "probability")
        pred = (int(float(prob) >= threshold) if prob is not None
                else int(float(col(row, "binary_prediction", "prediction", default=0))))
        label = int(float(col(row, "label", default=pred)))
        results.append((fname, label, pred))

    def render(wsi_path: Path, out_path: Path, subset):
        wsi = cv2.imread(str(wsi_path), cv2.IMREAD_UNCHANGED)
        if wsi is None:
            print(f"skipping unreadable {wsi_path}")
            return
        out = create_overlay(wsi, subset, args.tile_size, args.combine,
                             alpha=args.overlay_alpha,
                             downsample=args.downsample)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out_path), out)
        if args.save_original:
            ds = wsi[:: args.downsample, :: args.downsample]
            cv2.imwrite(str(out_path.parent / f"{wsi_path.stem}_original.png"), ds)
        print(f"wrote {out_path}")

    if args.wsi_dir:
        out_dir = Path(args.output_dir or args.output or ".")
        exts = (".tif", ".tiff", ".png", ".jpg", ".jpeg")
        for wsi_path in sorted(Path(args.wsi_dir).iterdir()):
            if wsi_path.suffix.lower() not in exts or not wsi_path.is_file():
                continue
            # exact slide match: stem followed by only coordinate suffixes;
            # a bare prefix test misassigns 'S1_10' tiles to slide 'S1_1'
            pat = re.compile(
                rf"^{re.escape(wsi_path.stem)}"
                rf"(_x\d+_y\d+(_w\d+_h\d+)?)?(_grid_\d+x\d+_tile_\d+)?"
                rf"_r\d+_c\d+$"
            )
            subset = [r for r in results if pat.match(Path(r[0]).stem)]
            if not subset:
                continue
            render(wsi_path, out_dir / f"{wsi_path.stem}_overlay.png", subset)
    elif args.wsi:
        out = Path(args.output or
                   (Path(args.output_dir or ".") /
                    f"{Path(args.wsi).stem}_overlay.png"))
        render(Path(args.wsi), out, results)
    else:
        raise SystemExit("classification-overlay requires --wsi or --wsi-dir")


def cmd_run_pipeline(args) -> dict:
    """Phase orchestration with dataset validation and a timing summary
    (``Segmentation/run_complete_pipeline.sh`` phases :195-516): build,
    train, val-set evaluation with the threshold search, test-set
    evaluation at that threshold, in one process."""
    from adipose_tpu_torch.core.config import (DataBuildConfig, EvalConfig, TrainConfig,
                                               UNetConfig)
    from adipose_tpu_torch.data.tiling import (SegmentationDatasetBuilder,
                                               find_most_recent_build_dir)
    from adipose_tpu_torch.eval.evaluator import PublicationEvaluator
    from adipose_tpu_torch.train.trainer_unet import UNetTrainer

    timings = {}
    data_root = Path(args.data_root)

    if args.skip_build:
        build_root = (
            data_root if (data_root / "dataset").exists()
            else find_most_recent_build_dir(data_root)
        )
    else:
        t0 = time.time()
        build_cfg = DataBuildConfig(
            tile_size=args.tile_size, stride=args.stride or args.tile_size,
            val_fraction=args.val_ratio, test_fraction=args.test_ratio,
        )
        build_root = SegmentationDatasetBuilder(
            build_cfg, out_parent=data_root, device=args.device
        ).build(data_root)
        timings["build_s"] = time.time() - t0

    # dataset validation (run_complete_pipeline.sh:111-167)
    n_train = len(list((build_root / "dataset" / "train" / "images").glob("*.jpg")))
    if n_train < args.min_train_tiles:
        raise SystemExit(
            f"dataset validation failed: {n_train} train tiles < {args.min_train_tiles}"
        )

    t0 = time.time()
    trainer = UNetTrainer(
        build_root, TrainConfig(batch_size=args.batch_size),
        UNetConfig(tile_size=args.tile_size, init_nb=args.init_nb),
        device=args.device,
    )
    train_result = trainer.train(args.epochs_phase1, args.epochs_phase2)
    timings["train_s"] = time.time() - t0
    ckpt_dir = train_result["checkpoint_dir"]

    cfg = EvalConfig(use_tta=args.use_tta, optimize_threshold=True)
    t0 = time.time()
    ev = PublicationEvaluator(ckpt_dir, cfg, device=args.device)
    val_results = ev.evaluate(build_root / "dataset" / "val", "val")
    timings["val_eval_s"] = time.time() - t0

    t0 = time.time()
    test_cfg = EvalConfig(use_tta=args.use_tta, optimize_threshold=False,
                          threshold=val_results["optimal_threshold"])
    test_results = PublicationEvaluator(ckpt_dir, test_cfg, device=args.device).evaluate(
        build_root / "dataset" / "test", "test"
    )
    timings["test_eval_s"] = time.time() - t0

    summary = {
        "checkpoint_dir": ckpt_dir,
        "val_dice": val_results["metrics"]["dice_score"]["mean"],
        "test_dice": test_results["metrics"]["dice_score"]["mean"],
        "optimal_threshold": val_results["optimal_threshold"],
        "timings": timings,
    }
    print(json.dumps(summary, indent=2))
    return summary


def cmd_chunk_wsi(args):
    from adipose_tpu_torch.core.config import WSIChunkConfig
    from adipose_tpu_torch.wsi.chunker import (chunk_directory, chunk_wsi_adaptive,
                                               chunk_wsi_grid)

    cfg = WSIChunkConfig(
        primary_tile=args.primary_tile, grid_tile=args.grid_tile,
        grid_overlap=args.grid_overlap, enhancement=args.enhancement, invert=args.invert,
        max_chunk_mb=args.max_file_size_mb, max_dimension_px=args.max_dimension_px,
        min_dimension_px=args.min_dimension_px, output_format=args.output_format,
        bit_depth=args.bit_depth, save_enhanced=args.save_enhanced,
    )
    if args.input_dir:
        exts = tuple(e if e.startswith(".") else f".{e}"
                     for e in (s.strip().lower() for s in args.extensions.split(",")) if e)
        report = chunk_directory(args.input_dir, args.output_dir, cfg, mode=args.mode,
                                 extensions=exts, skip_existing=args.skip_existing,
                                 dry_run=args.dry_run, device=args.device)
        print(json.dumps({"processed": len(report["processed"]),
                          "skipped": len(report["skipped"]),
                          "outputs": len(report["outputs"]),
                          "dry_run": args.dry_run}, indent=2))
        return report
    if not args.input:
        raise SystemExit("chunk-wsi requires --input or --input-dir")
    if args.mode == "adaptive":
        written = chunk_wsi_adaptive(args.input, args.output_dir, cfg, dry_run=args.dry_run,
                                     device=args.device)
    else:
        written = chunk_wsi_grid(args.input, args.output_dir, cfg, dry_run=args.dry_run)
    print(f"{'planned' if args.dry_run else 'wrote'} {len(written)} chunks "
          f"to {args.output_dir}")
    return written


def ecm_config(args):
    """The ``ECMPreprocessConfig`` of ``preprocess-ecm``'s flags."""
    from adipose_tpu_torch.core.config import ECMPreprocessConfig

    return ECMPreprocessConfig(
        deband_method=args.deband,
        fft_freq_low=args.fft_freq_low, fft_freq_high=args.fft_freq_high,
        fft_width=args.fft_width, fft_sigma_scale=args.fft_sigma_scale,
        fft_blend=args.fft_blend,
        morph_width=args.morph_width, morph_height=args.morph_height,
        column_preserve_global=args.column_preserve_global,
        normalization_method=args.normalization_method,
        percentile_low=args.percentile_low, percentile_high=args.percentile_high,
        illumination_method=args.illumination.replace("-", "_"),
        rolling_ball_radius=args.rolling_ball_radius,
        poly_sigma=args.poly_sigma, tophat_kernel=args.tophat_kernel,
        clahe_illum_tile=args.clahe_illum_tile, clahe_illum_clip=args.clahe_illum_clip,
        apply_clahe=args.clahe, clahe_clip=args.clahe_clip_limit,
        clahe_grid=args.clahe_tile_size,
        sharpen=args.sharpen, sharpen_sigma=args.sharpen_sigma,
        sharpen_amount=args.sharpen_amount,
    )


def cmd_preprocess_ecm(args) -> dict:
    from adipose_tpu_torch.wsi.ecm import process_directory

    log = process_directory(args.input_dir, args.output_dir, ecm_config(args),
                            visualize=args.visualize,
                            max_visualizations=args.max_visualizations,
                            test_mode=args.test_mode, test_samples=args.test_samples,
                            device=args.device)
    print(f"processed {len(log['processed'])}, errors {len(log['errors'])}")
    return log


def cmd_scale_ecm(args) -> int:
    import cv2

    from adipose_tpu_torch.wsi.compare import resample_image

    in_dir, ref_dir = Path(args.input_dir), Path(args.reference_dir)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    refs = {p.stem: p for p in ref_dir.iterdir() if p.is_file()}
    n = 0
    for p in sorted(in_dir.iterdir()):
        if not p.is_file() or p.stem not in refs:
            continue
        img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        ref = cv2.imread(str(refs[p.stem]), cv2.IMREAD_UNCHANGED)
        if img is None or ref is None:
            continue
        if args.dry_run:
            print(f"would resample {p.name}: {img.shape[:2]} -> {ref.shape[:2]}")
            n += 1
            continue
        out = resample_image(img, ref.shape[:2], args.interpolation)
        cv2.imwrite(str(out_dir / p.name), out)
        n += 1
    print(f"rescaled {n} images")
    return n


def cmd_compare_modalities(args) -> list:
    from adipose_tpu_torch.wsi.compare import compare_directories

    rows = compare_directories(args.pseudo_dir, args.ecm_dir, args.output_dir, args.n_samples,
                               n_perfect=args.n_perfect, n_mismatch=args.n_mismatch,
                               seed=args.seed, device=args.device)
    print(f"compared {len(rows)} pairs → {args.output_dir}/comparison_metrics.csv")
    return rows


def cmd_tif2jpg(args) -> int:
    from adipose_tpu_torch.wsi.compare import convert_tif_to_jpg

    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(in_dir.glob("*.tif")) + sorted(in_dir.glob("*.tiff")):
        if args.dry_run:
            print(f"would convert {p.name}")
            n += 1
        elif convert_tif_to_jpg(p, out_dir / f"{p.stem}.jpg", args.quality, invert=args.invert):
            n += 1
    print(f"{'would convert' if args.dry_run else 'converted'} {n} images")
    return n


def cmd_analyze_tiles(args) -> dict:
    """Each requested mode in the JAX package's order (the census when none
    is asked for); each prints what the JAX CLI prints. Returns each mode's
    result by name."""
    from adipose_tpu_torch.data import analysis

    if not (args.census or args.compare_preprocessing or args.morphology
            or args.contrast_groups or args.compare_normalization
            or args.comprehensive_normalization):
        args.census = True
    out, dev = {}, args.device
    if args.census:
        out["census"] = analysis.tile_quality_census(args.tiles_dir, args.output_dir,
                                                     max_tiles=args.max_tiles, device=dev)
        print(json.dumps(out["census"], indent=2))
    if args.compare_preprocessing:
        out["compare_preprocessing"] = analysis.preprocessing_comparison(
            args.tiles_dir, args.output_dir, n_samples=args.n_samples, device=dev)
        print(f"wrote preprocessing comparison to {args.output_dir}")
    if args.morphology:
        out["morphology"] = analysis.morphology_census(args.tiles_dir, args.output_dir,
                                                       n_samples=args.n_samples)
        print(json.dumps(out["morphology"]["optimized_parameters"], indent=2))
    if args.contrast_groups:
        out["contrast_groups"] = analysis.contrast_group_census(
            args.tiles_dir, args.output_dir, n_per_split=args.n_per_split, device=dev)
        print(json.dumps(out["contrast_groups"], indent=2))
    if args.compare_normalization:
        modes = (sorted(analysis.NORM_COMPARISON_MODES)
                 if args.compare_normalization == "all" else [args.compare_normalization])
        out["compare_normalization"] = []
        for mode in modes:
            res = analysis.normalization_comparison(args.tiles_dir, args.output_dir, mode,
                                                    n_samples=args.n_per_split, device=dev)
            out["compare_normalization"].append(res)
            print(json.dumps(res, indent=2))
    if args.comprehensive_normalization:
        out["comprehensive_normalization"] = analysis.comprehensive_normalization_analysis(
            args.tiles_dir, args.output_dir, n_per_split=args.n_samples,
            adipocyte_dir=args.adipocyte_dir, device=dev)
        print(json.dumps(out["comprehensive_normalization"], indent=2))
    return out


def cmd_visualize_preprocessing(args) -> dict:
    from adipose_tpu_torch.data.analysis import preprocessing_pipeline_visualization

    out = preprocessing_pipeline_visualization(args.tiles_dir, args.output_dir,
                                               n_samples=args.n_samples,
                                               stats_path=args.stats, device=args.device)
    print(json.dumps(out, indent=2))
    return out


def cmd_select_stain_reference(args) -> dict:
    from adipose_tpu_torch.data.stain_select import select_stain_reference

    meta = select_stain_reference(args.candidate_dir, args.output_dir, args.max_candidates,
                                  device=args.device)
    print(json.dumps(meta["selected_reference"], indent=2))
    return meta


def cmd_validate_stain(args) -> dict:
    from adipose_tpu_torch.data.stain_select import validate_stain_reference

    summary = validate_stain_reference(args.metadata, args.sample_dir, args.output_dir,
                                       args.n_samples, device=args.device)
    print(f"valid {summary['n_valid']}/{summary['n_samples']}")
    return summary


@contextlib.contextmanager
def _profiled(profile_dir: str | None, name: str):
    """A torch.profiler trace of the block written to ``profile_dir/name``
    (host and, where there is a card, device activities, and the block's
    program spans on a track of their own); nothing without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = tracing.mark()
    with profile(activities=activities) as prof:
        yield
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    path = Path(profile_dir) / name
    prof.export_chrome_trace(str(path))
    tracing.add_to_chrome_trace(path, since)


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
