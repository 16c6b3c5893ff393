"""``adipose-torch``: the port's command line.

``adipose-torch segment`` (with ``--use-tta``), ``classify``, ``evaluate``,
``evaluate-checkpoints``, ``eval-classifier``, ``tile-classification-eval``,
``visualize-metrics``, ``pipeline``, ``train-unet`` and ``train-classifier``
are those subcommands of ``adipose`` (``adipose_tpu/cli/main.py``) on a torch
device, with the same flags plus ``--device`` where a model runs. They read
and write ``params.npz`` weights (see :mod:`adipose_tpu_torch.train.checkpoint`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

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
                   help="StableHLO export bundle (not ported yet)")
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
    return parser


def _add_device(p, func) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; on 'cpu' the kernels' plain versions run")
    p.set_defaults(func=func)


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
    ci.add_argument("--bundle", default=None, help="export bundle (not ported yet)")
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
                         "(train_adipose_classifier_v0.py:322-353; a TF .h5 is not ported yet)")
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
                        "holding params.npz (a TF .h5 is not ported yet)")
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
                   help="more than one device is not ported yet")
    t.add_argument("--shard-spatial", action="store_true", help="(not ported yet)")
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
    (n, H, W) float32 probability maps."""
    n = batch.shape[0]
    if n < batch_size:
        batch = np.concatenate([batch, np.repeat(batch[-1:], batch_size - n, 0)])
    tiles = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    return predict(params, tiles)[:n].cpu().numpy()


def cmd_segment(args) -> None:
    import cv2

    from adipose_tpu_torch.eval.evaluator import read_image_gray
    from adipose_tpu_torch.eval.visualize import color_overlay

    if args.bundle:
        raise SystemExit("segment --bundle is not ported yet")
    if not args.weights:
        raise SystemExit("segment requires --weights")
    predict, params, _, _ = _load_segmenter(args.weights, device=args.device)
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


def cmd_train_unet(args) -> dict:
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
                          device=args.device)
    with _profiled(args.profile_dir, "train_unet_trace.json"):
        result = trainer.train(resume_from=args.resume_from,
                               pretrained_weights=args.pretrained_weights)
    print(json.dumps(result, indent=2))
    return result


def cmd_train_classifier(args) -> dict:
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
        device=args.device,
    )
    with _profiled(args.profile_dir, "train_classifier_trace.json"):
        result = trainer.train(args.warmup_epochs, args.finetune_epochs)
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

    if args.bundle:
        raise SystemExit("classify --bundle is not ported yet")
    if not args.weights:
        raise SystemExit("classify requires --weights")
    # the reference inference CLI's preprocessing (classification_inference.py:
    # 288-320): no percentile stretch unless asked
    predict, state = _load_classifier(args.weights, args.device, args.percentile_norm)
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


@contextlib.contextmanager
def _profiled(profile_dir: str | None, name: str):
    """A torch.profiler trace of the block written to ``profile_dir/name``
    (host and, where there is a card, device activities); nothing without
    a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / name))


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
