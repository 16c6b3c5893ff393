"""``adipose-torch``: the port's command line.

``adipose-torch segment`` and ``adipose-torch pipeline`` are ``adipose
segment`` and ``adipose pipeline`` (``adipose_tpu/cli/main.py``) on a torch
device, with the same flags plus ``--device``. They read ``params.npz``
weights (see :mod:`adipose_tpu_torch.train.checkpoint`).
"""

from __future__ import annotations

import argparse
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
    s.add_argument("--use-tta", action="store_true", help="(not ported yet)")
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
    return parser


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


def _load_classifier(weights, device="cuda"):
    """``(predict, state)`` for a classifier checkpoint dir:
    ``predict(state, tiles)`` percentile-stretches (B, H, W) uint8/float32
    tiles on ``device``, resizes them to 299^2 and runs the bf16
    InceptionV3; it returns (B,) float32 probabilities."""
    variables = ckpt.load_params(ckpt.resolve_weights_path(weights))
    state = {k: v.to(device) for k, v in flax_inception_to_torch(variables).items()}
    # predict() runs on the state it is given
    model = InceptionV3Classifier(compute_dtype=torch.bfloat16, device="meta")
    return _make_val_step(model, True, 1.0, 99.0), state


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
    if args.use_tta:
        raise SystemExit("segment --use-tta is not ported yet")
    if not args.weights:
        raise SystemExit("segment requires --weights")
    predict, params, _, _ = _load_segmenter(args.weights, device=args.device)
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


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
