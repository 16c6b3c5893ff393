#!/usr/bin/env python3
"""Drive the PyTorch port's segment path, WSI cascade, evaluation, U-Net
training, classifier training, classifier evaluation, dataset builds, WSI
tools, WSI preparation tools and conv-chain layout probe once on one CUDA
GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one line each or more; any failure raises and the script exits nonzero:
  1. device  the card's name and power limit (nvidia-smi)
  2. build   the CUDA kernels from adipose_tpu_torch/csrc into build/kernels,
     one nvcc per source, in parallel
  3. kernel A (fused z-score) against its plain version at (16, 1024, 1024)
  4. kernel B (sigmoid head) against its plain version at the main path's
     shape (16, 44, 1024, 1024) and the aux heads' C = 176 and 88
  5. kernel P (percentile stretch) against its plain version at
     (16, 1024, 1024): uint8, float32 rounded first, 70% one value
  5b. kernel D (batched D4 transform) bit-equal to its plain version at
     (2, 1024, 1024) over all 8 ids, (16, 1024, 1024) and (8, 1000, 1000);
     the inverse ids restore the input
  5c. kernel B' (head backward) against its plain version at the training
     path's head shapes (batch 2; C = 44, 176, 88; bf16, and f32 at C = 44),
     at batch 8, and on the general path (C = 37, whose channel period is
     too long for the period path; an x that is not 16-byte aligned) and a
     pixel count that ends inside a period; each case's path printed; then
     the autograd Function against plain autograd
  5d. kernel I (identity on the (H, W, B, C) view) bit-equal to its plain
     version, strides kept, on the probe's view of a channels-last
     (16, 64, 1024, 1024) bf16 activation, a contiguous (1024, 1024, 16, 64)
     tensor, (64, 1000, 3, 44), the odd (7, 9, 3, 5) with a scalar tail, and
     a view that starts 1 element into its storage (element by element);
     each case's plan printed
  6. slice   a seeded init_nb=44 checkpoint loaded through the port's
     ``_load_segmenter``, requests of 16 distinct 1024^2 uint8 tiles
     answered through ``segment_batch``, checked against the same model run
     with the plain z-score and head
  7. cascade ``adipose-torch pipeline`` (``cli.main.main``) over three chunk
     PNGs (6144^2, 6144x4096, 3000x5000) with a seeded full InceptionV3
     and the init_nb=44 U-Net, 1024^2 tiles, batch 16; launch counts per
     chunk batch; checked against the same cascade with the plain versions
  7b. evaluate  ``adipose-torch evaluate`` (``cli.main.main``) with the
     slice's checkpoint: full TTA at batch 16 with 1000 resamples and the
     threshold search on 8 tiles of 1024^2 over 2 slides; minimal TTA with
     the sliding window, boundary refinement and overlays on a 4096x3072
     and a 900x700 image; then ``adipose-torch segment --use-tta --tta-mode
     basic``: artifacts, launches A 1, B 1, D 2 per TTA predict; the
     evaluator through the kernels against the plain versions (maps,
     threshold, means); full TTA of an equivariant predict returns its
     tile; each sliding-window map has its image's size; timings: predict
     per chunk without TTA, with basic and full, D and A at the TTA shapes,
     the sliding window per large image (predict and blend), one evaluate
     run by stage and its device idle share
  8. train   ``adipose-torch train-unet`` (``cli.main.main``) at its defaults
     (init_nb 44, 1024^2, batch 2, bf16, deep supervision, OHEM, EMA,
     cosine, moderate augmentation, percentile) for one epoch per phase on
     a seeded 8 + 4 tile dataset: the artifact contract, finite losses, an
     encoder untouched by phase 1, launches D 2 and P 1 per step and P 1 per
     val batch; the run then served by ``adipose-torch segment``
  9. fast head ``UNetTrainer`` with ``UNetConfig(fast_head=True)``: kernels
     B and B' 3 per step; its first step through the kernels against the
     same step with the plain versions
  9a. train classifier  ``adipose-torch train-classifier`` (``cli.main.main``)
     at its defaults (batch 32, bf16, percentile, unfreeze mixed7, label
     smoothing 0.1, dropout 0.4) from seeded pretrained weights, 1 + 1
     epochs on a seeded 64 + 32 tile 1024^2 dataset: the artifact contract,
     finite losses, the backbone and its statistics bit-unchanged through
     phase 1 and convs 0-69 through phase 2, launches P 1 and D 1 a step and
     P 1 a val batch; each phase's first step through the kernels against
     the same step with the plain versions; ``weights_best`` served through
     ``_load_classifier`` gives the logged val AUC; an ``--augment-low-res``
     step (D at (32, 299, 299)); timings: the train step of each phase and
     the prep alone by CUDA events, P and D at the path's shapes, peak
     memory, the device's idle share over one epoch
  9b. classifier evaluation  with the classifier run of 9a and the slice's
     U-Net run, through cli.main.main: ``adipose-torch eval-classifier`` at
     its defaults (batch 64, full TTA = 512 views of 1024^2, percentile
     norm, plots, examples) with isotonic calibration on a 64-tile val
     split and weights_final as a snapshot, on 128 seeded test tiles over 4
     slides (P and D once per chunk per snapshot per set); ``classify
     --use-tta --tta-mode basic --percentile-norm`` at batch 32, and at its
     defaults (no kernel); ``tile-classification-eval --use-tta
     --multi-threshold`` on 7b's 8 tiles; ``evaluate-checkpoints`` over two
     copies of the slice's run, then ``visualize-metrics``; each kernel path
     against the same call under the plain versions (launches nothing;
     probabilities within 1e-6, the same threshold, equal JSON); timings:
     the TTA predict per chunk of 64 tiles, the flow by stage and its idle
     share, P and D at (512, 1024^2) f32 bit-equal to plain, beside their
     bounds
  9d. builds  seeded RGB slides at the chunk sizes (6144^2, 6144x4096,
     3000x5000: 75 tiles of 1024^2) with fat and bubbles annotations at
     confidences 1-3, a near-white band and a blurred region, through
     cli.main.main: ``build-dataset`` at every default (stain on; every
     device call on the card, no kernel launched; the artifact contract)
     and with ``--no-stain-normalize`` (the white gate); the 3000x5000
     slide's build on the card against the same build on the CPU (names,
     masks, stats, logs; the device work's verdicts and grayscale, within
     1 level in at most 1e-3 of the pixels of well-conditioned tiles; each
     JPEG the encoding of its device's tile); ``build-class-dataset
     --stain-normalize true`` (byte-identical manifests against the CPU);
     ``build-test-dataset`` and ``build-test-class-dataset`` over the
     6144x4096 slide; ``reconstruct --use-tta --tta-mode basic`` over that
     test set (A 1, B 1, D 2 per predict; under plain_kernels() nothing
     launched, maps within 1 level); ``classification-overlay`` from a
     ``classify`` CSV; ``run-pipeline`` at its defaults, 1 + 1 epochs, on
     four slides (launches by stage); timings: the build by stage, tiles/s,
     the device work per chunk of 16 by CUDA events, the tiling's idle
     share, reconstruct per slide, run-pipeline by stage
  9e. WSI tools  under PyTorch's TF32 default, on a seeded 16-bit 16384x9216
     slide (151 M px) and a 4096^2 one, through cli.main.main:
     ``chunk-wsi --input-dir`` at its defaults (6 chunks named from
     generate_axis_segments, the small slide skipped), with ``--enhancement
     clahe --save-enhanced``, percentile and zscore (each written chunk the
     JPEG of the card's array; the 4096x3072 tail chunk, and a 16-bit crop,
     on the card against the CPU within 1 level) and ``--mode grid``;
     ``preprocess-ecm`` over the chunks with four stage stacks (the first
     on the card against the CPU on the tail chunk, within one clipped-CDF
     step; the sigma-150 blur against the CPU), ``tif2jpg --invert``,
     ``scale-ecm`` from half-size copies, ``compare-modalities`` on 1024^2
     tiles stratified and with --n-perfect 3 --n-mismatch 2 (one pair's
     metrics on the card against the CPU); no kernel launched, every device
     tool allocates on the card; timings: each tool's wall time, the device
     ms per 6144^2 chunk of each stack and of CLAHE, the idle share over
     one preprocess-ecm run
  9c. probe  the layout probe (``scripts/exp_layout_probe.py`` ported) at
     (16, 64, 1024, 1024) bf16 through its ``main``: I once per kernel-chain
     call; with cuDNN deterministic, the chain through I bit-equal to the
     chain without it; each chain's device activities by name, and the
     kernels the chain through I adds besides I (the probe's answer)
 10. timing  CUDA events, after warmup, on distinct batches, in turns with
     the plain versions; device time per call from torch.profiler; train
     step and augmentation at batch 2 and 8, and the device's idle share
     over one epoch; kernels I and B' beside clone, their bounds and their
     previous designs' times
Then one JSON line with every kernel's launches, error, times and bound, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np
import torch

import adipose_tpu_torch.cli.main as cli
import adipose_tpu_torch.eval.evaluator as evaluator_module
import adipose_tpu_torch.models.unet as unet_module
import adipose_tpu_torch.ops.d4 as d4_module
import adipose_tpu_torch.ops.normalize as normalize_module
from adipose_tpu_torch.cli.main import _load_classifier, _load_segmenter, segment_batch
from adipose_tpu_torch.core.hostio import thread_map
from adipose_tpu_torch.models.convert import torch_inception_to_flax, torch_unet_to_flax
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet, diff_head_taps
from adipose_tpu_torch.ops.cuda import build
from adipose_tpu_torch.ops.cuda.percentile import (percentile_normalize_u8,
                                                   percentile_normalize_u8_plain)
from adipose_tpu_torch.ops.cuda.preprocess import (fused_zscore_normalize,
                                                   fused_zscore_normalize_plain)
from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch, d4_transform_batch_plain
from adipose_tpu_torch.ops.cuda.layout import ident_hwbc, ident_hwbc_plain, ident_plan
from adipose_tpu_torch.ops.cuda.unet_kernels import (diff_sigmoid_head,
                                                     diff_sigmoid_head_backward,
                                                     diff_sigmoid_head_backward_plain,
                                                     diff_sigmoid_head_forward,
                                                     diff_sigmoid_head_plain, head_bwd_plan)
from adipose_tpu_torch.ops.d4 import INVERSE_IDS, MODE_IDS
from adipose_tpu_torch.core.config import TrainConfig, UNetConfig
from adipose_tpu_torch.core.seeding import generator_for
from adipose_tpu_torch.data.augment import draw_tier
from adipose_tpu_torch.data.loader import ClassificationDataset
from adipose_tpu_torch.models.convert import flax_inception_to_torch
from adipose_tpu_torch.models.inception import backbone_param_mask, frozen_conv_boundary
from adipose_tpu_torch.ops.metrics import roc_auc
from adipose_tpu_torch.models.convert import load_flax_npz
from adipose_tpu_torch.ops.normalize import TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT
from adipose_tpu_torch.scripts import exp_layout_probe as probe
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import (TrainState, classifier_stats_mask,
                                           unet_loss_from_config)
from adipose_tpu_torch.train.trainer_classifier import (INCEPTION_SIZE, ClassifierTrainer,
                                                         _make_preprocess_step,
                                                         _make_train_step as _make_cls_step)
from adipose_tpu_torch.train.trainer_unet import (UNetTrainer, _make_fused_train_step,
                                                   _to_device, init_unet_params,
                                                   make_augment_step)
from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

SEED = 865
BATCH, SIZE, INIT_NB = 16, 1024, 44
REQUESTS = 3
# Kernel A: the normalized output must be bit-equal (both round (x - mean) /
# denom once, IEEE); float-input stats differ only in the double summation order.
ZSCORE_STATS_RTOL = 1e-5
# Kernel B: both versions take exact f32 products of bf16 values and sum them
# in f32, in different orders; the sum's rounding differs by ~1e-7 after the
# sigmoid at these widths, well inside this bound.
HEAD_ATOL = 1e-6
# Slice: kernel path vs the same model with the plain z-score and head. The
# two share every bf16 cuDNN conv on bit-equal inputs, so the gap is the
# head's summation order unless cuDNN picks another algorithm between runs;
# this bounds a bf16 rounding of the full-resolution activations.
SLICE_ATOL = 1e-3
# Cascade: kernel path vs the same cascade with the three plain versions.
# The percentile kernel is bit-equal, so both classifier runs see the same
# input; the maps differ as the slice does.
CASCADE_ATOL = 1e-3
CHUNKS = ((6144, 6144), (6144, 4096), (3000, 5000))  # (H, W) of the chunk PNGs
TRAIN_BATCH = 2  # the train-unet default
# Kernel B': dx rounds the same f32 product once, so it is bit-equal; dw and
# dbias are f32 sums over ~2M pixels in another order than the plain einsum.
HEAD_BWD_DW_RTOL = 1e-4  # of max |dw|
HEAD_BWD_DBIAS_RTOL = 1e-5
# The Function vs plain autograd at f32: torch's sigmoid backward rounds
# g * (1 - p) * p in another order, and its matmul sums in another order.
HEAD_AUTOGRAD_RTOL = 1e-5
# The previous designs' device times of kernels I and B' at the timing
# shapes, for reference (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W).
PREVIOUS_DESIGN_MS = {"ident_hwbc": 1.5561, "diff_sigmoid_head_backward": 0.3249}
# H100 SXM peaks (NVIDIA's data sheet) for the bound of each kernel's work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

ROOT = Path(__file__).resolve().parent
KERNELS = {  # name: (wrapper, plain version, source, TPU kernel it replaces)
    "fused_zscore_normalize": (fused_zscore_normalize, fused_zscore_normalize_plain,
                               "adipose_tpu_torch/csrc/preprocess.cu",
                               "adipose_tpu/ops/pallas/preprocess.py:72"),
    "diff_sigmoid_head": (diff_sigmoid_head, diff_sigmoid_head_plain,
                          "adipose_tpu_torch/csrc/unet_kernels.cu",
                          "adipose_tpu/ops/pallas/unet_kernels.py:54"),
    "percentile_normalize_u8": (percentile_normalize_u8, percentile_normalize_u8_plain,
                                "adipose_tpu_torch/csrc/percentile.cu",
                                "adipose_tpu/ops/pallas/preprocess.py:179"),
    "diff_sigmoid_head_backward": (diff_sigmoid_head_backward,
                                   diff_sigmoid_head_backward_plain,
                                   "adipose_tpu_torch/csrc/unet_kernels.cu",
                                   "adipose_tpu/ops/pallas/unet_kernels.py:94"),
    "d4_transform_batch": (d4_transform_batch, d4_transform_batch_plain,
                           "adipose_tpu_torch/csrc/d4.cu",
                           "adipose_tpu/ops/pallas/layout.py:29"),
    "ident_hwbc": (ident_hwbc, ident_hwbc_plain, "adipose_tpu_torch/csrc/layout.cu",
                   "scripts/exp_layout_probe.py:37"),
}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def cuda_ms(fn, inputs: list, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls cycling ``inputs``,
    after one warm-up call per input, by CUDA events."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, inputs: list, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, inputs, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_activities(fn, inputs: list, iters: int) -> dict[str, tuple[float, int, int]]:
    """Each device activity of ``fn`` over ``iters`` calls cycling ``inputs``,
    after one warm-up call per input, under torch.profiler: name -> (device
    ms per call, launches per call, launches recorded).

    Late in this script the profiler leaves a launch of a session
    unrecorded now and then; so a call's time is the mean time of the
    recorded launches times the launches per call, which is the recorded
    count over the calls, rounded."""
    from torch.profiler import ProfilerActivity, profile

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    total: dict[str, tuple[float, int]] = {}
    for e in prof.key_averages():
        if device_us(e) > 0:
            ms, n = total.get(e.key, (0.0, 0))
            total[e.key] = (ms + device_us(e) / 1000.0, n + e.count)
    acts = {}
    for key, (ms, n) in total.items():
        per_call = max(1, round(n / iters))
        acts[key] = (ms / n * per_call, per_call, n)
    return acts


def profiled_ms(fn, inputs: list, iters: int, names: tuple[str, ...]) -> float | None:
    """Device time per call of ``fn`` from torch.profiler: the summed time of
    the device activities whose names contain one of ``names`` (each one's
    share is printed); None when the profiler records no device time."""
    acts = device_activities(fn, inputs, iters)
    per_name = {n: sum(ms for k, (ms, _, _) in acts.items() if n in k) for n in names}
    lost = sum(per_call * iters - n for _, per_call, n in acts.values())
    ms = sum(per_name.values())
    print("  device ms per call: " + ", ".join(f"{n} {v:.4f}" for n, v in per_name.items())
          + (f" ({lost} of the launches unrecorded)" if lost else ""))
    return ms if ms > 0 else None


def device_us(event) -> float:
    return getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): bytes moved over the
    memory rate against float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def launches() -> dict[str, int]:
    return {name: wrapper.launches for name, (wrapper, *_) in KERNELS.items()}


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper on the port's paths for its plain version
    (the plain head is differentiable by autograd, so it stands for B' too)."""
    swaps = [(cli, "fused_zscore_normalize", fused_zscore_normalize_plain),
             (evaluator_module, "fused_zscore_normalize", fused_zscore_normalize_plain),
             (unet_module, "diff_sigmoid_head", diff_sigmoid_head_plain),
             (normalize_module, "percentile_normalize_u8", percentile_normalize_u8_plain),
             (d4_module, "d4_transform_batch", d4_transform_batch_plain)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"build: {lib.relative_to(ROOT)} from {len(list(build.CSRC_DIR.glob('*.cu')))} "
          f"sources in {time.perf_counter() - t0:.2f} s")


def phase_zscore(dev, g) -> float:
    """Kernel A vs plain; returns the max abs difference over all outputs."""
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev, generator=g)
    frac = torch.rand((BATCH, SIZE, SIZE), device=dev, generator=g) * 255.0
    worst, stats_rel = 0.0, 0.0
    for tiles in (u8, frac):
        for out_dtype in (torch.bfloat16, torch.float32):
            nk, sk = fused_zscore_normalize(tiles, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT,
                                            out_dtype=out_dtype)
            npl, spl = fused_zscore_normalize_plain(tiles, TRAIN_MEAN_DEFAULT,
                                                    TRAIN_STD_DEFAULT, out_dtype=out_dtype)
            torch.cuda.synchronize()
            case = f"{tiles.dtype} -> {out_dtype}"
            if nk.shape != (BATCH, 1, SIZE, SIZE) or not torch.equal(bits(nk), bits(npl)):
                raise AssertionError(f"fused_zscore_normalize {case}: normalized not bit-equal")
            if tiles.dtype == torch.uint8 and not torch.equal(sk, spl):
                raise AssertionError(f"fused_zscore_normalize {case}: u8 stats not exact "
                                     f"{sk[:2].tolist()} vs {spl[:2].tolist()}")
            rel = ((sk - spl).abs() / spl.abs().clamp_min(1e-30)).max().item()
            if rel > ZSCORE_STATS_RTOL:
                raise AssertionError(f"fused_zscore_normalize {case}: stats rel err {rel}")
            stats_rel = max(stats_rel, rel)
            worst = max(worst, (nk.float() - npl.float()).abs().max().item(),
                        (sk - spl).abs().max().item())
    print(f"kernel fused_zscore_normalize ({BATCH},{SIZE},{SIZE}) u8|f32 -> bf16|f32: "
          f"normalized bit-equal, u8 stats exact, stats max rel err {stats_rel:.3g} "
          f"(bound {ZSCORE_STATS_RTOL}), max abs err {worst:.3g}")
    return worst


def phase_head(dev, g) -> float:
    """Kernel B vs plain at the main and aux heads' shapes; max abs error."""
    worst = 0.0
    for c, s in ((INIT_NB, SIZE), (4 * INIT_NB, SIZE // 4), (2 * INIT_NB, SIZE // 2)):
        x = torch.randn((BATCH, s, s, c), device=dev, generator=g).relu_()
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels-last (B, C, H, W)
        w = (torch.randn(c, device=dev, generator=g) / c ** 0.5).to(torch.bfloat16)
        bias = torch.tensor(0.1, device=dev)
        pk = diff_sigmoid_head(x, w, bias)
        pp = diff_sigmoid_head_plain(x, w, bias)
        torch.cuda.synchronize()
        err = (pk - pp).abs().max().item()
        if pk.shape != (BATCH, s, s) or not err <= HEAD_ATOL:
            raise AssertionError(f"diff_sigmoid_head C={c}: max abs err {err} > {HEAD_ATOL}")
        worst = max(worst, err)
        print(f"kernel diff_sigmoid_head ({BATCH},{c},{s},{s}) bf16 channels-last: "
              f"max abs err {err:.3g} (bound {HEAD_ATOL})")
        del x, pk, pp
    torch.cuda.empty_cache()
    return worst


def phase_d4(dev, g) -> float:
    """Kernel D vs plain: bit-equal, every id, N = 1024 and 1000; the
    inverse ids undo it."""
    inverse = torch.tensor(INVERSE_IDS, dtype=torch.int32, device=dev)
    cases = [(TRAIN_BATCH, SIZE, torch.tensor(ids, dtype=torch.int32, device=dev))
             for ids in ((0, 1), (2, 3), (4, 5), (6, 7), (7, 2))]
    cases.append((BATCH, SIZE, torch.randperm(BATCH, device=dev, generator=g).to(torch.int32) % 8))
    cases.append((8, 1000, torch.randperm(8, device=dev, generator=g).to(torch.int32)))
    for b, n, ids in cases:
        x = torch.rand((b, n, n), device=dev, generator=g)
        k = d4_transform_batch(x, ids)
        plain = d4_transform_batch_plain(x, ids)
        back = d4_transform_batch(k, inverse[ids.long()])
        torch.cuda.synchronize()
        if not torch.equal(bits(k), bits(plain)):
            raise AssertionError(f"d4_transform_batch ({b},{n},{n}) ids {ids.tolist()}: "
                                 f"not bit-equal to plain")
        if not torch.equal(bits(back), bits(x)):
            raise AssertionError(f"d4_transform_batch ({b},{n},{n}): inverse is not identity")
    print(f"kernel d4_transform_batch ({TRAIN_BATCH},{SIZE},{SIZE}) x5 id pairs covering all 8, "
          f"({BATCH},{SIZE},{SIZE}) and (8,1000,1000) f32: bit-equal to plain, inverse ids "
          f"restore the input")
    return 0.0


def phase_head_backward(dev, g) -> float:
    """Kernel B' vs plain at the training path's head shapes (batch 2), at
    batch 8, and on the shapes that take the general path or end inside a
    channel period: dx bit-equal, dw and dbias to their bounds, two runs
    bit-equal; then the autograd Function against plain autograd at f32."""
    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    # (batch, C, H, W, dtype, elements of storage before x)
    shapes = [(TRAIN_BATCH, INIT_NB, SIZE, SIZE, bf16, 0),
              (TRAIN_BATCH, 4 * INIT_NB, SIZE // 4, SIZE // 4, bf16, 0),
              (TRAIN_BATCH, 2 * INIT_NB, SIZE // 2, SIZE // 2, bf16, 0),
              (TRAIN_BATCH, INIT_NB, SIZE, SIZE, f32, 0),
              (8, INIT_NB, SIZE, SIZE, bf16, 0),  # the batch-8 training step's main head
              (TRAIN_BATCH, 37, SIZE // 2, SIZE // 2, bf16, 0),  # period 37: general path
              (TRAIN_BATCH, INIT_NB, SIZE // 2, SIZE // 2, bf16, 1),  # x unaligned: general
              (1, INIT_NB, 999, 1001, bf16, 0)]  # odd pixel count: ends inside a period
    for b, c, h, wd, dtype, offset in shapes:
        x = torch.randn((offset + b * h * wd * c,), device=dev, generator=g).relu_().to(dtype)
        x = x[offset:].view(b, h, wd, c).permute(0, 3, 1, 2)  # channels-last (B, C, H, W)
        w = (torch.randn(c, device=dev, generator=g) / c ** 0.5).to(dtype)
        p = diff_sigmoid_head_forward(x, w, torch.tensor(0.1, device=dev))
        gr = torch.randn((b, h, wd), device=dev, generator=g)
        dxk, dwk, dbk = diff_sigmoid_head_backward(x, w, p, gr)
        dxk2, dwk2, dbk2 = diff_sigmoid_head_backward(x, w, p, gr)
        dxp, dwp, dbp = diff_sigmoid_head_backward_plain(x, w, p, gr)
        torch.cuda.synchronize()
        plan = head_bwd_plan(c, x.element_size(), x.data_ptr(), dxk.data_ptr())
        case = (f"({b},{c},{h},{wd}) {dtype}{f' {offset} element in' if offset else ''}, "
                f"{plan.path} path" + (f" (period {plan.period}, block {plan.block[0]})"
                                       if plan.path == "period" else ""))
        if dxk.shape != x.shape or not dxk.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"diff_sigmoid_head_backward {case}: dx shape/layout")
        if not torch.equal(bits(dxk), bits(dxp)):
            raise AssertionError(f"diff_sigmoid_head_backward {case}: dx not bit-equal")
        if not (torch.equal(bits(dwk), bits(dwk2)) and torch.equal(dbk, dbk2)):
            raise AssertionError(f"diff_sigmoid_head_backward {case}: two runs differ")
        dw_err = (dwk.float() - dwp.float()).abs()
        # bf16 dw: the f32 sums differ in order, so a sum that lies within
        # ~1e-6 of a bf16 rounding boundary may round one bf16 step apart.
        step = dwp.float().abs() * 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        dw_bound = HEAD_BWD_DW_RTOL * dwp.float().abs().max().item()
        if not bool((dw_err <= dw_bound + step).all()):
            raise AssertionError(f"diff_sigmoid_head_backward {case}: dw max err "
                                 f"{dw_err.max().item()} > {dw_bound} (+ one bf16 step)")
        db_rel = ((dbk - dbp).abs() / dbp.abs()).item()
        if not db_rel <= HEAD_BWD_DBIAS_RTOL:
            raise AssertionError(f"diff_sigmoid_head_backward {case}: dbias rel err {db_rel}")
        worst = max(worst, dw_err.max().item(), (dbk - dbp).abs().item())
        print(f"kernel diff_sigmoid_head_backward {case} channels-last: dx bit-equal, "
              f"two runs bit-equal, dw max abs err {dw_err.max().item():.3g} (bound "
              f"{dw_bound:.3g}{' + one bf16 step' if dtype == torch.bfloat16 else ''}), "
              f"dbias rel err {db_rel:.3g} (bound {HEAD_BWD_DBIAS_RTOL})")
        del x, p, gr, dxk, dxk2, dxp
        torch.cuda.empty_cache()

    # The autograd Function (kernels B and B') against plain autograd at f32.
    x = torch.randn((2, 16, 24, 8), device=dev, generator=g).permute(0, 3, 1, 2)
    w = torch.randn(8, device=dev, generator=g)
    bias = torch.tensor(0.2, device=dev)
    weights = torch.randn((2, 16, 24), device=dev, generator=g)
    grads = []
    for fn in (diff_sigmoid_head, diff_sigmoid_head_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        (fn(*leaves) * weights).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(("dx", "dw", "dbias"), *grads):
        err = (a - b).abs().max().item()
        if not err <= HEAD_AUTOGRAD_RTOL * b.abs().max().item():
            raise AssertionError(f"diff_sigmoid_head autograd {name}: max err {err}")
    print(f"diff_sigmoid_head autograd Function (kernels B, B') vs plain autograd at f32 "
          f"(2,8,16,24): dx, dw, dbias within {HEAD_AUTOGRAD_RTOL} of their max")
    return worst


def phase_ident(dev, g) -> float:
    """Kernel I vs plain: bit-equal, strides kept, on the probe's view, a
    contiguous (H, W, B, C) tensor, odd shapes with a scalar tail, and a
    view that starts inside a 16-byte line."""
    def normal(*shape):
        return torch.randn(shape, device=dev, generator=g, dtype=torch.bfloat16)

    def starting_at(offset, shape, order):
        """A (H, W, B, C) view, its dimensions stored in ``order``, whose
        storage holds ``offset`` elements before it."""
        stored = [shape[d] for d in order]
        flat = normal(offset + math.prod(shape))[offset:]
        return flat.view(stored).permute(*[order.index(d) for d in range(4)])

    b, s, c = probe.BATCH, probe.SIZE, probe.CHANNELS
    cases = [(f"({s},{s},{b},{c}) view of a channels-last ({b},{c},{s},{s})",
              lambda: normal(b, s, s, c).permute(1, 2, 0, 3)),
             (f"({s},{s},{b},{c}) contiguous", lambda: normal(s, s, b, c)),
             ("(64,1000,3,44) contiguous", lambda: normal(64, 1000, 3, 44)),
             ("(7,9,3,5) contiguous", lambda: normal(7, 9, 3, 5)),
             ("(64,64,16,64) view of a channels-last (16,64,64,64) 1 element in",
              lambda: starting_at(1, (64, 64, 16, 64), (2, 0, 1, 3)))]
    plans = []
    for case, make in cases:
        t = make()
        k = ident_hwbc(t)
        plain = ident_hwbc_plain(t)
        torch.cuda.synchronize()
        if k.stride() != t.stride():
            raise AssertionError(f"ident_hwbc {case}: strides {k.stride()}, input {t.stride()}")
        if not (torch.equal(bits(k), bits(plain)) and torch.equal(bits(k), bits(t))):
            raise AssertionError(f"ident_hwbc {case}: not bit-equal to plain and the input")
        plan = ident_plan(t.shape, t.stride(), t.data_ptr(), k.data_ptr())
        plans.append(f"{case} (run {plan.run_len}, vector {plan.vec}, tail {plan.tail})")
        del t, k, plain
    torch.cuda.empty_cache()
    print(f"kernel ident_hwbc bf16: bit-equal to plain and to the input, strides kept, on "
          + "; ".join(plans))
    return 0.0


def phase_layout_probe(dev, smi: str) -> dict[str, int]:
    """The layout probe at full shape through its ``main``; then chain_kernel
    bit-equal to chain_plain with cuDNN deterministic, each chain's device
    activities, and the kernels chain_kernel runs besides I and chain_plain's."""
    reset_launches()
    times = probe.main(["--device", str(dev)])
    counts = launches()
    calls = 1 + probe.ITERS  # a warm-up and the timed calls
    want = {name: 0 for name in KERNELS} | {"ident_hwbc": calls}
    if counts != want:
        raise AssertionError(f"layout probe launches {counts}, want {want}: I once per call")

    args = probe.probe_inputs(probe.BATCH, probe.SIZE, probe.CHANNELS, dev,
                              torch.Generator(device=dev).manual_seed(SEED))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        plain, kernel = probe.chain_plain(*args), probe.chain_kernel(*args)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    if not torch.equal(bits(plain), bits(kernel)):
        raise AssertionError(f"chain_kernel {kernel.item()} vs chain_plain {plain.item()}: "
                             f"not bit-equal")

    iters = 3
    acts = {name: device_activities(lambda a: fn(*a), [args], iters)
            for name, fn in (("chain_plain", probe.chain_plain),
                             ("chain_kernel", probe.chain_kernel))}
    ident = {k: v for k, v in acts["chain_kernel"].items() if "ident_hwbc_kernel" in k}
    if [per_call for _, per_call, _ in ident.values()] != [1]:
        raise AssertionError(f"kernel I under the profiler {ident}, want one launch a call")
    ident_ms = sum(ms for ms, _, _ in ident.values())
    # launched more often a call through I than without it, I aside
    extra = sorted(k for k, (_, per_call, _) in acts["chain_kernel"].items()
                   if k not in ident and per_call > acts["chain_plain"].get(k, (0.0, 0, 0))[1])
    shape = f"({probe.BATCH},{probe.CHANNELS},{probe.SIZE},{probe.SIZE})"
    print(f"layout probe: {shape} bf16 channels-last through exp_layout_probe.main; launches "
          f"{counts} over {calls} chain_kernel calls; chain_kernel bit-equal to chain_plain "
          f"(max {plain.item()}) with cuDNN deterministic; plain {times['plain']:.4f} ms, "
          f"kernel-ident {times['kernel-ident']:.4f} ms by CUDA events, gap "
          f"{times['kernel-ident'] - times['plain']:.4f} ms; kernel I {ident_ms:.4f} ms device "
          f"time per call by torch.profiler [{smi}]")
    for name, act in acts.items():
        print(f"  {name} device ms per call (launches a call, recorded over {iters} calls): "
              + "; ".join(f"{k[:90]} {ms:.4f} ({per_call}, {n})"
                          for k, (ms, per_call, n) in sorted(act.items(), key=lambda kv: -kv[1][0])))
    print(f"  kernels chain_kernel launches beyond chain_plain's, I aside: {json.dumps(extra)}")
    return counts


def phase_percentile(dev, g) -> float:
    """Kernel P vs plain at the classifier gate's shape; max abs error."""
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev, generator=g)
    frac = torch.rand((BATCH, SIZE, SIZE), device=dev, generator=g) * 255.0
    background = u8.clone()
    background[torch.rand((BATCH, SIZE, SIZE), device=dev, generator=g) < 0.7] = 240
    worst = 0.0
    for case, tiles, p in (("u8", u8, (1.0, 99.0)), ("u8", u8, (2.0, 98.0)),
                           ("f32 rounded first", frac, (1.0, 99.0)),
                           ("70% one value", background, (1.0, 99.0))):
        k = percentile_normalize_u8(tiles, *p)
        plain = percentile_normalize_u8_plain(tiles, *p)
        torch.cuda.synchronize()
        if k.shape != (BATCH, SIZE, SIZE) or not torch.equal(bits(k), bits(plain)):
            raise AssertionError(f"percentile_normalize_u8 {case} p={p}: not bit-equal, max "
                                 f"abs err {(k - plain).abs().max().item()}")
        if not (k.min().item() >= 0.0 and k.max().item() <= 1.0):
            raise AssertionError(f"percentile_normalize_u8 {case}: outside [0, 1]")
        worst = max(worst, (k - plain).abs().max().item())
    print(f"kernel percentile_normalize_u8 ({BATCH},{SIZE},{SIZE}) u8 p=(1,99),(2,98) | f32 "
          f"rounded first | 70% one value -> f32: bit-equal to plain, max abs err {worst:.3g}")
    return worst


def phase_slice(dev, run: Path, smi: str) -> dict:
    """The segment path at full width; returns launches, error and rates."""
    ckpt.save_normalization_stats(run, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT)
    (run / "training_settings.log").write_text(f"init_nb: {INIT_NB}\n")
    seeded = DilatedUNet(init_nb=INIT_NB).init_params(torch.Generator().manual_seed(SEED))
    ckpt.save_params(run, "weights_best_overall", torch_unet_to_flax(seeded.state_dict()))
    predict, params, mean, std = _load_segmenter(run, device=dev)

    rng = np.random.default_rng(SEED)
    warm = rng.integers(0, 256, (BATCH, SIZE, SIZE), dtype=np.uint8)
    requests = [rng.integers(0, 256, (BATCH, SIZE, SIZE), dtype=np.uint8)
                for _ in range(REQUESTS)]
    segment_batch(predict, params, warm, BATCH, dev)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    preds = [segment_batch(predict, params, r, BATCH, dev) for r in requests]
    host_s = time.perf_counter() - t0
    counts = launches()
    want = {"fused_zscore_normalize": REQUESTS, "diff_sigmoid_head": REQUESTS,
            "percentile_normalize_u8": 0, "diff_sigmoid_head_backward": 0,
            "d4_transform_batch": 0, "ident_hwbc": 0}
    if counts != want:
        raise AssertionError(f"segment path launches {counts}, want {want}")
    for p in preds:
        if p.shape != (BATCH, SIZE, SIZE) or not np.isfinite(p).all():
            raise AssertionError(f"bad prediction: shape {p.shape}, finite {np.isfinite(p).all()}")
        if p.min() < 0.0 or p.max() > 1.0:
            raise AssertionError(f"probabilities outside [0, 1]: {p.min()} .. {p.max()}")

    model = DilatedUNet(init_nb=INIT_NB, device=dev)
    model.load_state_dict(params)
    model.eval()
    with torch.inference_mode():
        tiles = torch.from_numpy(requests[0]).to(dev)
        x, _ = fused_zscore_normalize_plain(tiles, mean, std, out_dtype=torch.bfloat16)
        up1, _, _ = model.trunk(x)
        ref = diff_sigmoid_head_plain(up1, *diff_head_taps(model.output_softmax, up1.dtype))
    err = float(np.abs(preds[0] - ref.cpu().numpy()).max())
    if not err <= SLICE_ATOL:
        raise AssertionError(f"slice vs plain z-score + head: max abs err {err} > {SLICE_ATOL}")
    del up1, ref, x
    mask_share = float(np.mean([(p > 0.5).mean() for p in preds]))
    print(f"slice: {REQUESTS} requests x {BATCH} tiles {SIZE}^2 init_nb={INIT_NB} bf16 "
          f"channels-last through _load_segmenter/segment_batch; launches {counts}; "
          f"probabilities in [0,1], mask share {mask_share:.3f}; vs plain z-score + head "
          f"max abs err {err:.3g} (bound {SLICE_ATOL}); segment_batch incl. copies "
          f"{REQUESTS * BATCH / host_s:.2f} tiles/s [{smi}]")

    batches = [torch.randint(0, 256, (BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(SEED + i))
               for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda t: predict(params, t), batches, 6)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"timing slice: predict {ms:.3f} ms per batch of {BATCH} = "
          f"{BATCH * 1000.0 / ms:.2f} tiles/s on device-resident u8 batches, "
          f"peak memory {peak_gb:.2f} GB [{smi}]")
    return {"launches": counts, "err": err}


def chunk_image(shape: tuple[int, int], rng: np.random.Generator) -> np.ndarray:
    """Smooth seeded noise with fine texture, and a near-white region that
    the QC gate rejects, as uint8."""
    h, w = shape
    coarse = rng.random((h // 512 + 2, w // 512 + 2)).astype(np.float32)
    img = 60.0 + 140.0 * cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0.0, 12.0, (h, w)).astype(np.float32)
    img[: h // 3, : w // 2] = 245.0 + rng.integers(0, 10, (h // 3, w // 2))
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_cascade(dev, tmp: Path, seg_run: Path, smi: str) -> dict:
    """``adipose-torch pipeline`` at full width through cli.main.main."""
    cls_run, chunks = tmp / "classifier", tmp / "chunks"
    chunks.mkdir()
    seeded = InceptionV3Classifier().init_params(torch.Generator().manual_seed(SEED))
    ckpt.save_params(cls_run, "weights_best", torch_inception_to_flax(seeded.state_dict()))
    rng = np.random.default_rng(SEED)
    paths = []
    for i, shape in enumerate(CHUNKS):
        paths.append(chunks / f"chunk{i}.png")
        cv2.imwrite(str(paths[-1]), chunk_image(shape, rng))

    def run_cli(out: Path, threshold: float) -> dict:
        cli.main(["pipeline", "--wsi-dir", str(chunks), "--classifier-weights", str(cls_run),
                  "--segmenter-weights", str(seg_run), "--output-dir", str(out),
                  "--tile-size", str(SIZE), "--batch-size", str(BATCH),
                  "--classifier-threshold", str(threshold)])
        return json.loads((out / "pipeline_log.json").read_text())

    gated = run_cli(tmp / "out_gated", 0.5)  # also warms cuDNN and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    log = run_cli(tmp / "out", 0.0)
    counts = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_chunk = log["chunks"]
    classify_batches = sum(math.ceil(c["n_tiles"] / BATCH) for c in per_chunk)
    segment_batches = sum(math.ceil(c["n_positive"] / BATCH) for c in per_chunk)
    want = {"fused_zscore_normalize": segment_batches, "diff_sigmoid_head": segment_batches,
            "percentile_normalize_u8": classify_batches, "diff_sigmoid_head_backward": 0,
            "d4_transform_batch": 0, "ident_hwbc": 0}
    if counts != want or min(segment_batches, classify_batches) < 1:
        raise AssertionError(f"cascade launches {counts}, want {want} (one per batch)")
    n_tiles, n_good = log["n_tiles"], sum(c["n_good"] for c in per_chunk)
    if log["n_chunks"] != len(CHUNKS) or not 0 < n_good < n_tiles or log["n_positive"] != n_good:
        raise AssertionError(f"cascade counts: {json.dumps(per_chunk)}")
    for p in paths:
        for suffix in ("probability.png", "mask.png", "pipeline_log.json"):
            if not (tmp / "out" / f"{p.stem}_{suffix}").exists():
                raise AssertionError(f"cascade wrote no {p.stem}_{suffix}")
        prob = cv2.imread(str(tmp / "out" / f"{p.stem}_probability.png"), cv2.IMREAD_UNCHANGED)
        if prob.shape != cv2.imread(str(p), cv2.IMREAD_UNCHANGED).shape or prob.max() == 0:
            raise AssertionError(f"{p.stem}: probability map {prob.shape}, max {prob.max()}")

    # The same cascade in-process, with the kernels and with the plain versions.
    seg_predict, seg_params, _, _ = _load_segmenter(seg_run, device=dev)
    cls_predict, cls_state = _load_classifier(cls_run, device=dev)
    pipe = DualModelWSIPipeline(cls_predict, cls_state, seg_predict, seg_params,
                                tile_size=SIZE, batch_size=BATCH, classifier_threshold=0.0,
                                transfer_dtype="float32", device=dev)
    images = [pipe._read_image(p) for p in paths]
    got = pipe.run_many(images)
    reset_launches()
    with plain_kernels():
        ref = pipe.run_many(images)
    if any(launches().values()):
        raise AssertionError(f"plain cascade launched kernels: {launches()}")
    err = 0.0
    for g_, r, c in zip(got, ref, per_chunk):
        count = (g_.n_tiles, g_.n_good, g_.n_positive)
        if count != (r.n_tiles, r.n_good, r.n_positive) or \
                count != (c["n_tiles"], c["n_good"], c["n_positive"]):
            raise AssertionError(f"{c['chunk']}: counts {count}, plain "
                                 f"{(r.n_tiles, r.n_good, r.n_positive)}, CLI {c}")
        if not np.isfinite(g_.probability_map).all():
            raise AssertionError(f"{c['chunk']}: non-finite probabilities")
        err = max(err, float(np.abs(g_.probability_map - r.probability_map).max()))
    if not err <= CASCADE_ATOL:
        raise AssertionError(f"cascade vs plain versions: max abs err {err} > {CASCADE_ATOL}")
    del got, ref

    # Where the device time goes: one batch of each stage by CUDA events,
    # and the device's busy share of an in-process run under the profiler.
    from torch.profiler import ProfilerActivity, profile

    from adipose_tpu_torch.ops.blend import accumulate_predictions, extract_tiles
    from adipose_tpu_torch.ops.qc import classify_tiles_batch
    slide = torch.from_numpy(images[0]).to(dev)
    h, w = images[0].shape
    tiles = [extract_tiles(slide, np.asarray([[y, w - SIZE]] * BATCH), SIZE)
             for y in (0, (h - SIZE) // 2, h - SIZE)]  # textured, right of the white part
    canvas = torch.zeros(slide.shape, dtype=torch.float32, device=dev)
    corners = np.asarray([[0, 0]] * BATCH)
    every = np.ones(BATCH, bool)
    stage_ms = {
        "gather": cuda_ms(lambda t: extract_tiles(slide, corners, SIZE), tiles, 6),
        "qc": cuda_ms(lambda t: classify_tiles_batch(t), tiles, 6),
        "classify": cuda_ms(lambda t: cls_predict(cls_state, t), tiles, 6),
        "segment": cuda_ms(lambda t: seg_predict(seg_params, t), tiles, 3),
        "accumulate": cuda_ms(lambda t: accumulate_predictions(
            canvas, t, corners, pipe.weight_map, every), tiles, 6),
    }
    print("timing cascade stages, ms per batch of 16 by CUDA events: "
          + json.dumps({k: round(v, 3) for k, v in stage_ms.items()}) + f" [{smi}]")
    del tiles, canvas, slide
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_many(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_many(images)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = sorted(((device_us(e) / 1e6, e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(t for t, _ in kernels)
    print(f"timing cascade in-process run_many of the 3 decoded chunks: {wall:.3f} s wall; "
          f"under the profiler {prof_wall:.3f} s wall, device busy {busy:.3f} s "
          f"({100 * (1 - busy / prof_wall):.1f}% idle) [{smi}]")
    print("  top device activities (s): " + "; ".join(
        f"{name[:60]} {t:.4f}" for t, name in kernels[:8]))
    del images

    stages = {k: sum(c["timings"][k] for c in per_chunk)
              for k in ("tiling_s", "qc_classify_s", "qc_wait_s", "segment_s", "blend_s")}
    total = log["total_s"]
    print(f"cascade: adipose-torch pipeline, {len(CHUNKS)} chunks {CHUNKS}, {SIZE}^2 tiles, "
          f"batch {BATCH}, InceptionV3 + init_nb={INIT_NB} U-Net bf16; {n_tiles} tiles, "
          f"{n_good} QC-good, n_positive {log['n_positive']} at classifier threshold 0, "
          f"{gated['n_positive']} at 0.5; launches {counts} ({classify_batches} classify, "
          f"{segment_batches} segment batches); vs plain versions max abs err {err:.3g} "
          f"(bound {CASCADE_ATOL})")
    print(f"timing cascade: {total:.3f} s for the chunk folder incl. PNG reads and writes = "
          f"{len(CHUNKS) / total:.3f} chunks/s, {n_tiles / total:.2f} tiles/s, "
          f"{log['n_positive'] / total:.2f} segmented tiles/s; summed stages "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})} (pipelined: "
          f"enqueue times); peak memory {peak_gb:.2f} GB [{smi}]")
    return {"launches": counts, "err": err}


# ---- evaluation ---------------------------------------------------------------

EVAL_TILES = 8  # 1024^2 tiles over 2 slides
EVAL_LARGE = ((4096, 3072), (900, 700))  # (H, W): a slide region; one smaller than a tile
EVAL_BOOTSTRAP = 1000
EVAL_CLI_BATCH = 16  # adipose-torch evaluate's default --batch-size
SEGMENT_CLI_BATCH = 8  # adipose-torch segment's default --batch-size
# Kernels vs plain versions in the same evaluator: A and D are bit-equal and
# B is within HEAD_ATOL, on the same cuDNN convs (deterministic algorithms);
# so each map within 1e-5, the threshold the same, every mean within 1e-4.
EVAL_MAP_ATOL = 1e-5
EVAL_MEAN_ATOL = 1e-4
# Full TTA of an equivariant predict (the tile scaled to [0, 1]): the views
# and their inverses are permutations, so only the float32 sum of 8 equal
# values and its division round.
TTA_EQUIV_ATOL = 1e-6
EVAL_ARTIFACTS = ("metrics.json", "predictions.csv", "test_comprehensive_results.csv")


def eval_pair(shape: tuple[int, int], rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A uint8 image whose bright smooth blobs are the mask, with texture."""
    h, w = shape
    coarse = rng.random((h // 128 + 2, w // 128 + 2)).astype(np.float32)
    blobs = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC) > 0.6
    img = 70.0 + 90.0 * blobs + rng.normal(0.0, 15.0, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), blobs.astype(np.uint8) * 255


def write_eval_sets(root: Path) -> tuple[Path, Path]:
    """Two test sets in the reference layout, each in a folder named test:
    ``tiles/test`` (EVAL_TILES tiles over two slides) and ``large/test``
    (the EVAL_LARGE images)."""
    rng = np.random.default_rng(SEED)
    sets = {"tiles": [(f"s{t // 4}_r{t % 4 // 2}_c{t % 2}", (SIZE, SIZE))
                      for t in range(EVAL_TILES)],
            "large": [(f"s{k}_r0_c0", shape) for k, shape in enumerate(EVAL_LARGE)]}
    for name, items in sets.items():
        data = root / name / "test"
        (data / "images").mkdir(parents=True)
        (data / "masks").mkdir()
        for stem, shape in items:
            img, mask = eval_pair(shape, rng)
            cv2.imwrite(str(data / "images" / f"{stem}.jpg"), img)
            cv2.imwrite(str(data / "masks" / f"{stem}.tif"), mask)
    return root / "tiles" / "test", root / "large" / "test"


def tta_counts(predicts: int) -> dict[str, int]:
    """Launches of ``predicts`` TTA predict calls: A, B once and D twice each."""
    return {"fused_zscore_normalize": predicts, "diff_sigmoid_head": predicts,
            "percentile_normalize_u8": 0, "diff_sigmoid_head_backward": 0,
            "d4_transform_batch": 2 * predicts, "ident_hwbc": 0}


def phase_evaluate(dev, tmp: Path, run: Path, smi: str) -> dict:
    """``adipose-torch evaluate`` with TTA, with TTA and the sliding window,
    and ``adipose-torch segment --use-tta`` at full width through
    cli.main.main; then the evaluator through the kernels against the plain
    versions, TTA's de-augmentation, and the timings."""
    from torch.profiler import ProfilerActivity, profile

    from adipose_tpu_torch.core.config import EvalConfig
    from adipose_tpu_torch.eval.evaluator import PublicationEvaluator
    from adipose_tpu_torch.eval.sliding_window import SlidingWindowInference
    from adipose_tpu_torch.eval.tta import make_tta_predict
    from adipose_tpu_torch.ops.blend import blend_tiles, extract_tiles, sliding_window_positions

    tiles_set, large_set = write_eval_sets(tmp / "eval")
    runs = {  # name: (argv, output dir, TTA predict calls)
        "tiles": (["evaluate", "--weights", str(run), "--test-dataset", str(tiles_set),
                   "--use-tta", "--tta-mode", "full", "--batch-size", str(BATCH),
                   "--n-bootstrap", str(EVAL_BOOTSTRAP), "--optimize-threshold",
                   "--no-visualizations"],
                  run / "evaluation" / "test_original_tta_full",
                  math.ceil(EVAL_TILES / max(1, BATCH // 8))),
        "large": (["evaluate", "--weights", str(run), "--test-dataset", str(large_set),
                   "--use-tta", "--tta-mode", "minimal", "--sliding-window", "--overlap", "0.5",
                   "--boundary-refine", "--save-overlays"],
                  run / "evaluation" / "test_original_tta_minimal_sw_gaussian_refine",
                  sum(math.ceil(len(sliding_window_positions((max(h, SIZE), max(w, SIZE)),
                                                             SIZE, 0.5)) / (EVAL_CLI_BATCH // 2))
                      for h, w in EVAL_LARGE)),
    }
    paths, results = {}, {}
    for name, (argv, out, predicts) in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        cli.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        if counts != tta_counts(predicts):
            raise AssertionError(f"evaluate {name} launches {counts}, want {tta_counts(predicts)}")
        missing = [a for a in EVAL_ARTIFACTS if not (out / a).exists()]
        if missing:
            raise AssertionError(f"evaluate {name} wrote no {missing} in {out}")
        results[name] = json.loads((out / "metrics.json").read_text())
        means = {k: v["mean"] for k, v in results[name]["metrics"].items()}
        if not all(math.isfinite(means[k]) for k in ("dice_score", "accuracy", "roc_auc")):
            raise AssertionError(f"evaluate {name}: non-finite means {means}")
        paths[name] = counts
        print(f"evaluate {name}: adipose-torch {' '.join(argv[:1] + argv[3:])} -> "
              f"{out.name}: {results[name]['n_tiles']} images, {results[name]['n_slides']} "
              f"slides, threshold {results[name]['optimal_threshold']:.2f}, dice "
              f"{means['dice_score']:.4f}, roc_auc {means['roc_auc']:.4f}, hausdorff95 "
              f"{means['hausdorff95']:.2f}; launches {counts} ({predicts} TTA predicts); "
              f"{wall:.2f} s incl. start-up [{smi}]")
    if not any((runs["large"][1] / "overlays").rglob("*.png")):
        raise AssertionError("evaluate large: no overlays written")

    # segment --use-tta at its CLI batch 8: chunks of 2 tiles, forward batch
    # 8; then the same call under plain_kernels(), and the device step of its
    # chunks in-process through the kernels and the plain versions.
    seg_chunk = SEGMENT_CLI_BATCH // len(MODE_IDS["basic"])
    seg_argv = ["segment", "--weights", str(run), "--input-dir", str(tiles_set / "images"),
                "--use-tta", "--tta-mode", "basic", "--save-probability", "--device", str(dev)]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        reset_launches()
        cli.main(seg_argv + ["--output-dir", str(tmp / "eval_segment")])
        seg_counts = launches()
        reset_launches()
        with plain_kernels():
            cli.main(seg_argv + ["--output-dir", str(tmp / "eval_segment_plain")])
        if any(launches().values()):
            raise AssertionError(f"plain segment --use-tta launched kernels: {launches()}")
        predict, params, _, _ = _load_segmenter(run, device=dev)
        predict = make_tta_predict(predict, "basic")
        tiles_u8 = np.stack([cv2.imread(str(p), cv2.IMREAD_UNCHANGED) for p in
                             sorted((tiles_set / "images").glob("*.jpg"))])
        chunks = [tiles_u8[i:i + seg_chunk] for i in range(0, EVAL_TILES, seg_chunk)]
        got = [segment_batch(predict, params, c, seg_chunk, dev) for c in chunks]
        reset_launches()
        with plain_kernels():
            ref = [segment_batch(predict, params, c, seg_chunk, dev) for c in chunks]
        if any(launches().values()):
            raise AssertionError(f"plain segment chunks launched kernels: {launches()}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    want = tta_counts(math.ceil(EVAL_TILES / seg_chunk))
    masks = sorted((tmp / "eval_segment" / "masks").glob("*_mask.tif"))
    if seg_counts != want or len(masks) != EVAL_TILES:
        raise AssertionError(f"segment --use-tta: {len(masks)} masks, launches {seg_counts}, "
                             f"want {want}")
    seg_map_err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    # The written u8 maps within 1 grey level; a mask pixel may differ only
    # where both maps sit at 0.5 within EVAL_MAP_ATOL, which writes grey 127.
    grey_err, flips = 0, 0
    for m in masks:
        stem = m.name[:-len("_mask.tif")]
        read = lambda d, sub, suffix: cv2.imread(  # noqa: E731
            str(tmp / d / sub / f"{stem}_{suffix}.tif"), cv2.IMREAD_UNCHANGED).astype(int)
        pk, pp = read("eval_segment", "probability_maps", "prob"), \
            read("eval_segment_plain", "probability_maps", "prob")
        differ = read("eval_segment", "masks", "mask") != read("eval_segment_plain", "masks",
                                                               "mask")
        grey_err = max(grey_err, int(np.abs(pk - pp).max()))
        flips += int(differ.sum())
        if differ.any() and not ((pk[differ] == 127) & (pp[differ] == 127)).all():
            raise AssertionError(f"segment --use-tta {stem}: a mask pixel flipped away from 0.5")
    if not seg_map_err <= EVAL_MAP_ATOL or grey_err > 1:
        raise AssertionError(f"segment --use-tta kernels vs plain: maps {seg_map_err}, "
                             f"probability maps {grey_err} grey levels")
    print(f"segment_tta: adipose-torch segment --use-tta --tta-mode basic over {EVAL_TILES} "
          f"tiles: {len(masks)} masks, launches {seg_counts}; vs plain versions (chunks of "
          f"{seg_chunk}, forward batch {seg_chunk * len(MODE_IDS['basic'])}, deterministic "
          f"cuDNN): maps max abs err {seg_map_err:.3g} (bound {EVAL_MAP_ATOL}), written "
          f"probability maps {grey_err} grey levels apart (bound 1), {flips} mask pixels differ")
    del got, ref

    # The same evaluator through the kernels and through the plain versions.
    cfg = EvalConfig(use_tta=True, tta_mode="full", batch_size=BATCH, transfer_dtype="float32",
                     n_bootstrap=EVAL_BOOTSTRAP)
    ev = PublicationEvaluator(run, cfg, device=dev)
    paths_list = sorted(str(p) for p in (tiles_set / "images").glob("*.jpg"))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        _, got = ev.predict_tiles(paths_list)
        kernel_res = ev.evaluate(tiles_set, "test", output_dir=tmp / "eval_kernels")
        reset_launches()
        with plain_kernels():
            _, ref = ev.predict_tiles(paths_list)
            plain_res = ev.evaluate(tiles_set, "test", output_dir=tmp / "eval_plain")
        if any(launches().values()):
            raise AssertionError(f"plain evaluator launched kernels: {launches()}")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    map_err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    mean_err = max(abs(kernel_res["metrics"][k]["mean"] - plain_res["metrics"][k]["mean"])
                   for k in kernel_res["metrics"])
    if not map_err <= EVAL_MAP_ATOL or not mean_err <= EVAL_MEAN_ATOL or \
            kernel_res["optimal_threshold"] != plain_res["optimal_threshold"]:
        raise AssertionError(f"evaluator kernels vs plain: maps {map_err}, means {mean_err}, "
                             f"thresholds {kernel_res['optimal_threshold']} vs "
                             f"{plain_res['optimal_threshold']}")
    print(f"evaluate kernels vs plain versions (full TTA, float32 maps, deterministic cuDNN): "
          f"maps max abs err {map_err:.3g} (bound {EVAL_MAP_ATOL}), threshold "
          f"{kernel_res['optimal_threshold']:.2f} both, means max abs err {mean_err:.3g} "
          f"(bound {EVAL_MEAN_ATOL})")

    # De-augmentation: full TTA of an equivariant predict gives back the tile.
    tile = torch.from_numpy(cv2.imread(str(paths_list[0]), cv2.IMREAD_UNCHANGED)).to(dev)
    tile = tile[None].to(torch.float32)
    scaled = make_tta_predict(lambda _, t: t / 255.0, "full")(None, tile)
    equiv_err = (scaled - tile / 255.0).abs().max().item()
    if not equiv_err <= TTA_EQUIV_ATOL:
        raise AssertionError(f"full TTA of the scaled tile: max abs err {equiv_err}")

    # The sliding window keeps each image's size.
    large_paths = sorted(str(p) for p in (large_set / "images").glob("*.jpg"))
    sw_ev = PublicationEvaluator(run, EvalConfig(use_tta=True, tta_mode="minimal",
                                                 use_sliding_window=True), device=dev)
    images, maps = sw_ev.predict_tiles(large_paths)
    if [m.shape for m in maps] != [i.shape for i in images] or \
            sorted(m.shape for m in maps) != sorted(EVAL_LARGE):
        raise AssertionError(f"sliding window maps {[m.shape for m in maps]} for images "
                             f"{[i.shape for i in images]}")
    print(f"evaluate checks: full TTA of the scaled tile returns it within {equiv_err:.3g} "
          f"(bound {TTA_EQUIV_ATOL}); sliding-window maps {[m.shape for m in maps]} match "
          f"their images")

    # Timings: TTA predict per chunk, D and A at the TTA shapes, the sliding
    # window per large image, one evaluate run by stage and its idle share.
    tta_ms = {}
    for mode, n_views in (("none", 1), ("basic", 4), ("full", 8)):
        b = max(1, BATCH // n_views)
        fn = ev.predict_raw if mode == "none" else make_tta_predict(ev.predict_raw, mode)
        batches = [torch.randint(0, 256, (b, SIZE, SIZE), device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + i)).to(torch.float32) for i in range(3)]
        ms = cuda_ms(lambda t: fn(ev.params, t), batches, 6)
        tta_ms[mode] = (ms, b * 1000.0 / ms)
        del batches
    print("timing evaluate predict per chunk by CUDA events (float32 tiles, forward batch "
          f"{BATCH}): " + ", ".join(f"{m} TTA {ms:.3f} ms = {r:.2f} tiles/s"
                                    for m, (ms, r) in tta_ms.items()) + f" [{smi}]")
    views = [torch.rand((BATCH, SIZE, SIZE), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + i)) for i in range(3)]
    ids = [torch.randint(0, 8, (BATCH,), dtype=torch.int32, device=dev) for _ in range(3)]
    d_in = list(zip(views, ids))
    d_ms, d_plain = in_turns(lambda a: d4_transform_batch_plain(*a),
                             lambda a: d4_transform_batch(*a), d_in, 20)
    d_dev = profiled_ms(lambda a: d4_transform_batch(*a), d_in, 20, ("d4_kernel",))
    d_bound = bound(2 * BATCH * SIZE * SIZE * 4 + BATCH * 4, 0)
    zs = lambda t: fused_zscore_normalize(t, TRAIN_MEAN_DEFAULT,  # noqa: E731
                                          TRAIN_STD_DEFAULT, out_dtype=torch.bfloat16)
    a_ms, a_plain = in_turns(lambda t: fused_zscore_normalize_plain(
        t, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT, out_dtype=torch.bfloat16), zs, views, 20)
    a_dev = profiled_ms(zs, views, 20, ("zscore_kernel", "zscore_finalize", "emset"))
    n = BATCH * SIZE * SIZE
    a_bound = bound(n * 4 + n * 2 + BATCH * 12, 8 * n)  # f32 in, bf16 out, stats
    print(f"timing d4_transform_batch ({BATCH},{SIZE},{SIZE}) f32 (the TTA views): kernel "
          f"{d_ms:.4f} ms, plain {d_plain:.4f} ms by CUDA events; device time {d_dev} ms per "
          f"call; bound {d_bound[0]:.4f} ms [{smi}]")
    print(f"timing fused_zscore_normalize ({BATCH},{SIZE},{SIZE}) f32 -> bf16 (the TTA views): "
          f"kernel {a_ms:.4f} ms, plain {a_plain:.4f} ms by CUDA events; device time {a_dev} ms "
          f"per call; bound {a_bound[0]:.4f} ms [{smi}]")
    del views, ids, d_in

    sw = SlidingWindowInference(tile_size=SIZE, overlap=0.5, batch_size=BATCH // 2,
                                transfer_dtype="float16", device=dev)
    big = cv2.imread(large_paths[int(np.argmax([i.size for i in images]))], cv2.IMREAD_UNCHANGED)
    predict = make_tta_predict(ev.predict_raw, "minimal")
    sw.predict(predict, ev.params, big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw.predict(predict, ev.params, big)
    sw_s = time.perf_counter() - t0
    image = torch.from_numpy(big).to(dev).to(torch.float32)
    positions = sliding_window_positions(big.shape, SIZE, 0.5)
    tiles = extract_tiles(image, positions, SIZE)
    b = BATCH // 2
    predict_ms = cuda_ms(lambda _: [predict(ev.params, tiles[i:i + b])
                                    for i in range(0, len(tiles), b)], [None], 1)
    preds = torch.cat([predict(ev.params, tiles[i:i + b]) for i in range(0, len(tiles), b)])
    blend_ms = cuda_ms(lambda p: blend_tiles(p, positions, sw.weight_map, *big.shape),
                       [preds], 3)
    print(f"timing sliding window {big.shape[0]}x{big.shape[1]} ({len(positions)} tiles, "
          f"minimal TTA, batch {b} tiles): {sw_s * 1000:.1f} ms per image by the host clock "
          f"incl. upload and float16 copy; predict {predict_ms:.1f} ms, blend {blend_ms:.2f} ms "
          f"by CUDA events [{smi}]")
    del image, tiles, preds

    ev.evaluate(tiles_set, "test", output_dir=tmp / "eval_timed")
    stages = dict(ev.timings)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.evaluate(tiles_set, "test", output_dir=tmp / "eval_profiled")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    print(f"timing evaluate (full TTA, {EVAL_TILES} tiles, {EVAL_BOOTSTRAP} resamples, float32 "
          f"maps) by stage, host clock: {json.dumps({k: round(v, 4) for k, v in stages.items()})}"
          f" = {sum(stages.values()):.3f} s; under the profiler {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle) [{smi}]")
    return {"launches": {k: paths["tiles"][k] + paths["large"][k] for k in paths["tiles"]},
            "segment_tta": seg_counts}


# ---- training -----------------------------------------------------------------

TRAIN_TILES, VAL_TILES = 8, 4
# The fast-head first step, kernels vs plain versions from the same params,
# batch and generator, with cuDNN held to deterministic algorithms: D and P
# are bit-equal, B differs by ~1e-7 and B' rounds dlogit in another order
# than torch's sigmoid backward; the bf16 backward through the network
# carries such one-ulp changes on as flipped roundings (0.62% of the worst
# leaf's max at full width on an H100).
TRAIN_LOSS_ATOL = 1e-3
TRAIN_GRAD_RTOL = 1e-2  # of the leaf's max |g|
ARTIFACTS = ("normalization_stats.json", "training_settings.log", "phase1_training.log",
             "phase2_training.log", "phase1_best/params.npz", "phase2_best/params.npz",
             "weights_best_overall/params.npz", "weights_ema/params.npz")
CLI_TRAIN = TrainConfig(use_hard_mining=True, use_ema=True, use_cosine_schedule=True,
                        normalization_method="percentile", epochs_phase1=1, epochs_phase2=1)


def training_tile(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A seeded 1024^2 grayscale tile with bright round blobs, and the blobs'
    mask, as uint8."""
    coarse = rng.random((10, 10)).astype(np.float32)
    img = 70.0 + 60.0 * cv2.resize(coarse, (SIZE, SIZE), interpolation=cv2.INTER_CUBIC)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    for _ in range(int(rng.integers(6, 14))):
        cy, cx = (int(v) for v in rng.integers(0, SIZE, 2))
        cv2.circle(mask, (cx, cy), int(rng.integers(30, 120)), 1, -1)
    img += 80.0 * mask + rng.normal(0.0, 10.0, (SIZE, SIZE))
    return np.clip(img, 0, 255).astype(np.uint8), mask


def write_dataset(root: Path) -> Path:
    """``dataset/{train,val}/{images,masks}``: jpg tiles and tif masks."""
    rng = np.random.default_rng(SEED)
    for split, n in (("train", TRAIN_TILES), ("val", VAL_TILES)):
        for sub in ("images", "masks"):
            (root / "dataset" / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = training_tile(rng)
            cv2.imwrite(str(root / "dataset" / split / "images" / f"tile{i:02d}.jpg"), img)
            cv2.imwrite(str(root / "dataset" / split / "masks" / f"tile{i:02d}.tif"), mask * 255)
    return root


def train_counts(steps: int, val_batches: int, fast_head: bool) -> dict[str, int]:
    """Launches of a training run: D twice a step (images, masks), P once a
    step and once a val batch; with the fast head, B three times a step and
    a val batch (main and two aux heads) and B' three times a step."""
    heads = 3 if fast_head else 0
    return {"fused_zscore_normalize": 0, "diff_sigmoid_head": heads * (steps + val_batches),
            "percentile_normalize_u8": steps + val_batches,
            "diff_sigmoid_head_backward": heads * steps, "d4_transform_batch": 2 * steps,
            "ident_hwbc": 0}


def check_run(run: Path, what: str) -> dict:
    """The artifact contract of a run dir, finite logged losses, and the
    encoder of phase1_best equal to the seeded init; the logged rows."""
    missing = [a for a in ARTIFACTS if not (run / a).exists()]
    if missing:
        raise AssertionError(f"{what}: missing artifacts {missing}")
    rows = {}
    for phase in (1, 2):
        lines = (run / f"phase{phase}_training.log").read_text().splitlines()
        row = dict(zip(lines[0].split(","), map(float, lines[1].split(","))))
        if len(lines) != 2 or not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"{what}: phase {phase} log {lines}")
        rows[phase] = row
    mcfg = ckpt.detect_model_config(run)
    init = torch_unet_to_flax(init_unet_params(DilatedUNet(
        init_nb=mcfg.init_nb, use_deep_supervision=mcfg.use_deep_supervision, device="meta"),
        SEED))
    best1 = load_flax_npz(run / "phase1_best" / "params.npz")
    for block, layers in best1["params"].items():
        if block.startswith("_ConvBlock"):
            for layer, leaves in layers.items():
                for leaf, v in leaves.items():
                    if not np.array_equal(v, init["params"][block][layer][leaf]):
                        raise AssertionError(f"{what}: phase 1 moved frozen {layer}/{leaf}")
    return rows


def phase_train_cli(dev, tmp: Path, data: Path, smi: str) -> dict:
    """``adipose-torch train-unet`` at its defaults, one epoch per phase; then
    ``adipose-torch segment`` serves the run."""
    steps = 2 * math.ceil(TRAIN_TILES / TRAIN_BATCH)
    val_batches = 2 * math.ceil(VAL_TILES / TRAIN_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["train-unet", "--data-root", str(data), "--epochs-phase1", "1",
              "--epochs-phase2", "1", "--device", str(dev), "--checkpoint-root", str(tmp / "ck"),
              "--run-timestamp", "smoke"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    want = train_counts(steps, val_batches, fast_head=False)
    if counts != want:
        raise AssertionError(f"train-unet launches {counts}, want {want}")
    run = tmp / "ck" / "smoke_adipose_sybreosin_1024_finetune_v3"
    rows = check_run(run, "train-unet")
    print(f"train: adipose-torch train-unet at its defaults (init_nb {INIT_NB}, {SIZE}^2, batch "
          f"{TRAIN_BATCH}, bf16, deep supervision, OHEM, EMA, cosine, moderate, percentile), "
          f"1 + 1 epochs on {TRAIN_TILES} + {VAL_TILES} tiles: {wall:.2f} s incl. start-up; "
          f"launches {counts}; artifacts complete, phase 1 left the encoder bit-unchanged; "
          f"phase 1 loss {rows[1]['loss']:.4f} val dice {rows[1]['val_dice_coef']:.4f}, "
          f"phase 2 loss {rows[2]['loss']:.4f} val dice {rows[2]['val_dice_coef']:.4f}, "
          f"epoch times {rows[1]['epoch_time_s']:.2f} / {rows[2]['epoch_time_s']:.2f} s [{smi}]")

    served = tmp / "served"
    reset_launches()
    cli.main(["segment", "--weights", str(run), "--input-dir",
              str(data / "dataset" / "val" / "images"), "--output-dir", str(served),
              "--batch-size", str(VAL_TILES), "--save-probability", "--device", str(dev)])
    masks = sorted((served / "masks").glob("*_mask.tif"))
    # one batch: the z-score once, the head kernel for the main and both
    # deep-supervision heads (eager PyTorch computes the aux heads as well)
    if len(masks) != VAL_TILES or launches()["fused_zscore_normalize"] != 1 or \
            launches()["diff_sigmoid_head"] != 3:
        raise AssertionError(f"segment of the trained run: {len(masks)} masks, {launches()}")
    share = float(np.mean([(cv2.imread(str(m), cv2.IMREAD_UNCHANGED) > 0).mean() for m in masks]))
    print(f"train: the run served by adipose-torch segment on its {VAL_TILES} val tiles: "
          f"{len(masks)} masks, mask share {share:.3f}, launches {launches()}")
    return {"launches": counts, "run": run}


def first_step(trainer: UNetTrainer, params: dict, imgs: np.ndarray, masks: np.ndarray,
               dev) -> tuple[float, dict[str, torch.Tensor]]:
    """Loss and gradients of one train step from ``params`` on one batch,
    with the generator seeded alike; nothing is updated."""
    cfg = trainer.cfg
    state = TrainState.create(trainer._load(params), cfg.optimizer, cfg.lr_phase1,
                              cfg.weight_decay)
    grads: list = []
    state.apply_gradients = lambda g: grads.extend(t.float().clone() for t in g)
    step = _make_fused_train_step(trainer.model, trainer.loss_fn, cfg.normalization_method,
                                  cfg.percentile_low, cfg.percentile_high)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    aug_imgs, aug_masks = make_augment_step(cfg.augment_level)(
        gen, _to_device(imgs, dev), _to_device(masks, dev))
    stat = torch.zeros((), device=dev)  # unused by the percentile stretch
    metrics = step(state, aug_imgs, aug_masks, gen, stat, stat)
    return metrics["loss"].item(), dict(zip(state.trainable, grads))


def phase_train_fast_head(dev, tmp: Path, data: Path, smi: str) -> dict:
    """``UNetTrainer`` with the fast head: kernels B and B' on the training
    path; its first step against the plain versions."""
    trainer = UNetTrainer(data, CLI_TRAIN, UNetConfig(use_deep_supervision=True, fast_head=True),
                          checkpoint_root=tmp / "ck_fast", build_timestamp="smoke", device=dev)
    steps = 2 * trainer.train_data.steps_per_epoch
    val_batches = 2 * trainer.val_data.steps_per_epoch
    reset_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    want = train_counts(steps, val_batches, fast_head=True)
    if counts != want:
        raise AssertionError(f"fast-head training launches {counts}, want {want}")
    rows = check_run(Path(result["checkpoint_dir"]), "fast-head training")

    params = trainer.init_params()
    imgs, masks = next(iter(trainer.train_data.epoch_batches(0)))
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, grads_k = first_step(trainer, params, imgs, masks, dev)
        reset_launches()
        with plain_kernels():
            loss_p, grads_p = first_step(trainer, params, imgs, masks, dev)
    finally:
        torch.backends.cudnn.deterministic = False
    if any(launches().values()):
        raise AssertionError(f"plain first step launched kernels: {launches()}")
    loss_err = abs(loss_k - loss_p)
    worst_leaf, worst = "", 0.0
    for k, gk in grads_k.items():
        gp = grads_p[k]
        rel = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        if rel > worst:
            worst_leaf, worst = k, rel
    if not (math.isfinite(loss_k) and loss_err <= TRAIN_LOSS_ATOL and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"fast-head first step vs plain: loss {loss_k} vs {loss_p}, worst "
                             f"grad {worst_leaf} {worst}")
    print(f"train fast head: UNetTrainer(UNetConfig(fast_head=True)) 1 + 1 epochs: {wall:.2f} s; "
          f"launches {counts}; artifacts complete; phase 2 loss {rows[2]['loss']:.4f} val dice "
          f"{rows[2]['val_dice_coef']:.4f}; first step kernels vs plain: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (|d| {loss_err:.3g}, bound {TRAIN_LOSS_ATOL}), worst grad leaf "
          f"{worst_leaf} {worst:.3g} of its max (bound {TRAIN_GRAD_RTOL}; deterministic cuDNN) "
          f"[{smi}]")
    return {"launches": counts, "err": loss_err}


def phase_train_timing(dev, tmp: Path, data: Path, smi: str) -> dict:
    """Train step (augment + normalize + forward + backward + update) and
    augmentation alone by CUDA events at batch 2 and 8 on distinct device
    batches; peak memory; the device's idle share over one epoch."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stat = torch.zeros((), device=dev)
    for fast_head, batch in ((False, 2), (False, 8), (True, 2)):
        model = DilatedUNet(init_nb=INIT_NB, use_deep_supervision=True, fast_head=fast_head,
                            device=dev)
        live = dict(model.named_parameters())
        with torch.no_grad():
            for k, v in init_unet_params(model, SEED).items():
                live[k].copy_(v)
        state = TrainState.create(live, "adam", 1e-5, 0.01)
        loss_fn = unet_loss_from_config(CLI_TRAIN)
        step = _make_fused_train_step(model, loss_fn, "percentile", 1.0, 99.0)
        augment = make_augment_step("moderate")
        batches = [(torch.randint(0, 256, (batch, SIZE, SIZE), dtype=torch.uint8, device=dev,
                                  generator=gen),
                    (torch.rand((batch, SIZE, SIZE), device=dev, generator=gen) > 0.6)
                    .to(torch.uint8)) for _ in range(3)]
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda b: step(state, *augment(gen, *b), gen, stat, stat), batches,
                          6 if batch == 2 else 3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        aug_ms = cuda_ms(lambda b: augment(gen, *b), batches, 6)
        out[(fast_head, batch)] = (step_ms, aug_ms, peak)
        print(f"timing train step, {'fast' if fast_head else 'softmax'} head, batch {batch}: "
              f"{step_ms:.2f} ms incl. augmentation = {batch * 1000.0 / step_ms:.2f} tiles/s; "
              f"moderate augmentation alone {aug_ms:.2f} ms; peak memory {peak:.2f} GB "
              f"(CUDA events, {SIZE}^2, init_nb {INIT_NB}, bf16) [{smi}]")
        del model, live, state, batches
        torch.cuda.empty_cache()

    trainer = UNetTrainer(data, CLI_TRAIN, UNetConfig(use_deep_supervision=True),
                          checkpoint_root=tmp / "ck_prof", build_timestamp="smoke", device=dev)
    params = trainer.init_params()
    trainer._run_phase(2, params, 1, 1e-5, 1e-8, 0.995, False, True, "moderate")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_phase(2, params, 1, 1e-5, 1e-8, 0.995, False, True, "moderate")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((device_us(e) / 1e6, e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(t for t, _ in kernels)
    idle = 1 - busy / wall
    print(f"timing train epoch (phase 2, {trainer.train_data.steps_per_epoch} steps of "
          f"{TRAIN_BATCH} + {trainer.val_data.steps_per_epoch} val batches, checkpoint writes "
          f"incl.): {wall:.3f} s wall under the profiler, device busy {busy:.3f} s "
          f"({100 * idle:.1f}% idle) [{smi}]")
    print("  top device activities (s): " + "; ".join(
        f"{name[:60]} {t:.4f}" for t, name in kernels[:10]))
    return {"steps": out, "idle": idle}


# ---- classifier training --------------------------------------------------------

CLS_BATCH = 32  # the train-classifier default
CLS_TRAIN_TILES, CLS_VAL_TILES = 64, 32  # half in each class
# The first step of each phase, kernels vs plain versions from the same
# variables, tiles and generator, cuDNN deterministic: P and D are bit-equal
# to their plain versions, so the two steps see bit-equal inputs and run the
# same algorithms; any gap would be a fault, these bounds leave no room for
# one beyond float32 rounding.
CLS_LOSS_ATOL = 1e-6
CLS_GRAD_RTOL = 1e-5  # of the leaf's max |g|
CLS_ARTIFACTS = ("config.json", "training.log", "weights_best/params.npz",
                 "weights_final/params.npz")
CLS_LOG_COLUMNS = ["epoch", "loss", "acc", "val_auc", "val_acc", "lr", "epoch_time_s"]


def write_class_dataset(root: Path) -> Path:
    """``{train,val}/{adipose,not_adipose}/*.jpg``, 1024^2 grayscale: tiles
    with bright round blobs (adipose) and with faint ones (not adipose),
    named as tiles of four slides."""
    rng = np.random.default_rng(SEED)
    for split, n in (("train", CLS_TRAIN_TILES), ("val", CLS_VAL_TILES)):
        for cls in ("adipose", "not_adipose"):
            (root / split / cls).mkdir(parents=True, exist_ok=True)
            for i in range(n // 2):
                img, mask = training_tile(rng)
                if cls == "not_adipose":  # fainter blobs: the classes overlap
                    img = np.clip(img.astype(np.float32) - 50.0 * mask, 0, 255).astype(np.uint8)
                cv2.imwrite(str(root / split / cls / f"s{i % 4}_r{i}_c0.jpg"), img)
    return root


def cls_counts(steps: int, val_batches: int) -> dict[str, int]:
    """Launches of classifier training: P once a step and a val batch, D
    once a step."""
    return {name: 0 for name in KERNELS} | {"percentile_normalize_u8": steps + val_batches,
                                              "d4_transform_batch": steps}


def cls_first_step(trainer: ClassifierTrainer, variables: dict, imgs: torch.Tensor,
                   labels: torch.Tensor, phase: int, dev, low_res: bool = False):
    """Prep output, loss and gradients of the first train step of ``phase``
    from ``variables`` on one device batch, its draws and dropout from
    batch 0's generator; nothing is kept."""
    cfg = trainer.cfg
    unfreeze_from = None if phase == 1 else trainer.model_cfg.unfreeze_from
    trainer._load(variables)
    params = dict(trainer.model.named_parameters())
    mask = backbone_param_mask(params, unfreeze_from)
    smask = classifier_stats_mask(dict(trainer.model.named_buffers()), mask)
    state = TrainState.create(params, cfg.optimizer, cfg.lr_phase1, cfg.weight_decay, mask)
    grads: list = []
    state.apply_gradients = lambda g: grads.extend(t.float().clone() for t in g)
    gen = generator_for(f"cls.p{phase}", SEED, 0, device=dev)
    size = INCEPTION_SIZE if low_res else imgs.shape[-1]
    x = _make_preprocess_step(True, 1.0, 99.0, low_res)(
        imgs, draw_tier(gen, "classification", imgs.shape[0], size, size))
    step = _make_cls_step(trainer.model, trainer.label_smoothing, smask,
                          frozen_conv_boundary(unfreeze_from))
    class_w = torch.ones(2, device=dev)
    metrics = step(state, x, labels, class_w, gen)
    return x, metrics["loss"].item(), dict(zip(state.trainable, grads))


def differing(a: dict, b: dict, names) -> list[str]:
    """The names whose tensors differ between ``a`` and ``b``."""
    return [k for k in names if not torch.equal(a[k].cpu(), b[k].cpu())]


def phase_train_classifier(dev, tmp: Path, smi: str) -> dict:
    """``adipose-torch train-classifier`` at its defaults, 1 + 1 epochs from
    seeded pretrained weights; the kernels against their plain versions on
    each phase's first step and a low-res step; the best weights served."""
    data = write_class_dataset(tmp / "cls_data")
    pretrained = tmp / "cls_pretrained"
    seeded = InceptionV3Classifier().init_params(torch.Generator().manual_seed(SEED + 1))
    ckpt.save_params(pretrained, "weights_best", torch_inception_to_flax(seeded.state_dict()))
    start = flax_inception_to_torch(ckpt.load_params(pretrained / "weights_best"))

    phases: dict[int, tuple[dict, dict]] = {}  # phase: (its start, its best)
    run_phase = ClassifierTrainer._run_phase

    def spy(self, phase, variables, *args, **kwargs):
        best, auc = run_phase(self, phase, variables, *args, **kwargs)
        phases[phase] = (variables, best)
        return best, auc

    steps = 2 * math.ceil(CLS_TRAIN_TILES / CLS_BATCH)
    val_batches = 2 * math.ceil(CLS_VAL_TILES / CLS_BATCH)
    ClassifierTrainer._run_phase = spy
    reset_launches()
    t0 = time.perf_counter()
    try:
        cli.main(["train-classifier", "--dataset-root", str(data), "--warmup-epochs", "1",
                  "--finetune-epochs", "1", "--batch-size", str(CLS_BATCH),
                  "--pretrained-weights", str(pretrained),
                  "--checkpoint-dir", str(tmp / "ck_cls"), "--device", str(dev)])
        torch.cuda.synchronize()
    finally:
        ClassifierTrainer._run_phase = run_phase
    wall = time.perf_counter() - t0
    counts = launches()
    want = cls_counts(steps, val_batches)
    if counts != want:
        raise AssertionError(f"train-classifier launches {counts}, want {want}")
    (run,) = (tmp / "ck_cls").iterdir()
    missing = [a for a in CLS_ARTIFACTS if not (run / a).exists()]
    if missing or not run.name.endswith("_classifier_adipose_sybreosin_percentile"):
        raise AssertionError(f"train-classifier run {run.name}: missing {missing}")
    config = json.loads((run / "config.json").read_text())
    if config["batch_size"] != CLS_BATCH or config["label_smoothing"] != 0.1:
        raise AssertionError(f"train-classifier config.json {config}")
    lines = (run / "training.log").read_text().splitlines()
    row = dict(zip(lines[0].split(","), map(float, lines[1].split(","))))
    if lines[0].split(",") != CLS_LOG_COLUMNS or len(lines) != 2 or \
            not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"train-classifier training.log {lines}")

    # Phase 1 moves only the head; phase 2 nothing below conv 70.
    (in1, best1), (in2, best2) = phases[1], phases[2]
    if differing(start, in1, start):
        raise AssertionError("phase 1 did not start from the pretrained weights")
    below70 = [k for k in in1 if k.startswith("backbone.") and int(k.split(".")[1][4:]) < 70]
    moved1, moved2 = differing(in1, best1, in1), differing(in2, best2, in2)
    if set(moved1) != {"adipose_score.weight", "adipose_score.bias"}:
        raise AssertionError(f"phase 1 moved {moved1[:5]}")
    if differing(in2, best2, below70) or not moved2:
        raise AssertionError(f"phase 2 moved frozen {differing(in2, best2, below70)[:5]}")
    final = flax_inception_to_torch(ckpt.load_params(run / "weights_final"))
    if differing(final, best2, final):
        raise AssertionError("weights_final is not phase 2's best")

    # weights_best, served, gives the logged val AUC of its epoch.
    predict, state = _load_classifier(run, device=dev)
    val = ClassificationDataset(data / "val", CLS_BATCH, SEED)
    probs, labels = [], []
    for imgs, lab in val.epoch_batches(0, shuffle=False):
        probs.append(predict(state, torch.from_numpy(imgs).to(dev)))
        labels.append(torch.from_numpy(lab).to(dev))
    served = roc_auc(torch.cat(probs), torch.cat(labels)).item()
    n_pos, n_neg = val.class_counts()
    if not abs(served - row["val_auc"]) <= 1.0 / (n_pos * n_neg):
        raise AssertionError(f"served val AUC {served} vs logged {row['val_auc']}")

    # Each phase's first step, and a low-res step, against the plain versions.
    trainer = ClassifierTrainer(data, TrainConfig(batch_size=CLS_BATCH, lr_phase1=1e-3,
                                                  lr_phase2=1e-4),
                                checkpoint_root=tmp / "ck_cls_steps", device=dev)
    imgs, lab = next(iter(trainer.train_data.epoch_batches(0)))
    imgs, lab = torch.from_numpy(imgs).to(dev), torch.from_numpy(lab).to(dev)
    cudnn = torch.backends.cudnn
    cudnn.deterministic = True
    compared = []
    try:
        for phase, low_res in ((1, False), (2, False), (2, True)):
            reset_launches()
            xk, loss_k, grads_k = cls_first_step(trainer, start, imgs, lab, phase, dev, low_res)
            counts_k = launches()
            reset_launches()
            with plain_kernels():
                xp, loss_p, grads_p = cls_first_step(trainer, start, imgs, lab, phase, dev,
                                                     low_res)
            if any(launches().values()) or counts_k != cls_counts(1, 0):
                raise AssertionError(f"first step launches {counts_k}, plain {launches()}")
            if xk.shape != (CLS_BATCH, INCEPTION_SIZE, INCEPTION_SIZE, 3) or \
                    not torch.equal(bits(xk.contiguous()), bits(xp.contiguous())):
                raise AssertionError(f"phase {phase} low_res {low_res}: prep not bit-equal")
            worst_leaf, worst = "", 0.0
            for k, gk in grads_k.items():
                gp = grads_p[k]
                rel = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
                if rel >= worst:
                    worst_leaf, worst = k, rel
            loss_err = abs(loss_k - loss_p)
            if not (math.isfinite(loss_k) and loss_err <= CLS_LOSS_ATOL
                    and worst <= CLS_GRAD_RTOL):
                raise AssertionError(f"phase {phase} first step vs plain: loss {loss_k} vs "
                                     f"{loss_p}, worst grad {worst_leaf} {worst}")
            compared.append(f"phase {phase}{' low-res' if low_res else ''} loss {loss_k:.6f} "
                            f"(|d| {loss_err:.3g}), {len(grads_k)} grad leaves, worst "
                            f"{worst:.3g} of its max")
    finally:
        cudnn.deterministic = False
    print(f"train classifier: adipose-torch train-classifier at its defaults (batch "
          f"{CLS_BATCH}, bf16, percentile, mixed7, label smoothing 0.1, dropout 0.4) from "
          f"seeded pretrained weights, 1 + 1 epochs on {CLS_TRAIN_TILES} + {CLS_VAL_TILES} "
          f"tiles {SIZE}^2: {wall:.2f} s incl. start-up; launches {counts}; artifacts "
          f"complete; phase 1 moved the head only, phase 2 nothing below conv 70 "
          f"({len(moved2)} leaves moved); phase 2 loss {row['loss']:.4f} acc {row['acc']:.4f} "
          f"val AUC {row['val_auc']:.4f} val acc {row['val_acc']:.4f}, epoch "
          f"{row['epoch_time_s']:.2f} s; weights_best served: val AUC {served:.4f} (bound "
          f"1/{n_pos * n_neg}) [{smi}]")
    print(f"train classifier: first steps through P and D vs the plain versions (prep "
          f"bit-equal; loss bound {CLS_LOSS_ATOL}, grads {CLS_GRAD_RTOL} of each leaf's max; "
          f"deterministic cuDNN): " + "; ".join(compared))
    return {"launches": counts, "trainer": trainer, "start": start, "run": run}


# ---- classifier evaluation and the rest of segmentation evaluation ----------------

CLS_EVAL_TILES, CLS_EVAL_CAL_TILES = 128, 64  # test and calibration tiles, half per class
CLS_EVAL_BATCH = 64  # eval-classifier's default --batch-size: 512 views under full TTA
CLASSIFY_BATCH = 32  # classify's default --batch-size
CHECKPOINTS_BOOTSTRAP = 200
# Kernels vs plain versions on the classifier paths, cuDNN deterministic: P
# and D are bit-equal, so both forwards see the same views; this bound leaves
# no room for a fault beyond float32 rounding.
CLS_EVAL_PROB_ATOL = 1e-6
CLS_EVAL_ARTIFACTS = ("metrics.json", "predictions.csv", "roc_curve.png", "pr_curve.png",
                      "calibration.png", "probability_histogram.png")


def write_cls_eval_set(root: Path) -> Path:
    """``{test,val}/{adipose,not_adipose}/*.jpg``, 1024^2: shifted copies of
    eight blob tiles with fresh noise (adipose brighter blobs), named as
    tiles of four slides; written by threads."""
    rng = np.random.default_rng(SEED + 2)
    bases = [training_tile(rng) for _ in range(8)]
    jobs = []
    for split, n in (("test", CLS_EVAL_TILES), ("val", CLS_EVAL_CAL_TILES)):
        for cls, dim in (("adipose", 0), ("not_adipose", 45)):
            (root / split / cls).mkdir(parents=True)
            for i in range(n // 2):
                img, mask = bases[int(rng.integers(0, 8))]
                shift = tuple(int(v) for v in rng.integers(0, SIZE, 2))
                noise = rng.integers(-12, 13, (SIZE, SIZE), dtype=np.int16)
                tile = np.roll(img.astype(np.int16) - dim * mask + noise, shift, (0, 1))
                jobs.append((root / split / cls / f"s{i % 4}_r{i}_c0.jpg",
                             np.clip(tile, 0, 255).astype(np.uint8)))
    thread_map(lambda job: cv2.imwrite(str(job[0]), job[1]), jobs)
    return root


def cls_predict_counts(predicts: int) -> dict[str, int]:
    """Launches of ``predicts`` classifier TTA predicts with the stretch: P
    and D once each."""
    return {name: 0 for name in KERNELS} | {"percentile_normalize_u8": predicts,
                                              "d4_transform_batch": predicts}


def read_csv_rows(path: Path) -> list[dict]:
    import csv

    with path.open(newline="") as f:
        return list(csv.DictReader(f))


def phase_classifier_eval(dev, tmp: Path, cls_run: Path, seg_run: Path, smi: str) -> dict:
    """``adipose-torch eval-classifier`` at its defaults with isotonic
    calibration on a val split and a snapshot, ``classify`` with TTA and the
    stretch and at its defaults, ``tile-classification-eval --use-tta
    --multi-threshold``, ``evaluate-checkpoints`` then ``visualize-metrics``,
    each through cli.main.main; the kernel paths against the same calls
    under plain_kernels(); the timings."""
    from torch.profiler import ProfilerActivity, profile

    from adipose_tpu_torch.eval.classifier_eval import run_classifier_evaluation
    from adipose_tpu_torch.eval.tta import make_classifier_tta_predict

    data = write_cls_eval_set(tmp / "cls_eval")
    test_chunks = math.ceil(CLS_EVAL_TILES / CLS_EVAL_BATCH)
    cal_chunks = math.ceil(CLS_EVAL_CAL_TILES / CLS_EVAL_BATCH)
    snapshot = cls_run / "weights_final"
    paths: dict[str, dict[str, int]] = {}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False

    def twice(name: str, argv: list[str], out_flag: str, out: Path, want: dict) -> float:
        """The call through the kernels (counted, checked against ``want``)
        and under plain_kernels() (nothing launched); its wall seconds."""
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(argv + [out_flag, str(out), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[name] = launches()
        if paths[name] != want:
            raise AssertionError(f"{name} launches {paths[name]}, want {want}")
        reset_launches()
        with plain_kernels():
            cli.main(argv + [out_flag, str(out) + "_plain", "--device", str(dev)])
        if any(launches().values()):
            raise AssertionError(f"plain {name} launched kernels: {launches()}")
        return wall

    try:
        # eval-classifier at every default, isotonic calibration on the val
        # split, weights_final as a second snapshot
        ec_argv = ["eval-classifier", "--weights", str(cls_run), "--dataset-root", str(data),
                   "--batch-size", str(CLS_EVAL_BATCH), "--calibration", "isotonic", "--calibration-val-root", str(data),
                   "--snapshot", str(snapshot)]
        out = tmp / "cls_eval_out"
        ec_wall = twice("eval_classifier", ec_argv, "--output", out,
                        cls_predict_counts(2 * (test_chunks + cal_chunks)))
        ec_peak = torch.cuda.max_memory_allocated() / 1e9
        missing = [a for a in CLS_EVAL_ARTIFACTS if not (out / a).exists()]
        examples = sorted((out / "examples").rglob("*.jpg"))
        metrics = json.loads((out / "metrics.json").read_text())
        plain = json.loads((Path(str(out) + "_plain") / "metrics.json").read_text())
        rows, rows_p = (read_csv_rows(d / "predictions.csv") for d in (out, Path(str(out) + "_plain")))
        probs = np.array([float(r["probability"]) for r in rows])
        probs_p = np.array([float(r["probability"]) for r in rows_p])
        if missing or not examples or len(rows) != CLS_EVAL_TILES or \
                metrics["calibration"]["method"] != "isotonic" or \
                not all(math.isfinite(metrics[k]) for k in ("roc_auc", "pr_auc")):
            raise AssertionError(f"eval-classifier: missing {missing}, {len(examples)} examples, "
                                 f"{len(rows)} rows, metrics {json.dumps(metrics)[:300]}")
        ec_err = float(np.abs(probs - probs_p).max())
        if [r["file"] for r in rows] != [r["file"] for r in rows_p] or \
                not ec_err <= CLS_EVAL_PROB_ATOL or \
                metrics["best_threshold"] != plain["best_threshold"]:
            raise AssertionError(f"eval-classifier kernels vs plain: probabilities {ec_err}, "
                                 f"thresholds {metrics['best_threshold']} vs "
                                 f"{plain['best_threshold']}")
        print(f"eval_classifier: adipose-torch eval-classifier at its defaults (batch "
              f"{CLS_EVAL_BATCH}, full TTA = {8 * CLS_EVAL_BATCH} views of {SIZE}^2, percentile "
              f"norm, plots, examples) + isotonic calibration on {CLS_EVAL_CAL_TILES} val tiles "
              f"+ 1 snapshot, {CLS_EVAL_TILES} test tiles: roc_auc {metrics['roc_auc']:.4f}, "
              f"pr_auc {metrics['pr_auc']:.4f}, best threshold {metrics['best_threshold']:.2f}, "
              f"val calibrated AUC {metrics['calibration']['val_calibrated_auc']:.4f}, "
              f"{len(examples)} examples; launches {paths['eval_classifier']}; vs plain versions "
              f"(deterministic cuDNN) calibrated probabilities max abs err {ec_err:.3g} (bound "
              f"{CLS_EVAL_PROB_ATOL}), same threshold; {ec_wall:.2f} s incl. start-up, peak "
              f"memory {ec_peak:.2f} GB [{smi}]")

        # classify: TTA + stretch at its CLI batch through P and D, then at
        # its defaults (no stretch, no TTA: no kernel)
        cl_argv = ["classify", "--weights", str(cls_run), "--input-dir", str(data / "test"),
                   "--batch-size", str(CLASSIFY_BATCH), "--use-tta", "--tta-mode", "basic", "--percentile-norm"]
        cl_out = tmp / "classify_out"
        twice("classify_tta", cl_argv, "--output-dir", cl_out,
              cls_predict_counts(math.ceil(CLS_EVAL_TILES / CLASSIFY_BATCH)))
        cl_rows, cl_rows_p = (read_csv_rows(d / "predictions_grayscale_tta.csv")
                              for d in (cl_out, Path(str(cl_out) + "_plain")))
        cl_err = max(abs(float(a["adipose_probability"]) - float(b["adipose_probability"]))
                     for a, b in zip(cl_rows, cl_rows_p))
        if len(cl_rows) != CLS_EVAL_TILES or not cl_err <= CLS_EVAL_PROB_ATOL or \
                [r["binary_prediction"] for r in cl_rows] != \
                [r["binary_prediction"] for r in cl_rows_p]:
            raise AssertionError(f"classify --use-tta: {len(cl_rows)} rows, kernels vs plain "
                                 f"{cl_err}")
        reset_launches()
        cli.main(["classify", "--weights", str(cls_run), "--input-dir", str(data / "test"),
                  "--batch-size", str(CLASSIFY_BATCH), "--output-dir",
                  str(tmp / "classify_default"), "--device", str(dev)])
        if any(launches().values()) or \
                len(read_csv_rows(tmp / "classify_default" / "predictions_grayscale.csv")) != \
                CLS_EVAL_TILES:
            raise AssertionError(f"classify at its defaults launched {launches()}")
        print(f"classify: adipose-torch classify --use-tta --tta-mode basic --percentile-norm "
              f"(batch {CLASSIFY_BATCH}, {4 * CLASSIFY_BATCH} views) over {CLS_EVAL_TILES} tiles: "
              f"launches {paths['classify_tta']}; vs plain versions max abs err {cl_err:.3g} "
              f"(bound {CLS_EVAL_PROB_ATOL}), same calls; at its defaults 0 launches")

        # tile-classification-eval on the evaluate phase's 8 tiles: basic TTA
        # at forward batch 8 = 4 predicts of 2 tiles
        tiles_set = tmp / "eval" / "tiles" / "test"
        tce_argv = ["tile-classification-eval", "--weights", str(seg_run), "--test-dataset",
                    str(tiles_set), "--use-tta", "--multi-threshold"]
        twice("tile_classification_eval", tce_argv, "--output", tmp / "tce",
              tta_counts(math.ceil(EVAL_TILES / (8 // len(MODE_IDS["basic"])))))
        name = "tile_classification_metrics.json"
        tce, tce_p = (json.loads((d / name).read_text()) for d in
                      (tmp / "tce", tmp / "tce_plain"))
        if tce != tce_p or tce["n_tiles"] != EVAL_TILES or len(tce["threshold_sweep"]) != 5:
            raise AssertionError(f"tile-classification-eval kernels vs plain: {tce} vs {tce_p}")
        print(f"tile_classification_eval: adipose-torch tile-classification-eval --use-tta "
              f"--multi-threshold on {EVAL_TILES} tiles: confusion {tce['confusion_matrix']} at "
              f"coverage {tce['coverage_threshold']}, sweep of {len(tce['threshold_sweep'])}; "
              f"launches {paths['tile_classification_eval']}; JSON equal to the plain run's")

        # evaluate-checkpoints over two copies of the slice's run, then
        # visualize-metrics
        root = tmp / "checkpoints"
        for d in ("20240101_000000_adipose_a", "20240102_000000_adipose_b"):
            shutil.copytree(seg_run, root / d, ignore=shutil.ignore_patterns("evaluation"))
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["evaluate-checkpoints", "--checkpoints-root", str(root), "--test-dataset",
                  str(tiles_set), "--no-images", "--n-bootstrap", str(CHECKPOINTS_BOOTSTRAP),
                  "--device", str(dev)])
        torch.cuda.synchronize()
        ck_wall = time.perf_counter() - t0
        paths["evaluate_checkpoints"] = launches()
        n_batches = math.ceil(EVAL_TILES / EVAL_CLI_BATCH)
        want = {name: 0 for name in KERNELS} | {"fused_zscore_normalize": 2 * n_batches,
                                                "diff_sigmoid_head": 2 * n_batches}
        summary = json.loads((root / "batch_evaluation_summary.json").read_text())
        if paths["evaluate_checkpoints"] != want or \
                [r["status"] for r in summary] != ["success", "success"] or \
                summary[0]["dice"] != summary[1]["dice"]:
            raise AssertionError(f"evaluate-checkpoints launches {paths['evaluate_checkpoints']}"
                                 f", want {want}; records {json.dumps(summary)[:400]}")
        png = tmp / "checkpoint_comparison.png"
        cli.main(["visualize-metrics", "--checkpoints-root", str(root), "--output", str(png)])
        chart = cv2.imread(str(png))
        if chart is None or chart.std() == 0:
            raise AssertionError("visualize-metrics wrote no chart")
        print(f"evaluate_checkpoints: adipose-torch evaluate-checkpoints over 2 copies of the "
              f"slice's run, {EVAL_TILES} tiles, {CHECKPOINTS_BOOTSTRAP} resamples: both "
              f"success, dice {summary[0]['dice']:.4f} both, threshold "
              f"{summary[0]['threshold']:.2f}; launches {paths['evaluate_checkpoints']}; "
              f"{ck_wall:.2f} s incl. start-up; visualize-metrics wrote a "
              f"{chart.shape[1]}x{chart.shape[0]} chart [{smi}]")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved

    # Timings: the TTA predict per chunk of 64 tiles, the flow by stage and
    # its idle share, P and D at the flow's (512, 1024^2) float32 views.
    predict, state = _load_classifier(cls_run, device=dev)
    tta = make_classifier_tta_predict(predict, "full")
    chunks = [torch.randint(0, 256, (CLS_EVAL_BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + i))
              for i in range(3)]
    chunk_ms = cuda_ms(lambda t: tta(state, t), chunks, 3)
    del chunks
    print(f"timing eval-classifier predict per chunk of {CLS_EVAL_BATCH} tiles (full TTA, "
          f"{8 * CLS_EVAL_BATCH} views, P, D, resize, bf16 InceptionV3) by CUDA events: "
          f"{chunk_ms:.2f} ms = {CLS_EVAL_BATCH * 1000.0 / chunk_ms:.2f} tiles/s [{smi}]")
    from adipose_tpu_torch.data.loader import ClassificationDataset as Dataset

    snapshots = [state, cli._classifier_state(snapshot, dev)]

    def flow(out_dir: Path, timings: dict) -> None:
        run_classifier_evaluation(predict, snapshots, Dataset(data / "test", CLS_EVAL_BATCH),
                                  out_dir, calibration="isotonic",
                                  calibration_dataset=Dataset(data / "val", CLS_EVAL_BATCH),
                                  num_examples=10, percentile_norm_examples=True,
                                  device=dev, timings=timings)
        torch.cuda.synchronize()

    stages: dict[str, float] = {}
    flow(tmp / "cls_eval_timed", stages)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        flow(tmp / "cls_eval_profiled", {})
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    print(f"timing eval-classifier flow ({CLS_EVAL_TILES} + {CLS_EVAL_CAL_TILES} tiles, 2 "
          f"snapshots, isotonic) by stage, host clock: "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})} = "
          f"{sum(stages.values()):.3f} s; under the profiler {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100 * (1 - busy / wall):.1f}% idle) [{smi}]")
    del snapshots, state

    n_views = 8 * CLS_EVAL_BATCH
    x = torch.randint(0, 256, (n_views, SIZE, SIZE), dtype=torch.uint8, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED)).to(torch.float32)
    ids = (torch.arange(n_views, device=dev) // CLS_EVAL_BATCH).to(torch.int32)
    for name, kernel, plain_fn in (
            ("percentile_normalize_u8", lambda t: percentile_normalize_u8(t),
             lambda t: percentile_normalize_u8_plain(t)),
            ("d4_transform_batch", lambda t: d4_transform_batch(t, ids),
             lambda t: d4_transform_batch_plain(t, ids))):
        if not torch.equal(bits(kernel(x)), bits(plain_fn(x))):
            raise AssertionError(f"{name} ({n_views},{SIZE},{SIZE}) f32: not bit-equal to plain")
        k_ms, p_ms = in_turns(plain_fn, kernel, [x], 5)
        names = (("hist_kernel", "percentile_kernel", "apply_kernel", "emset")
                 if name == "percentile_normalize_u8" else ("d4_kernel",))
        # short sessions lose their last launches now and then: 20 calls
        dev_ms = profiled_ms(kernel, [x], 20, names)
        # f32 in and out (and D's ids); P's ~6 operations a pixel
        b_ms, b_by = bound(2 * x.numel() * 4 + (n_views * 4 if name == "d4_transform_batch"
                                                else 0),
                           6 * x.numel() if name == "percentile_normalize_u8" else 0)
        print(f"timing {name} ({n_views},{SIZE},{SIZE}) f32 (eval-classifier's views): "
              f"bit-equal to plain; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms by CUDA events; "
              f"device time {dev_ms} ms per call; bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / dev_ms if dev_ms else 0:.1f}% of it [{smi}]")
        torch.cuda.empty_cache()
    del x, ids
    return paths


# ---- dataset builds and the WSI tools ------------------------------------------

BUILD_SLIDES = CHUNKS  # the chunk sizes chunk-wsi writes: 75 tiles of 1024^2
BUILD_QC_CHUNK = 16  # the builders' QC batch
# The same build on the card and on the CPU: Reinhard's float32 rounding
# differs (pow, the means' order) and a pixel on a level boundary moves by one
# level (torch on the CPU against JAX: one level in 3.4e-5 of the pixels).
BUILD_U8_LEVELS, BUILD_U8_SHARE = 1, 1e-3
# Reinhard scales each tile's rounding by ref_std / src_std: a near-white or
# blurred tile of little colour variance (amplified over 4x) moves more of
# its pixels by the one level (tests/test_torch_build.py: 1.5e-2 at 28x).
BUILD_ILL_AMPLIFICATION, BUILD_ILL_SHARE = 4.0, 3e-2
RUN_PIPELINE_EVAL_BATCH = 16  # EvalConfig's batch_size


def build_slide(shape: tuple[int, int], rng: np.random.Generator):
    """A seeded BGR slide with tissue-like colour structure and fine texture,
    a near-white band over the first tile row and a blurred 1024 x 2048
    region; and its annotation records: ``fat`` polygons at confidences 1-3
    (the confidence-1 ones alone in their tiles) and ``bubbles`` over fat."""
    h, w = shape

    def poly(cx, cy, r):
        a = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        rr = r * (1 + 0.2 * np.sin(3 * a))
        return [[float(cx + x), float(cy + y)] for x, y in zip(rr * np.cos(a), rr * np.sin(a))]

    img = np.empty((h, w, 3), np.float32)
    for c, (lo, span) in enumerate(((120, 90), (60, 120), (130, 100))):
        coarse = rng.random((h // 256 + 2, w // 256 + 2)).astype(np.float32)
        img[..., c] = lo + span * cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0.0, 10.0, (h, w, 1)).astype(np.float32)
    # scanner background: near-white with noise in each channel
    img[:SIZE] = 244.0 + 10.0 * rng.random((SIZE, w, 3), dtype=np.float32)
    y0, x0 = SIZE, min(2 * SIZE, w - 2 * SIZE)
    region = np.ascontiguousarray(img[y0:y0 + SIZE, x0:x0 + 2 * SIZE])
    img[y0:y0 + SIZE, x0:x0 + 2 * SIZE] = cv2.GaussianBlur(region, (0, 0), 8)
    fat, bubbles = [], []
    for _ in range(3 * h * w // (2 * SIZE * SIZE)):  # clear of the last tile column
        r = float(rng.uniform(150, 450))
        cx, cy = float(rng.uniform(0, w - SIZE - 1.2 * r - 8)), float(rng.uniform(SIZE, h))
        fat.append({"confidenceScore": int(rng.integers(2, 4)),
                    "annotation": {"elements": [{"type": "polyline", "points": poly(cx, cy, r)}]}})
        if rng.random() < 0.3:
            bubbles.append({"confidenceScore": 3, "annotation": {"elements": [
                {"type": "polyline", "points": poly(cx, cy, r / 3)}]}})
    for ty in range(2, h // SIZE, 3):  # confidence 1, alone in the last tile column
        fat.append({"confidenceScore": 1, "annotation": {"elements": [
            {"type": "polyline", "points": poly(w - SIZE // 2, ty * SIZE + SIZE // 2, 120)}]}})
    return np.clip(img, 0, 255).astype(np.uint8), fat, bubbles


def write_build_root(root: Path, slides: dict) -> Path:
    """``Pseudocolored/<base>.png`` with ``Masks/{fat,bubbles}/<base>.json``;
    ``slides``: base -> (image, fat, bubbles) or an existing root to link from."""
    for sub in ("Pseudocolored", "Masks/fat", "Masks/bubbles"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for base, src in slides.items():
        if isinstance(src, Path):
            for rel in (f"Pseudocolored/{base}.png", f"Masks/fat/{base}.json",
                        f"Masks/bubbles/{base}.json"):
                (root / rel).symlink_to(src / rel)
            continue
        img, fat, bubbles = src
        cv2.imwrite(str(root / "Pseudocolored" / f"{base}.png"), img)
        (root / "Masks" / "fat" / f"{base}.json").write_text(json.dumps(fat))
        (root / "Masks" / "bubbles" / f"{base}.json").write_text(json.dumps(bubbles))
    return root


@contextlib.contextmanager
def recording(owner, name: str, calls: list):
    """Wrap ``owner.name`` so each call appends (its arguments, result,
    launches during it, host seconds) to ``calls``; the counts are not
    reset, so an enclosing count sees every launch."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        before = launches()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        after = launches()
        calls.append((args, out, {k: after[k] - before[k] for k in after},
                      time.perf_counter() - t0))
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def split_stems(root: Path) -> dict:
    """{split: sorted tile stems} of a build's dataset, images and masks paired."""
    out = {}
    for split_dir in sorted((root / "dataset").iterdir()):
        if not split_dir.is_dir():
            continue
        if (split_dir / "images").exists():
            imgs = sorted(p.stem for p in (split_dir / "images").glob("*.jpg"))
            masks = sorted(p.stem for p in (split_dir / "masks").glob("*.tif"))
            if imgs != masks:
                raise AssertionError(f"{split_dir}: images and masks not paired by stem")
            out[split_dir.name] = imgs
        else:
            out[split_dir.name] = sorted(str(p.relative_to(split_dir))
                                         for p in split_dir.rglob("*.jpg"))
    return out


def tile_amplification(slide_png: Path) -> dict[str, float]:
    """{tile stem: the largest ref_std / src_std over its L*a*b* channels},
    for the 1024^2 tiles of one slide: how much Reinhard scales the tile's
    rounding (on the CPU, from the source crop)."""
    from adipose_tpu_torch.data.tiling import tile_coords
    from adipose_tpu_torch.ops.stain import DEFAULT_REFERENCE, compute_lab_stats

    rgb = cv2.cvtColor(cv2.imread(str(slide_png)), cv2.COLOR_BGR2RGB)
    ref = np.array(DEFAULT_REFERENCE.std)
    return {f"{slide_png.stem}_r{r}_c{c}": float((ref / compute_lab_stats(
        torch.from_numpy(rgb[y:y + SIZE, x:x + SIZE]).to(torch.float32) / 255)[1].numpy()).max())
            for r, c, y, x in tile_coords(*rgb.shape[:2], SIZE, SIZE)}


def compare_builds(gpu: Path, cpu: Path, what: str, tiles: dict) -> int:
    """The same files, bit-equal masks, equal logs apart from the timestamp,
    byte-identical manifests; each written JPEG byte-identical to the
    quality-100 encoding of its device's tile array in ``tiles`` ({"card"
    / "cpu": {stem: gray}}, compared by :func:`qc_on_both`); returns the
    number of JPEGs."""
    files = sorted(str(p.relative_to(cpu)) for p in cpu.rglob("*") if p.is_file())
    got = sorted(str(p.relative_to(gpu)) for p in gpu.rglob("*") if p.is_file())
    if got != files:
        raise AssertionError(f"{what}: cuda and cpu builds wrote other files: "
                             f"{sorted(set(got) ^ set(files))[:10]}")
    n_jpeg = 0
    for f in files:
        a, b = gpu / f, cpu / f
        if f.endswith(".tif"):
            same = np.array_equal(cv2.imread(str(a), -1), cv2.imread(str(b), -1))
        elif f.endswith(".jpg"):
            n_jpeg += 1
            same = all(path.read_bytes() == cv2.imencode(
                ".jpg", tiles[key][Path(f).stem], [cv2.IMWRITE_JPEG_QUALITY, 100])[1].tobytes()
                for path, key in ((a, "card"), (b, "cpu")))
        elif f.endswith(".json"):
            la, lb = (json.loads(p.read_text()) for p in (a, b))
            la.pop("timestamp", None), lb.pop("timestamp", None)
            same = la == lb
        else:  # manifests, build_summary.txt
            same = a.read_bytes() == b.read_bytes()
        if not same:
            raise AssertionError(f"{what}: {f} differs between the cuda and cpu builds")
    return n_jpeg


def qc_on_both(slide_png: Path, dev, amp: dict) -> dict:
    """The builder's device work on one slide with stain on, on the card and
    on the CPU: the same verdicts; grayscale within BUILD_U8_LEVELS
    everywhere, in at most BUILD_U8_SHARE of the pixels of well-conditioned
    tiles and BUILD_ILL_SHARE of the others; returns the shares, the worst
    amplification and the largest relative Laplacian-variance gap."""
    from adipose_tpu_torch.core.config import DataBuildConfig
    from adipose_tpu_torch.data.tiling import SegmentationDatasetBuilder, tile_coords

    rgb = cv2.cvtColor(cv2.imread(str(slide_png)), cv2.COLOR_BGR2RGB)
    coords = tile_coords(rgb.shape[0], rgb.shape[1], SIZE, SIZE)
    cfg = DataBuildConfig(apply_stain_norm=True)
    (g_gpu, v_gpu), (g_cpu, v_cpu) = (
        SegmentationDatasetBuilder(cfg, build_root="unused", device=d)._rgb_qc(rgb, coords)
        for d in (dev, "cpu"))
    for k in ("is_empty", "is_blurry", "is_good"):
        if [bool(v[k]) for v in v_gpu] != [bool(v[k]) for v in v_cpu]:
            raise AssertionError(f"QC verdict {k} differs between the card and the CPU")
    d = np.abs(np.stack(g_gpu).astype(np.int16) - np.stack(g_cpu))
    ill = np.array([amp[f"{slide_png.stem}_r{r}_c{c}"] > BUILD_ILL_AMPLIFICATION
                    for r, c, _, _ in coords])
    shares = {k: float((d[sel] > 0).mean()) if sel.any() else 0.0
              for k, sel in (("well", ~ill), ("ill", ill), ("all", np.ones_like(ill)))}
    if d.max() > BUILD_U8_LEVELS or shares["well"] > BUILD_U8_SHARE or \
            shares["ill"] > BUILD_ILL_SHARE:
        raise AssertionError(f"stain-normalized gray, card vs CPU: {d.max()} levels, shares "
                             f"{shares} (bound {BUILD_U8_LEVELS} level in {BUILD_U8_SHARE}, "
                             f"{BUILD_ILL_SHARE} on tiles amplified over "
                             f"{BUILD_ILL_AMPLIFICATION}x)")
    lap = max(abs(float(a["laplacian_var"]) - float(b["laplacian_var"])) /
              max(float(b["laplacian_var"]), 1e-6) for a, b in zip(v_gpu, v_cpu))
    stems = [f"{slide_png.stem}_r{r}_c{c}" for r, c, _, _ in coords]
    return {"levels": int(d.max()), "shares": shares, "n_ill": int(ill.sum()),
            "n": len(coords), "worst_amp": max(amp.values()), "lap": lap,
            "tiles": {"card": dict(zip(stems, g_gpu)), "cpu": dict(zip(stems, g_cpu))}}


def phase_builds(dev, tmp: Path, seg_run: Path, cls_run: Path, smi: str) -> dict:
    """``adipose-torch build-dataset`` at its defaults, ``build-class-dataset
    --stain-normalize true``, ``build-test-dataset``, ``build-test-class-
    dataset``, ``reconstruct --use-tta``, ``classification-overlay`` from a
    ``classify`` CSV and ``run-pipeline``, each through cli.main.main on
    seeded slides at the chunk sizes; the card's builds against the same
    builds on the CPU; launches by path; timings."""
    import adipose_tpu_torch.data.tiling as tiling_module
    import adipose_tpu_torch.wsi.reconstruct as reconstruct_module
    from adipose_tpu_torch.eval.evaluator import PublicationEvaluator
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    slides = {f"slide{i}": build_slide(shape, rng) for i, shape in enumerate(BUILD_SLIDES)}
    data = write_build_root(tmp / "slides", slides)
    one = write_build_root(tmp / "one_slide", {"slide2": data})  # 3000 x 5000
    test_src = write_build_root(tmp / "test_src", {"slide1": data})  # 6144 x 4096
    four = write_build_root(tmp / "four", {**{b: data for b in slides},
                                           "slide3": build_slide(BUILD_SLIDES[2], rng)})
    del slides
    n_tiles = sum(math.ceil(h / SIZE) * math.ceil(w / SIZE) for h, w in BUILD_SLIDES)
    print(f"builds: {len(BUILD_SLIDES)} seeded RGB slides {BUILD_SLIDES} ({n_tiles} tiles of "
          f"{SIZE}^2) and a fourth, written in {time.perf_counter() - t0:.1f} s")
    paths: dict[str, dict[str, int]] = {}

    # build-dataset at every default, on the card; its device calls recorded
    qc_calls: list = []
    builds: list = []
    with recording(tiling_module, "_device_rgb_qc", qc_calls), \
            recording(tiling_module.SegmentationDatasetBuilder, "build", builds):
        reset_launches()
        cli.main(["build-dataset", "--data-root", str(data), "--output-root",
                  str(tmp / "build_gpu"), "--device", str(dev)])
    paths["build"] = launches()
    (args, root, _, build_wall), = builds
    builder = args[0]
    stats = json.loads((root / "build_log.json").read_text())["stats"]
    stems = split_stems(root)
    on_card = all(a[0].device == torch.device(dev) for a, *_ in qc_calls)
    want_chunks = sum(math.ceil(math.ceil(h / SIZE) * math.ceil(w / SIZE) / BUILD_QC_CHUNK)
                      for h, w in BUILD_SLIDES)
    qa = {c: len(list((root / "tiles" / c).glob("*.jpg"))) for c in ("empty", "blurry")}
    if not on_card or len(qc_calls) != want_chunks or any(paths["build"].values()) or \
            stats["tiles_total"] != n_tiles or not (root / "build_summary.txt").exists() or \
            not qa["blurry"] or not stems.get("train") or not stems.get("val") or \
            not builder.cfg.apply_stain_norm:
        raise AssertionError(f"build-dataset: on card {on_card}, {len(qc_calls)} device calls "
                             f"(want {want_chunks}), launches {paths['build']}, stats {stats}, "
                             f"QA {qa}, splits { {k: len(v) for k, v in stems.items()} }")
    timings = builder.timings
    print(f"build: adipose-torch build-dataset at its defaults (stain normalization on, "
          f"{SIZE}^2 tiles at stride {SIZE}, QC batch {BUILD_QC_CHUNK}, val 0.2, negatives 0.4) "
          f"over {len(BUILD_SLIDES)} slides: {stats['tiles_total']} tiles, kept "
          f"{stats['tiles_kept_pos']} positive + {stats['tiles_kept_neg']} negative, skipped "
          f"{stats['tiles_skipped_empty']} empty, {stats['tiles_skipped_blurry']} blurry, "
          f"{stats['tiles_skipped_ambiguous']} ambiguous, {stats['tiles_skipped_low_conf']} "
          f"low-confidence; splits { {k: len(v) for k, v in stems.items()} }; QA tiles {qa}; "
          f"{len(qc_calls)} device calls, all on the card; kernel launches {paths['build']}")
    print(f"timing build: {build_wall:.2f} s wall, by stage (host clock) "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}; "
          f"{stats['tiles_total'] / build_wall:.2f} tiles/s [{smi}]")

    # Reinhard runs before QC (the reference's order), so it lifts the
    # near-white band out of the white gate; without it the band is "empty"
    cli.main(["build-dataset", "--data-root", str(data), "--output-root",
              str(tmp / "build_nostain"), "--no-stain-normalize", "--device", str(dev)])
    (nostain_root,) = (tmp / "build_nostain").glob("_build_*")
    qa_nostain = {c: len(list((nostain_root / "tiles" / c).glob("*.jpg")))
                  for c in ("empty", "blurry")}
    if not qa_nostain["empty"] or not qa_nostain["blurry"]:
        raise AssertionError(f"build-dataset --no-stain-normalize: QA tiles {qa_nostain}")
    print(f"build: with --no-stain-normalize the QA tiles are {qa_nostain} (stain on: {qa}, "
          f"the normalized white band fails the blur gate instead)")

    # the same build on the CPU, over the 3000 x 5000 slide
    for label, d in (("card", dev), ("cpu", "cpu")):
        cli.main(["build-dataset", "--data-root", str(one), "--output-root",
                  str(tmp / f"one_{label}"), "--device", str(d)])
    (gpu_root,), (cpu_root,) = (list((tmp / f"one_{k}").glob("_build_*")) for k in ("card", "cpu"))
    amp = tile_amplification(one / "Pseudocolored" / "slide2.png")
    gray = qc_on_both(one / "Pseudocolored" / "slide2.png", dev, amp)
    n_jpeg = compare_builds(gpu_root, cpu_root, "build-dataset", gray["tiles"])
    sh = gray["shares"]
    print(f"build: the 3000x5000 slide's build on the card vs on the CPU: the same tile names "
          f"per split { {k: len(v) for k, v in split_stems(gpu_root).items()} }, bit-equal "
          f"masks, equal stats and logs; device work: equal verdicts, gray within "
          f"{gray['levels']} level, in {sh['all']:.3g} of all pixels: {sh['well']:.3g} on the "
          f"{gray['n'] - gray['n_ill']} well-conditioned tiles (bound {BUILD_U8_SHARE}), "
          f"{sh['ill']:.3g} on the {gray['n_ill']} amplified over {BUILD_ILL_AMPLIFICATION}x "
          f"(worst {gray['worst_amp']:.1f}x; bound {BUILD_ILL_SHARE}); Laplacian variance "
          f"within {gray['lap']:.2g} relative; each of the {n_jpeg} JPEGs of each build "
          f"byte-identical to the encoding of its device's tile")

    # the device work per chunk of 16 by CUDA events, and the idle share over
    # one slide's tiling
    slide_png = data / "Pseudocolored" / "slide0.png"
    rgb = cv2.cvtColor(cv2.imread(str(slide_png)), cv2.COLOR_BGR2RGB)
    chunk = torch.from_numpy(np.stack([
        rgb[y:y + SIZE, x:x + SIZE] for _, _, y, x in tiling_module.tile_coords(
            *rgb.shape[:2], SIZE, SIZE) if y >= SIZE][:BUILD_QC_CHUNK])).to(dev)
    ref_mean, ref_std = builder._stain_reference().as_arrays(dev)
    chunk_ms = cuda_ms(lambda c: tiling_module._device_rgb_qc(
        c, ref_mean, ref_std, 235, 0.7, 7.5, True), [chunk], 5)
    nostain_ms = cuda_ms(lambda c: tiling_module._device_rgb_qc(
        c, ref_mean, ref_std, 235, 0.7, 7.5, False), [chunk], 5)
    slide = tiling_module.discover_slides(data)[0]
    mask = builder.build_slide_mask(slide)
    builder.tile_slide(slide, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tiled = builder.tile_slide(slide, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    print(f"timing build device work: stain + QC + gray of a chunk of {BUILD_QC_CHUNK} RGB "
          f"{SIZE}^2 tiles {chunk_ms:.3f} ms ({nostain_ms:.3f} ms without stain) by CUDA "
          f"events; tiling one {BUILD_SLIDES[0][0]}x{BUILD_SLIDES[0][1]} slide ({len(tiled)} "
          f"tiles kept): {wall:.3f} s wall, device busy {busy:.3f} s "
          f"({100 * (1 - busy / wall):.1f}% idle) [{smi}]")
    del chunk, rgb, mask, tiled

    # build-class-dataset --stain-normalize true: all slides on the card, and
    # the 3000 x 5000 slide on the card and on the CPU
    cli.main(["build-class-dataset", "--data-root", str(data), "--out-parent",
              str(tmp / "class_gpu"), "--stain-normalize", "true", "--device", str(dev)])
    (class_root,) = (tmp / "class_gpu").glob("_build_class_*")
    report = json.loads((class_root / "balance_report.json").read_text())
    missing = [f for f in ("config.json", "balance_report.json", "dataset/train_manifest.csv",
                           "dataset/val_manifest.csv", "dataset/test_manifest.csv")
               if not (class_root / f).exists()]
    if missing or not report["adipose"] or not report["not_adipose"]:
        raise AssertionError(f"build-class-dataset: missing {missing}, report {report}")
    for label, d in (("card", dev), ("cpu", "cpu")):
        cli.main(["build-class-dataset", "--data-root", str(one), "--out-parent",
                  str(tmp / f"class_one_{label}"), "--stain-normalize", "true",
                  "--device", str(d)])
    (cg,), (cc,) = (list((tmp / f"class_one_{k}").glob("_build_class_*"))
                    for k in ("card", "cpu"))
    n_cjpeg = compare_builds(cg, cc, "build-class-dataset", gray["tiles"])
    print(f"build_class: adipose-torch build-class-dataset --stain-normalize true over "
          f"{len(BUILD_SLIDES)} slides: {report['adipose']} adipose + {report['not_adipose']} "
          f"not adipose ({report['balance_grade']}), splits {report['split_counts']}; the "
          f"3000x5000 slide on the card vs the CPU: byte-identical manifests, the same files, "
          f"each of the {n_cjpeg} JPEGs the encoding of its device's tile")

    # the isolated test sets over the 6144 x 4096 slide
    cli.main(["build-test-dataset", "--images-dir", str(test_src / "Pseudocolored"),
              "--masks-dir", str(test_src / "Masks"), "--output-dir", str(tmp / "test_gpu"),
              "--device", str(dev)])
    (test_root,) = (tmp / "test_gpu").glob("_build_*")
    tstats = json.loads((test_root / "build_log.json").read_text())["stats"]
    test_tiles = split_stems(test_root)["test"]
    slide_tiles = math.ceil(BUILD_SLIDES[1][0] / SIZE) * math.ceil(BUILD_SLIDES[1][1] / SIZE)
    # every tile stays but those whose annotations are all below confidence 2
    if len(test_tiles) != slide_tiles - tstats["tiles_skipped_low_conf"] or \
            tstats["tiles_skipped_empty"] or tstats["tiles_skipped_blurry"] or \
            tstats["tiles_skipped_ambiguous"]:
        raise AssertionError(f"build-test-dataset: {len(test_tiles)} test tiles, stats {tstats}")
    cli.main(["build-test-class-dataset", "--images-dir", str(test_src / "Pseudocolored"),
              "--masks-dir", str(test_src / "Masks"), "--output-dir", str(tmp / "test_class"),
              "--stain-normalize", "true", "--device", str(dev)])
    (tclass_root,) = (tmp / "test_class").glob("_build_class_*")
    tclass = split_stems(tclass_root)["test"]
    print(f"build_test: build-test-dataset over the 6144x4096 slide: {len(test_tiles)} of "
          f"{slide_tiles} tiles kept ({tstats['tiles_skipped_low_conf']} with only "
          f"low-confidence annotations dropped); build-test-class-dataset: {len(tclass)} tiles")

    # reconstruct --use-tta --tta-mode basic over the test set, then the same
    # under plain_kernels()
    recon_calls: list = []
    slide_calls: list = []
    rec_argv = ["reconstruct", "--weights", str(seg_run), "--images-dir",
                str(test_root / "dataset" / "test" / "images"), "--masks-dir",
                str(test_root / "dataset" / "test" / "masks"), "--use-tta", "--tta-mode",
                "basic", "--device", str(dev)]
    with recording(reconstruct_module, "reconstruct_all_slides", recon_calls):
        with recording(reconstruct_module.SlideReconstructor, "reconstruct_slide",
                       slide_calls):
            cli.main(rec_argv + ["--output-dir", str(tmp / "recon")])
        with plain_kernels():
            cli.main(rec_argv + ["--output-dir", str(tmp / "recon_plain")])
    (_, log, counts, rec_wall), (_, _, plain_counts, plain_wall) = recon_calls
    paths["reconstruct"] = counts
    predicts = math.ceil(len(test_tiles) / (16 // len(MODE_IDS["basic"])))
    if counts != tta_counts(predicts) or any(plain_counts.values()) or \
            list(log["slides"]) != ["slide1"]:
        raise AssertionError(f"reconstruct: launches {counts} (want {tta_counts(predicts)}), "
                             f"plain {plain_counts}, log {log}")
    pred, pred_plain = (cv2.imread(str(d / "slide1" / "prediction.png"), -1).astype(np.int16)
                        for d in (tmp / "recon", tmp / "recon_plain"))
    rec_gap = int(np.abs(pred - pred_plain).max())
    metrics = json.loads((tmp / "recon" / "slide1" / "metrics.json").read_text())
    if pred.shape != BUILD_SLIDES[1] or rec_gap > 1 or not math.isfinite(metrics["dice_score"]):
        raise AssertionError(f"reconstruct: map {pred.shape}, kernels vs plain {rec_gap} "
                             f"levels, metrics {metrics}")
    print(f"reconstruct: adipose-torch reconstruct --use-tta --tta-mode basic (batch 16 = 4 "
          f"tiles x 4 views) with the slice's init_nb {INIT_NB} run over the test set "
          f"({len(test_tiles)} tiles, coverage {log['slides']['slide1']['coverage']:.3f}): a "
          f"{pred.shape[0]}x{pred.shape[1]} map, dice {metrics['dice_score']:.4f}; launches "
          f"{counts} ({predicts} predicts: A 1, B 1, D 2 each); under plain_kernels() nothing "
          f"launched, prediction.png within {rec_gap} level of the kernels' (bound 1)")
    print(f"timing reconstruct: per slide {[round(c[3], 3) for c in slide_calls]} s (decode, "
          f"predict, three blends and their copies; host clock), the call {rec_wall:.2f} s; "
          f"with the plain versions {plain_wall:.2f} s [{smi}]")

    # classification-overlay from a classify CSV over the class test set's tiles
    reset_launches()
    cli.main(["classify", "--weights", str(cls_run), "--input-dir",
              str(tclass_root / "dataset" / "test"), "--output-dir", str(tmp / "cls_test"),
              "--device", str(dev)])
    csv_path = tmp / "cls_test" / "predictions_grayscale.csv"
    cli.main(["classification-overlay", "--wsi", str(test_src / "Pseudocolored" / "slide1.png"),
              "--predictions-csv", str(csv_path), "--output-dir", str(tmp / "overlay")])
    ov = cv2.imread(str(tmp / "overlay" / "slide1_overlay.png"))
    want_shape = (BUILD_SLIDES[1][0] // 8, BUILD_SLIDES[1][1] // 8, 3)
    if ov is None or ov.shape != want_shape or len(read_csv_rows(csv_path)) != len(tclass):
        raise AssertionError(f"classification-overlay: {None if ov is None else ov.shape}")
    print(f"overlay: classify at its defaults over the {len(tclass)} class test tiles, then "
          f"classification-overlay (combine 3, downsample 8): a {ov.shape[1]}x{ov.shape[0]} "
          f"overlay")

    # run-pipeline at its defaults, epochs cut to 1 + 1, on four slides
    trains, evals = [], []
    with recording(UNetTrainer, "train", trains), \
            recording(PublicationEvaluator, "evaluate", evals), \
            recording(tiling_module.SegmentationDatasetBuilder, "build", builds), \
            contextlib.chdir(tmp):
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["run-pipeline", "--data-root", str(four), "--epochs-phase1", "1",
                      "--epochs-phase2", "1", "--device", str(dev)])
        rp_wall = time.perf_counter() - t0
    text = out.getvalue()
    summary = json.loads(text[text.rindex('{\n  "checkpoint_dir"'):])
    rp_root = builds[-1][1]
    n = {s: len(v) for s, v in split_stems(rp_root).items()}
    steps = 2 * math.ceil(n["train"] / TRAIN_BATCH)
    stage = {"build": builds[-1][2], "train": trains[0][2], "val_eval": evals[0][2],
             "test_eval": evals[1][2]}
    want = {"build": {k: 0 for k in KERNELS},
            "train": {k: 0 for k in KERNELS} | {"d4_transform_batch": 2 * steps},
            "val_eval": {k: 0 for k in KERNELS} | {
                "fused_zscore_normalize": math.ceil(n["val"] / RUN_PIPELINE_EVAL_BATCH),
                "diff_sigmoid_head": math.ceil(n["val"] / RUN_PIPELINE_EVAL_BATCH)},
            "test_eval": {k: 0 for k in KERNELS} | {
                "fused_zscore_normalize": math.ceil(n["test"] / RUN_PIPELINE_EVAL_BATCH),
                "diff_sigmoid_head": math.ceil(n["test"] / RUN_PIPELINE_EVAL_BATCH)}}
    if stage != want or set(summary["timings"]) != {"build_s", "train_s", "val_eval_s",
                                                     "test_eval_s"} or \
            not all(math.isfinite(summary[k]) for k in ("val_dice", "test_dice")):
        raise AssertionError(f"run-pipeline: launches by stage {stage}, want {want}; "
                             f"summary {summary}")
    paths["run_pipeline"] = {k: sum(s[k] for s in stage.values()) for k in KERNELS}
    print(f"run_pipeline: adipose-torch run-pipeline at its defaults (init_nb {INIT_NB}, "
          f"{SIZE}^2, batch {TRAIN_BATCH}, z-score, val/test 0.15, stain off), 1 + 1 epochs, "
          f"on 4 slides: splits {n}, val dice {summary['val_dice']:.4f}, test dice "
          f"{summary['test_dice']:.4f}, threshold {summary['optimal_threshold']:.2f}; launches "
          f"by stage {json.dumps({k: {n_: c for n_, c in v.items() if c} for k, v in stage.items()})}")
    print(f"timing run_pipeline: {json.dumps({k: round(v, 2) for k, v in summary['timings'].items()})} "
          f"s by stage, {rp_wall:.2f} s in all [{smi}]")
    return paths


# Phase 9e: the WSI preparation tools. A 16-bit slide over the 13112 px gate
# (151 M pixels: under PIL's 2 x 89,478,485-pixel limit, which the header
# read keeps) and one under it; the chunker cuts the large one into 6 chunks.
WSI_SLIDE = (9216, 16384)  # (H, W)
WSI_SMALL = (4096, 4096)
WSI_TAIL = (12288, 6144, 4096, 3072)  # (x, y, w, h) of the last chunk
# ECM stage stacks, as a user sets them; the rolling ball is cut from its
# default radius 100 to 25 so that the stack's run on the CPU stays short.
ECM_STACKS = {
    "fft_percentile_rolling_clahe_sharpen": [
        "--deband", "fft", "--normalization-method", "percentile", "--illumination",
        "rolling_ball", "--rolling-ball-radius", "25", "--clahe", "--sharpen"],
    "morphological_zscore_tophat": ["--deband", "morphological", "--normalization-method",
                                    "zscore", "--illumination", "tophat"],
    "column_norm_gaussian": ["--deband", "column_norm", "--illumination", "gaussian"],
    "clahe_visualize_test_mode": ["--illumination", "clahe", "--visualize", "--test-mode",
                                  "--test-samples", "2"],
}
# The card against the CPU, uint8 after truncation. Means and the FFT sum in
# other orders on the two devices, so a pixel on a level boundary moves by
# one level (CLAHE's sums are exact on both). CLAHE after a float stage bins
# by truncation: a pixel 1e-5 from an integer may take the next bin, which
# maps it one step of the clipped CDF higher, at most 255 x (clip + excess)
# / tile pixels = 255 x 4 / 256 levels at clip 3, and the sharpening after
# it scales a one-pixel step by 1 + 0.5 x (1 - 0.16): at most 6 levels; only
# pixels that close to an integer move.
WSI_U8_LEVELS, WSI_U8_SHARE = 1, 1e-3
WSI_STACK_LEVELS, WSI_STACK_SHARE = 6, 1e-3
# The blur's 1201 taps at sigma 150 in float32, summed in other orders:
# ~1e-6 relative; TF32 inputs would be ~1e-3 relative, tenths of a level.
WSI_BLUR_ATOL = 1e-2
WSI_SSIM_ATOL = 1e-5
WSI_METRIC_RTOL = 1e-5
WSI_TILE = 1024  # compare-modalities compares tiles
# --mode grid: 2048 px tiles at stride 1844 make a 9 x 5 grid, grouped 5 x 5
# into 2 pieces; (H, W) of each
WSI_GRID_PIECES = {"slide_grid_5x5_tile_0.jpg": (9216, 9424),
                   "slide_grid_5x5_tile_1.jpg": (7580, 7580)}


@contextlib.contextmanager
def pytorch_tf32_default():
    """PyTorch's own TF32 default (cuDNN convolutions may use TF32, matmuls
    not) within the block; the script's setting restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def wsi_slide(shape: tuple[int, int], dev, g) -> np.ndarray:
    """A seeded 16-bit grayscale slide made on the card: tissue-like texture
    (coarse and fine noise, interpolated), vertical banding (a 37 px period)
    and noise, in 900..41000."""
    h, w = shape
    interp = torch.nn.functional.interpolate
    coarse = torch.rand((1, 1, h // 256 + 2, w // 256 + 2), device=dev, generator=g)
    coarse = interp(coarse, size=(h, w), mode="bicubic")[0, 0].clamp(0, 1)
    fine = interp(torch.rand((1, 1, h // 4, w // 4), device=dev, generator=g), size=(h, w),
                  mode="bilinear")[0, 0]
    band = 2500.0 * torch.sin(torch.arange(w, device=dev) * (2 * math.pi / 37.0))
    img = (3000.0 + 30000.0 * coarse * (0.6 + fine) + band
           + 400.0 * torch.randn((h, w), device=dev, generator=g))
    return img.clamp(900, 41000).to(torch.int32).cpu().numpy().astype(np.uint16)


def u8_gap(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    """(largest level gap, share of pixels that differ)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def run_cli(argv: list[str]) -> tuple[str, float, int]:
    """``cli.main(argv)``: (its standard output, host seconds, the peak
    device memory it allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before


def image_size(path: Path) -> tuple[int, int]:
    """(H, W) from the header."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size[1], im.size[0]


def phase_wsi_tools(dev, tmp: Path, smi: str) -> dict:
    """``adipose-torch chunk-wsi`` (at its defaults; clahe with
    --save-enhanced, percentile, zscore; --mode grid), ``preprocess-ecm``
    with four stage stacks, ``tif2jpg --invert``, ``scale-ecm`` and
    ``compare-modalities`` (stratified; --n-perfect/--n-mismatch) through
    cli.main.main under PyTorch's TF32 default; the card against the CPU on
    the tail chunk; no kernel launched; every device tool allocates on the
    card; timings."""
    import warnings

    from PIL import Image

    with pytorch_tf32_default(), warnings.catch_warnings():
        warnings.simplefilter("ignore", Image.DecompressionBombWarning)  # 151 M px is meant
        return _phase_wsi_tools(dev, tmp, smi)


def ecm_stack_config(flags: list[str]):
    """The ECMPreprocessConfig that ``preprocess-ecm`` builds from ``flags``."""
    return cli.ecm_config(cli.build_parser().parse_args(
        ["preprocess-ecm", "--input-dir", "-", "--output-dir", "-", *flags]))


def _phase_wsi_tools(dev, tmp: Path, smi: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from adipose_tpu_torch.ops.clahe import _clahe_any_shape
    from adipose_tpu_torch.ops.fftops import gaussian_blur
    from adipose_tpu_torch.wsi import chunker, compare, ecm

    t_phase = time.perf_counter()
    root = tmp / "wsi_tools"
    slides = root / "slides"
    slides.mkdir(parents=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    t0 = time.perf_counter()
    big = wsi_slide(WSI_SLIDE, dev, g)
    none = [cv2.IMWRITE_TIFF_COMPRESSION, 1]
    cv2.imwrite(str(slides / "slide.tif"), big, none)
    cv2.imwrite(str(slides / "small.tif"), wsi_slide(WSI_SMALL, dev, g), none)
    print(f"wsi tools: a seeded 16-bit {WSI_SLIDE[1]}x{WSI_SLIDE[0]} slide "
          f"({big.size / 1e6:.1f} M px) and a {WSI_SMALL[1]}x{WSI_SMALL[0]} one, written in "
          f"{time.perf_counter() - t0:.1f} s")
    gray = chunker.convert_16_to_8bit(big)
    # --bit-depth 16 keeps the slide's depth: a 16-bit chunk goes up as it is
    crop16 = np.ascontiguousarray(big[:1024, :1024])
    gap16 = u8_gap(chunker.enhance(crop16, "zscore", dev),
                   chunker.enhance(crop16, "zscore", "cpu"))
    if gap16[0] > WSI_U8_LEVELS or gap16[1] > WSI_U8_SHARE:
        raise AssertionError(f"enhance zscore of a 16-bit crop, card vs CPU: {gap16}")
    del big
    x, y, w, h = WSI_TAIL
    tail = np.ascontiguousarray(gray[y:y + h, x:x + w])
    walls: dict[str, float] = {}
    reset_launches()

    # chunk-wsi at its defaults: 6 chunks named from generate_axis_segments
    chunks = root / "chunks"
    out, walls["chunk-wsi"], _ = run_cli(["chunk-wsi", "--input-dir", str(slides),
                                          "--output-dir", str(chunks), "--device", str(dev)])
    want = {f"slide_x{cx}_y{cy}_w{cw}_h{ch}.jpg": (ch, cw)
            for cy, ch in chunker.generate_axis_segments(WSI_SLIDE[0])
            for cx, cw in chunker.generate_axis_segments(WSI_SLIDE[1])}
    names = sorted(want)
    report = json.loads(out)
    got = {p.name: image_size(p) for p in chunks.glob("*.jpg")}
    if got != want or len(want) != 6 or \
            report != {"processed": 1, "skipped": 1, "outputs": 6, "dry_run": False}:
        raise AssertionError(f"chunk-wsi: {report}, {got}")
    tail_name = f"slide_x{x}_y{y}_w{w}_h{h}.jpg"
    print(f"chunk_wsi: adipose-torch chunk-wsi --input-dir at its defaults: {names}; "
          f"small.tif skipped as small; {walls['chunk-wsi']:.2f} s")

    # the enhancements on the card, each chunk's file the JPEG of the card's
    # array, and the tail chunk on the card against the CPU
    enhanced = {}
    for method, extra in (("clahe", ["--save-enhanced"]), ("percentile", []), ("zscore", [])):
        dst = root / f"chunks_{method}"
        _, walls[f"chunk-wsi {method}"], peak = run_cli(
            ["chunk-wsi", "--input-dir", str(slides), "--output-dir", str(dst),
             "--enhancement", method, *extra, "--device", str(dev)])
        got = sorted(p.name for p in dst.glob("*.jpg"))
        if got != names or peak <= 0 or (extra and sorted(
                p.name for p in (dst / "enhanced").glob("*.jpg")) != names):
            raise AssertionError(f"chunk-wsi --enhancement {method}: {got}, peak {peak}")
        card = chunker.enhance(tail, method, dev)
        want = cv2.imencode(".jpg", card, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
        if (dst / tail_name).read_bytes() != want:
            raise AssertionError(f"chunk-wsi --enhancement {method}: the tail chunk's file is "
                                 f"not the card's array")
        enhanced[method] = u8_gap(card, chunker.enhance(tail, method, "cpu"))
        if enhanced[method][0] > WSI_U8_LEVELS or enhanced[method][1] > WSI_U8_SHARE:
            raise AssertionError(f"enhance {method}, card vs CPU: {enhanced[method]} (bound "
                                 f"{WSI_U8_LEVELS} level in {WSI_U8_SHARE})")
        shutil.rmtree(dst)
    print("chunk_wsi enhancements: clahe --save-enhanced, percentile, zscore on the 6 chunks; "
          "the tail chunk card vs CPU (levels, share of pixels): "
          + ", ".join(f"{m} {v[0]} in {v[1]:.2e}" for m, v in enhanced.items())
          + f", zscore of a 16-bit 1024^2 crop {gap16[0]} in {gap16[1]:.2e} (bound "
          f"{WSI_U8_LEVELS} level in {WSI_U8_SHARE}, TF32 at PyTorch's default)")

    # --mode grid: 2048 px tiles at stride 1844 -> 9 x 5, grouped 5 x 5 in 2 pieces
    grid = root / "grid"
    _, walls["chunk-wsi grid"], _ = run_cli(["chunk-wsi", "--input-dir", str(slides),
                                             "--output-dir", str(grid), "--mode", "grid",
                                             "--device", str(dev)])
    pieces = {p.name: image_size(p) for p in grid.glob("*.jpg")}
    if pieces != WSI_GRID_PIECES:
        raise AssertionError(f"chunk-wsi --mode grid: {pieces}")
    shutil.rmtree(grid)

    # preprocess-ecm over the chunks with four stage stacks; the idle share
    # over the first run
    ecm_out = {}
    for i, (stack, flags) in enumerate(ECM_STACKS.items()):
        dst = root / f"ecm_{i}"
        argv = ["preprocess-ecm", "--input-dir", str(chunks), "--output-dir", str(dst), *flags,
                "--device", str(dev)]
        if i == 0:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, walls[f"preprocess-ecm {stack}"], peak = run_cli(argv)
            busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
            ecm_idle = (busy, 1 - busy / walls[f"preprocess-ecm {stack}"])
        else:
            _, walls[f"preprocess-ecm {stack}"], peak = run_cli(argv)
        log = json.loads((dst / "processing_log.json").read_text())
        n_want = 3 if "--test-mode" in flags else 6
        n_vis = len(list((dst / "visualizations").glob("*")))
        if len(log["processed"]) != n_want or log["errors"] or peak <= 0 or \
                ("--visualize" in flags and n_vis != n_want):
            raise AssertionError(f"preprocess-ecm {stack}: {log['processed']}, {log['errors']}, "
                                 f"peak {peak}")
        ecm_out[stack] = dst

    # the first stack on the card and on the CPU over the tail chunk's JPEG
    stack0 = next(iter(ECM_STACKS))
    cfg0 = ecm_stack_config(ECM_STACKS[stack0])
    tail_jpg = cv2.imread(str(chunks / tail_name), cv2.IMREAD_GRAYSCALE)
    card = ecm.preprocess_ecm_image(tail_jpg, cfg0, dev)
    if (ecm_out[stack0] / tail_name).read_bytes() != cv2.imencode(
            ".jpg", card, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes():
        raise AssertionError("preprocess-ecm: the tail chunk's file is not the card's array")
    t0 = time.perf_counter()
    stack_gap = u8_gap(card, ecm.preprocess_ecm_image(tail_jpg, cfg0, "cpu"))
    cpu_s = time.perf_counter() - t0
    if stack_gap[0] > WSI_STACK_LEVELS or stack_gap[1] > WSI_STACK_SHARE:
        raise AssertionError(f"preprocess-ecm {stack0}, card vs CPU: {stack_gap} (bound "
                             f"{WSI_STACK_LEVELS} levels in {WSI_STACK_SHARE})")
    # the sigma-150 blur in full float32 under PyTorch's TF32 default
    crop = torch.from_numpy(tail_jpg[:1024, :1024]).to(torch.float32)
    blur_gap = float((gaussian_blur(crop.to(dev), 150.0).cpu() - gaussian_blur(crop, 150.0))
                     .abs().max())
    if blur_gap > WSI_BLUR_ATOL:
        raise AssertionError(f"gaussian_blur sigma 150, card vs CPU: {blur_gap}")
    print(f"preprocess_ecm: {len(ECM_STACKS)} stacks over the 6 chunks "
          f"({', '.join(ECM_STACKS)}), no errors; {stack0} on the tail chunk card vs CPU: "
          f"{stack_gap[0]} levels in {stack_gap[1]:.2e} of the pixels (bound "
          f"{WSI_STACK_LEVELS} in {WSI_STACK_SHARE}; the CPU took {cpu_s:.1f} s); the sigma-150 "
          f"blur of a 1024^2 crop card vs CPU {blur_gap:.2e} (TF32 at PyTorch's default)")

    # tif2jpg --invert over the slides
    jpgs = root / "tif2jpg"
    out, walls["tif2jpg"], _ = run_cli(["tif2jpg", "--input-dir", str(slides), "--output-dir",
                                        str(jpgs), "--invert"])
    inv = cv2.imread(str(jpgs / "small.jpg"))
    if out.strip() != "converted 2 images" or inv is None or inv.shape != (*WSI_SMALL, 3) or \
            image_size(jpgs / "slide.jpg") != WSI_SLIDE:
        raise AssertionError(f"tif2jpg: {out!r}")
    shutil.rmtree(jpgs)

    # scale-ecm from half-size copies back to the chunk dimensions
    half, scaled = root / "half", root / "scaled"
    half.mkdir()
    for name in names:
        im = cv2.imread(str(chunks / name), cv2.IMREAD_GRAYSCALE)
        cv2.imwrite(str(half / name), cv2.resize(im, (im.shape[1] // 2, im.shape[0] // 2),
                                                 interpolation=cv2.INTER_AREA))
    out, walls["scale-ecm"], _ = run_cli(["scale-ecm", "--target-dir", str(half),
                                          "--reference-dir", str(chunks), "--output-dir",
                                          str(scaled)])
    if out.strip() != "rescaled 6 images" or any(
            image_size(scaled / n) != image_size(chunks / n) for n in names):
        raise AssertionError(f"scale-ecm: {out!r}")
    shutil.rmtree(scaled)

    # compare-modalities over 1024^2 tiles of the tail chunk: its chunk
    # against its first stack's ECM output, 4 of the 12 ECM tiles at half size
    pseudo, ecm_tiles = root / "pseudo", root / "ecm_tiles"
    pseudo.mkdir()
    ecm_tiles.mkdir()
    ecm_img = cv2.imread(str(ecm_out[stack0] / tail_name), cv2.IMREAD_GRAYSCALE)
    tiles = [(r, c) for r in range(h // WSI_TILE) for c in range(w // WSI_TILE)]
    for k, (r, c) in enumerate(tiles):
        sl = np.s_[r * WSI_TILE:(r + 1) * WSI_TILE, c * WSI_TILE:(c + 1) * WSI_TILE]
        cv2.imwrite(str(pseudo / f"t_r{r}_c{c}.png"), tail_jpg[sl])
        e = ecm_img[sl]
        cv2.imwrite(str(ecm_tiles / f"t_r{r}_c{c}.jpg"),
                    cv2.resize(e, (WSI_TILE // 2, WSI_TILE // 2)) if k % 3 == 0 else e)
    rows = {}
    for label, extra in (("stratified", []),
                         ("sampled", ["--n-perfect", "3", "--n-mismatch", "2"])):
        dst = root / f"compare_{label}"
        _, walls[f"compare-modalities {label}"], peak = run_cli(
            ["compare-modalities", "--pseudo-dir", str(pseudo), "--ecm-dir", str(ecm_tiles),
             "--output-dir", str(dst), *extra, "--device", str(dev)])
        rows[label] = read_csv_rows(dst / "comparison_metrics.csv")
        n_want = len(tiles) if label == "stratified" else 5
        if len(rows[label]) != n_want or peak <= 0 or len(list(dst.glob("*_comparison.jpg"))) \
                != n_want or not all(math.isfinite(float(v)) for r in rows[label]
                                     for k, v in r.items() if k != "tile"):
            raise AssertionError(f"compare-modalities {label}: {rows[label]}")
    # one mismatched pair's metrics: the CSV's are the card's, and the card's
    # against the CPU's
    stem = "t_r0_c0"
    a = cv2.imread(str(pseudo / f"{stem}.png"), cv2.IMREAD_GRAYSCALE)
    b = cv2.imread(str(ecm_tiles / f"{stem}.jpg"), cv2.IMREAD_GRAYSCALE)
    m_card, m_cpu = compare.compute_metrics(a, b, dev), compare.compute_metrics(a, b, "cpu")
    logged = next(r for r in rows["stratified"] if r["tile"] == stem)
    gaps = {k: abs(m_card[k] - m_cpu[k]) for k in m_card}
    if any(abs(float(logged[k]) - v) > 1e-9 * max(1.0, abs(v)) for k, v in m_card.items()) or \
            gaps["ssim"] > WSI_SSIM_ATOL or \
            gaps["mse"] > WSI_METRIC_RTOL * m_cpu["mse"] or \
            gaps["histogram_correlation"] > WSI_METRIC_RTOL * abs(m_cpu["histogram_correlation"]):
        raise AssertionError(f"compare-modalities {stem}: csv {logged}, card {m_card}, "
                             f"cpu {m_cpu}")
    print(f"compare_modalities: stratified {len(rows['stratified'])} pairs, --n-perfect 3 "
          f"--n-mismatch 2 {len(rows['sampled'])} pairs ({[r['tile'] for r in rows['sampled']]}); "
          f"{stem} (ECM at half size) card vs CPU: mse {gaps['mse']:.2e}, ssim "
          f"{gaps['ssim']:.2e}, histogram correlation {gaps['histogram_correlation']:.2e}; "
          f"tif2jpg --invert and scale-ecm (half size -> chunk size) host-only")
    if any(launches().values()):
        raise AssertionError(f"the WSI tools launched a kernel: {launches()}")

    # device ms per chunk of each stack and of CLAHE at 6144^2, by CUDA events
    chunk0 = cv2.imread(str(chunks / names[0]), cv2.IMREAD_GRAYSCALE)
    x0 = torch.from_numpy(chunk0).to(dev).to(torch.float32)
    stack_ms = {k: cuda_ms(lambda t, c=ecm_stack_config(f): ecm.ecm_stages(t, c), [x0], 2)
                for k, f in ECM_STACKS.items()}
    clahe_ms = cuda_ms(lambda t: _clahe_any_shape(t, 2.0, 8), [x0], 5)
    del x0
    rounded = {k: round(v, 3) for k, v in walls.items()}
    print(f"timing wsi tools (host clock, s): {json.dumps(rounded)} [{smi}]")
    print(f"timing preprocess-ecm device ms per {chunk0.shape[1]}x{chunk0.shape[0]} chunk "
          f"(CUDA events): {json.dumps({k: round(v, 2) for k, v in stack_ms.items()})}; "
          f"chunk-wsi's CLAHE (clip 2, 8 x 8) {clahe_ms:.2f} ms [{smi}]")
    print(f"timing preprocess-ecm {stack0} over the 6 chunks: "
          f"{walls['preprocess-ecm ' + stack0]:.3f} s wall under the profiler, device busy "
          f"{ecm_idle[0]:.3f} s ({100 * ecm_idle[1]:.1f}% idle); phase 9e "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    shutil.rmtree(root)
    return {"wsi_tools": launches()}


def phase_cls_timing(dev, g, cls: dict, smi: str) -> dict:
    """The classifier's train step in each phase, with and without
    ``augment_low_res``, and the prep alone, by CUDA events over distinct
    device batches; peak memory; P and D at the path's shapes beside their
    bounds; the device's idle share over one phase-2 epoch."""
    from torch.profiler import ProfilerActivity, profile

    trainer, start = cls["trainer"], cls["start"]
    model = trainer.model
    batches = [(torch.randint(0, 256, (CLS_BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev,
                              generator=g),
                (torch.rand(CLS_BATCH, device=dev, generator=g) > 0.5).to(torch.float32))
               for _ in range(3)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    class_w = torch.ones(2, device=dev)
    out = {}
    for low_res in (False, True):
        prep = _make_preprocess_step(True, 1.0, 99.0, low_res)
        size = INCEPTION_SIZE if low_res else SIZE
        draw = lambda: draw_tier(gen, "classification", CLS_BATCH, size, size)  # noqa: E731
        prep_ms = cuda_ms(lambda b: prep(b[0], draw()), batches, 6)
        for phase, unfreeze_from in ((1, None), (2, "mixed7")):
            trainer._load(start)
            params = dict(model.named_parameters())
            mask = backbone_param_mask(params, unfreeze_from)
            state = TrainState.create(params, "adam", 1e-4, 0.01, mask)
            step = _make_cls_step(model, 0.1, classifier_stats_mask(
                dict(model.named_buffers()), mask), frozen_conv_boundary(unfreeze_from))
            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_ms(lambda b: step(state, prep(b[0], draw()), b[1], class_w, gen),
                              batches, 6)
            peak = torch.cuda.max_memory_allocated() / 1e9
            out[(low_res, phase)] = (step_ms, prep_ms, peak)
            print(f"timing classifier train step, phase {phase}"
                  f"{', augment-low-res' if low_res else ''}, batch {CLS_BATCH} of {SIZE}^2 "
                  f"u8: {step_ms:.2f} ms incl. prep = {CLS_BATCH * 1000.0 / step_ms:.2f} tiles/s; "
                  f"prep alone (P, draws, D and the classification stage, resize) "
                  f"{prep_ms:.2f} ms; peak memory {peak:.2f} GB (CUDA events, InceptionV3 "
                  f"bf16 with f32 BatchNorm) [{smi}]")
            if not low_res:  # the step's device work against its time
                acts = device_activities(
                    lambda b: step(state, prep(b[0], draw()), b[1], class_w, gen), batches, 3)
                dev_ms = sum(ms for ms, _, _ in acts.values())
                n_acts = sum(per_call for _, per_call, _ in acts.values())
                top = sorted(acts.items(), key=lambda kv: -kv[1][0])[:6]
                print(f"  phase {phase} step under torch.profiler: {dev_ms:.2f} ms of device "
                      f"time in {n_acts} device activities a step ({step_ms:.2f} ms by events: "
                      f"{100 * (1 - dev_ms / step_ms):.1f}% idle); top ms a step: "
                      + "; ".join(f"{k[:60]} {ms:.3f} ({n})" for k, (ms, n, _) in top))

    # P and D at the classifier's shapes.
    u8 = [b[0] for b in batches]
    n = CLS_BATCH * SIZE * SIZE
    p_ms, p_plain = in_turns(percentile_normalize_u8_plain, percentile_normalize_u8, u8, 20)
    p_dev = profiled_ms(percentile_normalize_u8, u8, 20,
                        ("hist_kernel", "percentile_kernel", "apply_kernel", "emset"))
    p_bound = bound(n * 5, 6 * n)
    print(f"timing percentile_normalize_u8 ({CLS_BATCH},{SIZE},{SIZE}) u8 -> f32: kernel "
          f"{p_ms:.4f} ms, plain {p_plain:.4f} ms by CUDA events; device time {p_dev} ms per "
          f"call by torch.profiler; bound {p_bound[0]:.4f} ms [{smi}]")
    d_times = {}
    for side in (SIZE, INCEPTION_SIZE):
        d_in = [(torch.rand((CLS_BATCH, side, side), device=dev, generator=g),
                 torch.randint(0, 8, (CLS_BATCH,), device=dev, generator=g, dtype=torch.int32))
                for _ in range(3 if side == SIZE else 8)]
        d_ms, d_plain = in_turns(lambda a: d4_transform_batch_plain(*a),
                                 lambda a: d4_transform_batch(*a), d_in, 20)
        d_dev = profiled_ms(lambda a: d4_transform_batch(*a), d_in, 20, ("d4_kernel",))
        d_bound = bound(2 * CLS_BATCH * side * side * 4 + CLS_BATCH * 4, 0)
        d_times[side] = (d_ms, d_plain, d_dev, d_bound)
        print(f"timing d4_transform_batch ({CLS_BATCH},{side},{side}) f32: kernel {d_ms:.4f} "
              f"ms, plain {d_plain:.4f} ms by CUDA events; device time {d_dev} ms per call by "
              f"torch.profiler; bound {d_bound[0]:.4f} ms [{smi}]")
        del d_in
    del batches, u8

    trainer._run_phase(2, start, 1, 1e-4, "mixed7")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_phase(2, start, 1, 1e-4, "mixed7")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((device_us(e) / 1e6, e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(t for t, _ in kernels)
    idle = 1 - busy / wall
    print(f"timing classifier epoch (phase 2, {trainer.train_data.steps_per_epoch} steps of "
          f"{CLS_BATCH} + {trainer.val_data.steps_per_epoch} val batch, JPEG decode and the "
          f"weights_best write incl.): {wall:.3f} s wall under the profiler, device busy "
          f"{busy:.3f} s ({100 * idle:.1f}% idle) [{smi}]")
    print("  top device activities (s): " + "; ".join(
        f"{name[:60]} {t:.4f}" for t, name in kernels[:10]))
    return {"steps": out, "idle": idle, "p": (p_ms, p_plain, p_dev, p_bound), "d": d_times}


def phase_kernel_timing(dev, g, smi: str) -> dict:
    tiles = [torch.randint(0, 256, (BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev,
                           generator=g) for _ in range(4)]  # 64 MB: more than L2
    zscore = lambda t: fused_zscore_normalize(t, TRAIN_MEAN_DEFAULT,  # noqa: E731
                                              TRAIN_STD_DEFAULT, out_dtype=torch.bfloat16)
    a_ms, a_plain = in_turns(
        lambda t: fused_zscore_normalize_plain(t, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT,
                                               out_dtype=torch.bfloat16),
        zscore, tiles, 20)
    a_dev = profiled_ms(zscore, tiles, 20, ("zscore_kernel", "zscore_finalize", "emset"))
    print(f"timing fused_zscore_normalize ({BATCH},{SIZE},{SIZE}) u8 -> bf16: "
          f"kernel {a_ms:.4f} ms, plain {a_plain:.4f} ms by CUDA events; device time "
          f"{a_dev} ms per call by torch.profiler [{smi}]")
    p_ms, p_plain = in_turns(percentile_normalize_u8_plain, percentile_normalize_u8, tiles, 20)
    p_dev = profiled_ms(percentile_normalize_u8, tiles, 20,
                        ("hist_kernel", "percentile_kernel", "apply_kernel", "emset"))
    background = [t.clone() for t in tiles]
    for t in background:
        t[torch.rand(t.shape, device=dev, generator=g) < 0.7] = 240
    p_bg = cuda_ms(percentile_normalize_u8, background, 20)
    p_bg_dev = profiled_ms(percentile_normalize_u8, background, 20,
                           ("hist_kernel", "percentile_kernel", "apply_kernel", "emset"))
    print(f"timing percentile_normalize_u8 ({BATCH},{SIZE},{SIZE}) u8 -> f32: kernel "
          f"{p_ms:.4f} ms, plain {p_plain:.4f} ms by CUDA events; device time {p_dev} ms per "
          f"call by torch.profiler; 70%-one-value batches: kernel {p_bg:.4f} ms by events, "
          f"{p_bg_dev} ms device [{smi}]")
    del tiles, background
    x = torch.randn((BATCH, SIZE, SIZE, INIT_NB), device=dev, generator=g).relu_()
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    w = (torch.randn(INIT_NB, device=dev, generator=g) / INIT_NB ** 0.5).to(torch.bfloat16)
    bias = torch.tensor(0.1, device=dev)
    head = lambda t: diff_sigmoid_head(t, w, bias)  # noqa: E731
    b_ms, b_plain = in_turns(lambda t: diff_sigmoid_head_plain(t, w, bias), head, [x], 10)
    b_dev = profiled_ms(head, [x], 10, ("head_kernel",))
    print(f"timing diff_sigmoid_head ({BATCH},{INIT_NB},{SIZE},{SIZE}) bf16: "
          f"kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms by CUDA events; device time "
          f"{b_dev} ms per call by torch.profiler [{smi}]")
    del x

    # Kernel B' at the training path's main head: batch 2.
    nt = TRAIN_BATCH * SIZE * SIZE
    xt = torch.randn((TRAIN_BATCH, SIZE, SIZE, INIT_NB), device=dev, generator=g).relu_()
    xt = xt.to(torch.bfloat16).permute(0, 3, 1, 2)
    pt = diff_sigmoid_head_forward(xt, w, bias)
    cot = [torch.randn((TRAIN_BATCH, SIZE, SIZE), device=dev, generator=g) for _ in range(3)]
    bwd = lambda c: diff_sigmoid_head_backward(xt, w, pt, c)  # noqa: E731
    bb_ms, bb_plain = in_turns(lambda c: diff_sigmoid_head_backward_plain(xt, w, pt, c), bwd,
                               cot, 10)
    bb_dev = profiled_ms(bwd, cot, 10, ("head_bwd_kernel", "head_bwd_finalize"))
    # x read, dx written (bf16), g and p read (f32), taps and dw; a multiply
    # for dx and a multiply-add for dw per element
    bb_bound = bound(2 * nt * INIT_NB * 2 + 2 * nt * 4 + 2 * INIT_NB * 2 + 4,
                     3 * nt * INIT_NB + 3 * nt)
    plan = head_bwd_plan(INIT_NB, 2, xt.data_ptr(), 0)  # dx: a fresh, aligned allocation
    print(f"timing diff_sigmoid_head_backward ({TRAIN_BATCH},{INIT_NB},{SIZE},{SIZE}) bf16, "
          f"{plan.path} path: kernel {bb_ms:.4f} ms, plain {bb_plain:.4f} ms by CUDA events; "
          f"device time {bb_dev} ms per call by torch.profiler, "
          f"{100 * bb_bound[0] / bb_dev if bb_dev else 0:.1f}% of its bound "
          f"{bb_bound[0]:.4f} ms; previous design "
          f"{PREVIOUS_DESIGN_MS['diff_sigmoid_head_backward']} ms device [{smi}]")
    del xt, pt, cot

    # Kernel D at the augmentation's shape: batch 2 of 1024^2 float32.
    d_in = [(torch.rand((TRAIN_BATCH, SIZE, SIZE), device=dev, generator=g),
             torch.randint(0, 8, (TRAIN_BATCH,), device=dev, generator=g, dtype=torch.int32))
            for _ in range(4)]
    d_ms, d_plain = in_turns(lambda a: d4_transform_batch_plain(*a),
                             lambda a: d4_transform_batch(*a), d_in, 20)
    d_dev = profiled_ms(lambda a: d4_transform_batch(*a), d_in, 20, ("d4_kernel",))
    print(f"timing d4_transform_batch ({TRAIN_BATCH},{SIZE},{SIZE}) f32: kernel {d_ms:.4f} ms, "
          f"plain {d_plain:.4f} ms by CUDA events; device time {d_dev} ms per call by "
          f"torch.profiler [{smi}]")
    del d_in

    # Kernel I at the layout probe's shape: the (H, W, B, C) view of a
    # channels-last (16, 64, 1024, 1024) bf16 activation; clone is the one
    # PyTorch call that computes the same function.
    views = [torch.randn((probe.BATCH, probe.SIZE, probe.SIZE, probe.CHANNELS), device=dev,
                         generator=g, dtype=torch.bfloat16).permute(1, 2, 0, 3) for _ in range(2)]
    i_ms, i_plain = in_turns(ident_hwbc_plain, ident_hwbc, views, 10)
    i_lib = cuda_ms(torch.clone, views, 10)
    i_dev = profiled_ms(ident_hwbc, views, 10, ("ident_hwbc_kernel",))
    i_bytes = 2 * views[0].numel() * views[0].element_size()
    print(f"timing ident_hwbc {tuple(views[0].shape)} bf16 view of a channels-last activation: "
          f"kernel {i_ms:.4f} ms, plain (empty_like + copy_) {i_plain:.4f} ms, clone {i_lib:.4f} "
          f"ms by CUDA events (kernel / clone {i_ms / i_lib:.4f}); device time {i_dev} ms per "
          f"call by torch.profiler; bound {bound(i_bytes, 0)[0]:.4f} ms; previous design "
          f"{PREVIOUS_DESIGN_MS['ident_hwbc']} ms device [{smi}]")
    del views
    n = BATCH * SIZE * SIZE
    return {  # name: (ms, plain ms, device ms, bound, library call ms)
        # u8 in, bf16 out, (B, 3) stats; ~8 f32 operations a pixel
        "fused_zscore_normalize": (a_ms, a_plain, a_dev, bound(n * 3 + BATCH * 12, 8 * n), None),
        # bf16 activation and taps in, f32 out; a multiply-add per channel
        "diff_sigmoid_head": (b_ms, b_plain, b_dev,
                              bound(n * INIT_NB * 2 + INIT_NB * 2 + n * 4, 2 * INIT_NB * n),
                              None),
        # u8 in, f32 out; ~6 operations a pixel (bin, subtract, divide, clip)
        "percentile_normalize_u8": (p_ms, p_plain, p_dev, bound(n * 5, 6 * n), None),
        "diff_sigmoid_head_backward": (bb_ms, bb_plain, bb_dev, bb_bound, None),
        # f32 in and out, no arithmetic
        "d4_transform_batch": (d_ms, d_plain, d_dev,
                               bound(2 * TRAIN_BATCH * SIZE * SIZE * 4 + TRAIN_BATCH * 4, 0), None),
        # bf16 in and out, no arithmetic
        "ident_hwbc": (i_ms, i_plain, i_dev, bound(i_bytes, 0), i_lib),
    }


# The path whose run gives each kernel's "launches": the newest that runs it.
MAIN_PATH = {"fused_zscore_normalize": "cascade", "diff_sigmoid_head": "train_fast_head",
             "percentile_normalize_u8": "train_classifier",
             "diff_sigmoid_head_backward": "train_fast_head",
             "d4_transform_batch": "train_classifier", "ident_hwbc": "layout_probe"}


def main() -> int:
    start = time.perf_counter()
    smi = phase_device()
    # The plain versions are the references: float32 products in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    phase_build()
    errs = {"fused_zscore_normalize": phase_zscore(dev, g),
            "diff_sigmoid_head": phase_head(dev, g),
            "percentile_normalize_u8": phase_percentile(dev, g),
            "d4_transform_batch": phase_d4(dev, g),
            "diff_sigmoid_head_backward": phase_head_backward(dev, g),
            "ident_hwbc": phase_ident(dev, g)}
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        run.mkdir()
        paths["segment"] = phase_slice(dev, run, smi)["launches"]
        torch.cuda.empty_cache()
        paths["cascade"] = phase_cascade(dev, Path(tmp), run, smi)["launches"]
        torch.cuda.empty_cache()
        evaluated = phase_evaluate(dev, Path(tmp), run, smi)
        paths["evaluate"], paths["segment_tta"] = evaluated["launches"], evaluated["segment_tta"]
        torch.cuda.empty_cache()
        data = write_dataset(Path(tmp) / "data")
        paths["train"] = phase_train_cli(dev, Path(tmp), data, smi)["launches"]
        torch.cuda.empty_cache()
        paths["train_fast_head"] = phase_train_fast_head(dev, Path(tmp), data, smi)["launches"]
        torch.cuda.empty_cache()
        cls = phase_train_classifier(dev, Path(tmp), smi)
        paths["train_classifier"] = cls["launches"]
        torch.cuda.empty_cache()
        paths |= phase_classifier_eval(dev, Path(tmp), cls["run"], run, smi)
        torch.cuda.empty_cache()
        paths |= phase_builds(dev, Path(tmp), run, cls["run"], smi)
        torch.cuda.empty_cache()
        paths |= phase_wsi_tools(dev, Path(tmp), smi)
        torch.cuda.empty_cache()
        phase_train_timing(dev, Path(tmp), data, smi)
        torch.cuda.empty_cache()
        phase_cls_timing(dev, g, cls, smi)
        del cls
    torch.cuda.empty_cache()
    paths["layout_probe"] = phase_layout_probe(dev, smi)
    torch.cuda.empty_cache()
    times = phase_kernel_timing(dev, g, smi)
    for name, path in MAIN_PATH.items():
        if paths[path][name] < 1:
            raise AssertionError(f"{name} was not launched on its path {path}: {paths[path]}")
    # One PyTorch call computes kernel I's function (clone); none computes
    # any of the other five (library_ms null): see PERF.md.
    print(f"total: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": paths[MAIN_PATH[name]][name],
         "launches_by_path": {path: counts[name] for path, counts in paths.items()},
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "device_ms": times[name][2], "bound_ms": times[name][3][0],
         "bound_by": times[name][3][1], "library_ms": times[name][4]}
        for name, (_, _, src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
