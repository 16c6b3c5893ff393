#!/usr/bin/env python3
"""Drive the PyTorch port's segment path, WSI cascade, U-Net training and
conv-chain layout probe once on one CUDA GPU and check its kernels.

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
     and the autograd Function against plain autograd
  5d. kernel I (identity on the (H, W, B, C) view) bit-equal to its plain
     version, strides kept, on the probe's view of a channels-last
     (16, 64, 1024, 1024) bf16 activation, a contiguous (1024, 1024, 16, 64)
     tensor and (64, 1000, 3, 44), whose C rows take the scalar tail
  6. slice   a seeded init_nb=44 checkpoint loaded through the port's
     ``_load_segmenter``, requests of 16 distinct 1024^2 uint8 tiles
     answered through ``segment_batch``, checked against the same model run
     with the plain z-score and head
  7. cascade ``adipose-torch pipeline`` (``cli.main.main``) over three chunk
     PNGs (6144^2, 6144x4096, 3000x5000) with a seeded full InceptionV3
     and the init_nb=44 U-Net, 1024^2 tiles, batch 16; launch counts per
     chunk batch; checked against the same cascade with the plain versions
  8. train   ``adipose-torch train-unet`` (``cli.main.main``) at its defaults
     (init_nb 44, 1024^2, batch 2, bf16, deep supervision, OHEM, EMA,
     cosine, moderate augmentation, percentile) for one epoch per phase on
     a seeded 8 + 4 tile dataset: the artifact contract, finite losses, an
     encoder untouched by phase 1, launches D 2 and P 1 per step and P 1 per
     val batch; the run then served by ``adipose-torch segment``
  9. fast head ``UNetTrainer`` with ``UNetConfig(fast_head=True)``: kernels
     B and B' 3 per step; its first step through the kernels against the
     same step with the plain versions
  9b. probe  the layout probe (``scripts/exp_layout_probe.py`` ported) at
     (16, 64, 1024, 1024) bf16 through its ``main``: I once per kernel-chain
     call; with cuDNN deterministic, the chain through I bit-equal to the
     chain without it; each chain's device activities by name, and the
     kernels the chain through I adds besides I (the probe's answer)
 10. timing  CUDA events, after warmup, on distinct batches, in turns with
     the plain versions; device time per call from torch.profiler; train
     step and augmentation at batch 2 and 8, and the device's idle share
     over one epoch
Then one JSON line with every kernel's launches, error, times and bound, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np
import torch

import adipose_tpu_torch.cli.main as cli
import adipose_tpu_torch.models.unet as unet_module
import adipose_tpu_torch.ops.d4 as d4_module
import adipose_tpu_torch.ops.normalize as normalize_module
from adipose_tpu_torch.cli.main import _load_classifier, _load_segmenter, segment_batch
from adipose_tpu_torch.models.convert import torch_inception_to_flax, torch_unet_to_flax
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet, diff_head_taps
from adipose_tpu_torch.ops.cuda import build
from adipose_tpu_torch.ops.cuda.percentile import (percentile_normalize_u8,
                                                   percentile_normalize_u8_plain)
from adipose_tpu_torch.ops.cuda.preprocess import (fused_zscore_normalize,
                                                   fused_zscore_normalize_plain)
from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch, d4_transform_batch_plain
from adipose_tpu_torch.ops.cuda.layout import ident_hwbc, ident_hwbc_plain
from adipose_tpu_torch.ops.cuda.unet_kernels import (diff_sigmoid_head,
                                                     diff_sigmoid_head_backward,
                                                     diff_sigmoid_head_backward_plain,
                                                     diff_sigmoid_head_forward,
                                                     diff_sigmoid_head_plain)
from adipose_tpu_torch.ops.d4 import INVERSE_IDS
from adipose_tpu_torch.core.config import TrainConfig, UNetConfig
from adipose_tpu_torch.models.convert import load_flax_npz
from adipose_tpu_torch.ops.normalize import TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT
from adipose_tpu_torch.scripts import exp_layout_probe as probe
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
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
    """Kernel B' vs plain at the training path's head shapes (batch 2):
    dx bit-equal, dw and dbias to their bounds, two runs bit-equal; then the
    autograd Function against plain autograd at f32."""
    worst = 0.0
    shapes = [(INIT_NB, SIZE, torch.bfloat16), (4 * INIT_NB, SIZE // 4, torch.bfloat16),
              (2 * INIT_NB, SIZE // 2, torch.bfloat16), (INIT_NB, SIZE, torch.float32)]
    for c, s, dtype in shapes:
        x = torch.randn((TRAIN_BATCH, s, s, c), device=dev, generator=g).relu_()
        x = x.to(dtype).permute(0, 3, 1, 2)  # channels-last (B, C, H, W)
        w = (torch.randn(c, device=dev, generator=g) / c ** 0.5).to(dtype)
        p = diff_sigmoid_head_forward(x, w, torch.tensor(0.1, device=dev))
        gr = torch.randn((TRAIN_BATCH, s, s), device=dev, generator=g)
        dxk, dwk, dbk = diff_sigmoid_head_backward(x, w, p, gr)
        dxk2, dwk2, dbk2 = diff_sigmoid_head_backward(x, w, p, gr)
        dxp, dwp, dbp = diff_sigmoid_head_backward_plain(x, w, p, gr)
        torch.cuda.synchronize()
        case = f"({TRAIN_BATCH},{c},{s},{s}) {dtype}"
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
    contiguous (H, W, B, C) tensor and an odd shape with a scalar tail."""
    def normal(*shape):
        return torch.randn(shape, device=dev, generator=g, dtype=torch.bfloat16)

    b, s, c = probe.BATCH, probe.SIZE, probe.CHANNELS
    cases = [(f"({s},{s},{b},{c}) view of a channels-last ({b},{c},{s},{s})",
              lambda: normal(b, s, s, c).permute(1, 2, 0, 3)),
             (f"({s},{s},{b},{c}) contiguous", lambda: normal(s, s, b, c)),
             ("(64,1000,3,44) contiguous", lambda: normal(64, 1000, 3, 44))]
    for case, make in cases:
        t = make()
        k = ident_hwbc(t)
        plain = ident_hwbc_plain(t)
        torch.cuda.synchronize()
        if k.stride() != t.stride():
            raise AssertionError(f"ident_hwbc {case}: strides {k.stride()}, input {t.stride()}")
        if not (torch.equal(bits(k), bits(plain)) and torch.equal(bits(k), bits(t))):
            raise AssertionError(f"ident_hwbc {case}: not bit-equal to plain and the input")
        del t, k, plain
    torch.cuda.empty_cache()
    print(f"kernel ident_hwbc {'; '.join(case for case, _ in cases)} bf16: bit-equal to plain "
          f"and to the input, strides kept")
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
    print(f"timing diff_sigmoid_head_backward ({TRAIN_BATCH},{INIT_NB},{SIZE},{SIZE}) bf16: "
          f"kernel {bb_ms:.4f} ms, plain {bb_plain:.4f} ms by CUDA events; device time "
          f"{bb_dev} ms per call by torch.profiler [{smi}]")
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
          f"ms by CUDA events; device time {i_dev} ms per call by torch.profiler; bound "
          f"{bound(i_bytes, 0)[0]:.4f} ms [{smi}]")
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
        # x read, dx written (bf16), g and p read (f32), taps and dw; a
        # multiply for dx and a multiply-add for dw per element
        "diff_sigmoid_head_backward": (bb_ms, bb_plain, bb_dev, bound(
            2 * nt * INIT_NB * 2 + 2 * nt * 4 + 2 * INIT_NB * 2 + 4, 3 * nt * INIT_NB + 3 * nt),
            None),
        # f32 in and out, no arithmetic
        "d4_transform_batch": (d_ms, d_plain, d_dev,
                               bound(2 * TRAIN_BATCH * SIZE * SIZE * 4 + TRAIN_BATCH * 4, 0), None),
        # bf16 in and out, no arithmetic
        "ident_hwbc": (i_ms, i_plain, i_dev, bound(i_bytes, 0), i_lib),
    }


# The path whose run gives each kernel's "launches": the newest that runs it.
MAIN_PATH = {"fused_zscore_normalize": "cascade", "diff_sigmoid_head": "train_fast_head",
             "percentile_normalize_u8": "train", "diff_sigmoid_head_backward": "train_fast_head",
             "d4_transform_batch": "train", "ident_hwbc": "layout_probe"}


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
        data = write_dataset(Path(tmp) / "data")
        paths["train"] = phase_train_cli(dev, Path(tmp), data, smi)["launches"]
        torch.cuda.empty_cache()
        paths["train_fast_head"] = phase_train_fast_head(dev, Path(tmp), data, smi)["launches"]
        torch.cuda.empty_cache()
        phase_train_timing(dev, Path(tmp), data, smi)
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
