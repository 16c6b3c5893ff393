#!/usr/bin/env python3
"""Drive the PyTorch port's segment path and WSI cascade once on one CUDA GPU
and check its kernels.

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
  6. slice   a seeded init_nb=44 checkpoint loaded through the port's
     ``_load_segmenter``, requests of 16 distinct 1024^2 uint8 tiles
     answered through ``segment_batch``, checked against the same model run
     with the plain z-score and head
  7. cascade ``adipose-torch pipeline`` (``cli.main.main``) over three chunk
     PNGs (6144^2, 6144x4096, 3000x5000) with a seeded full InceptionV3
     and the init_nb=44 U-Net, 1024^2 tiles, batch 16; launch counts per
     chunk batch; checked against the same cascade with the plain versions
  8. timing  CUDA events, after warmup, on distinct batches, in turns with
     the plain versions; device time per call from torch.profiler
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
from adipose_tpu_torch.ops.cuda.unet_kernels import (diff_sigmoid_head,
                                                     diff_sigmoid_head_plain)
from adipose_tpu_torch.ops.normalize import TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT
from adipose_tpu_torch.train import checkpoint as ckpt
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


def profiled_ms(fn, inputs: list, iters: int, names: tuple[str, ...]) -> float | None:
    """Device time per call of ``fn`` from torch.profiler: the summed time of
    the device activities whose names contain one of ``names`` (each one's
    share is printed); None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    per_name = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                per_name[n] += device_us(e)
    us = sum(per_name.values())
    print("  device ms per call: " + ", ".join(
        f"{n} {v / iters / 1000.0:.4f}" for n, v in per_name.items()))
    return us / iters / 1000.0 if us > 0 else None


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
    """Swap every kernel wrapper on the port's paths for its plain version."""
    swaps = [(cli, "fused_zscore_normalize", fused_zscore_normalize_plain),
             (unet_module, "diff_sigmoid_head", diff_sigmoid_head_plain),
             (normalize_module, "percentile_normalize_u8", percentile_normalize_u8_plain)]
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
            "percentile_normalize_u8": 0}
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
            "percentile_normalize_u8": classify_batches}
    if counts != want or min(counts.values()) < 1:
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
    n = BATCH * SIZE * SIZE
    return {
        # u8 in, bf16 out, (B, 3) stats; ~8 f32 operations a pixel
        "fused_zscore_normalize": (a_ms, a_plain, a_dev, bound(n * 3 + BATCH * 12, 8 * n)),
        # bf16 activation and taps in, f32 out; a multiply-add per channel
        "diff_sigmoid_head": (b_ms, b_plain, b_dev,
                              bound(n * INIT_NB * 2 + INIT_NB * 2 + n * 4, 2 * INIT_NB * n)),
        # u8 in, f32 out; ~6 operations a pixel (bin, subtract, divide, clip)
        "percentile_normalize_u8": (p_ms, p_plain, p_dev, bound(n * 5, 6 * n)),
    }


def main() -> int:
    smi = phase_device()
    # The plain versions are the references: float32 products in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    phase_build()
    errs = {"fused_zscore_normalize": phase_zscore(dev, g),
            "diff_sigmoid_head": phase_head(dev, g),
            "percentile_normalize_u8": phase_percentile(dev, g)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        run.mkdir()
        sl = phase_slice(dev, run, smi)
        torch.cuda.empty_cache()
        cas = phase_cascade(dev, Path(tmp), run, smi)
    torch.cuda.empty_cache()
    times = phase_kernel_timing(dev, g, smi)
    # launches: the cascade's run, the newest path, which runs all three;
    # the segment path's count stands beside it. No single PyTorch call
    # computes any of the three functions (library_ms null): see PERF.md.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": cas["launches"][name],
         "launches_by_path": {"segment": sl["launches"][name],
                              "cascade": cas["launches"][name]},
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "device_ms": times[name][2], "bound_ms": times[name][3][0],
         "bound_by": times[name][3][1], "library_ms": None}
        for name, (_, _, src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
