#!/usr/bin/env python3
"""Drive the PyTorch port's segment path once on one CUDA GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one line each; any failure raises and the script exits nonzero:
  1. device  the card's name and power limit (nvidia-smi)
  2. build   both CUDA kernels from adipose_tpu_torch/csrc into build/kernels
  3. kernel A (fused z-score) against its plain version at (16, 1024, 1024)
  4. kernel B (sigmoid head) against its plain version at the main path's
     shape (16, 44, 1024, 1024) and the aux heads' C = 176 and 88
  5. slice   a seeded init_nb=44 checkpoint loaded through the port's
     ``_load_segmenter``, requests of 16 distinct 1024^2 uint8 tiles
     answered through ``segment_batch``, checked against the same model run
     with the plain z-score and head
  6. timing  CUDA events, after warmup, on distinct batches
Then one JSON line with every kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from adipose_tpu_torch.cli.main import _load_segmenter, segment_batch
from adipose_tpu_torch.models.convert import torch_unet_to_flax
from adipose_tpu_torch.models.unet import DilatedUNet, diff_head_taps
from adipose_tpu_torch.ops.cuda import build
from adipose_tpu_torch.ops.cuda.preprocess import (fused_zscore_normalize,
                                                   fused_zscore_normalize_plain)
from adipose_tpu_torch.ops.cuda.unet_kernels import (diff_sigmoid_head,
                                                     diff_sigmoid_head_plain)
from adipose_tpu_torch.ops.normalize import TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT
from adipose_tpu_torch.train import checkpoint as ckpt

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

ROOT = Path(__file__).resolve().parent


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

    fused_zscore_normalize.launches = 0
    diff_sigmoid_head.launches = 0
    t0 = time.perf_counter()
    preds = [segment_batch(predict, params, r, BATCH, dev) for r in requests]
    host_s = time.perf_counter() - t0
    launches = {"fused_zscore_normalize": fused_zscore_normalize.launches,
                "diff_sigmoid_head": diff_sigmoid_head.launches}
    for name, n in launches.items():
        if n != REQUESTS:
            raise AssertionError(f"{name} launched {n} times for {REQUESTS} requests")
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
          f"channels-last through _load_segmenter/segment_batch; launches {launches}; "
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
    return {"launches": launches, "err": err}


def phase_kernel_timing(dev, g, smi: str) -> dict:
    tiles = [torch.randint(0, 256, (BATCH, SIZE, SIZE), dtype=torch.uint8, device=dev,
                           generator=g) for _ in range(4)]  # 64 MB: more than L2
    a_ms, a_plain = in_turns(
        lambda t: fused_zscore_normalize_plain(t, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT,
                                               out_dtype=torch.bfloat16),
        lambda t: fused_zscore_normalize(t, TRAIN_MEAN_DEFAULT, TRAIN_STD_DEFAULT,
                                         out_dtype=torch.bfloat16),
        tiles, 20)
    print(f"timing fused_zscore_normalize ({BATCH},{SIZE},{SIZE}) u8 -> bf16: "
          f"kernel {a_ms:.4f} ms, plain {a_plain:.4f} ms [{smi}]")
    del tiles
    x = torch.randn((BATCH, SIZE, SIZE, INIT_NB), device=dev, generator=g).relu_()
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    w = (torch.randn(INIT_NB, device=dev, generator=g) / INIT_NB ** 0.5).to(torch.bfloat16)
    bias = torch.tensor(0.1, device=dev)
    b_ms, b_plain = in_turns(lambda t: diff_sigmoid_head_plain(t, w, bias),
                             lambda t: diff_sigmoid_head(t, w, bias), [x], 10)
    print(f"timing diff_sigmoid_head ({BATCH},{INIT_NB},{SIZE},{SIZE}) bf16: "
          f"kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms [{smi}]")
    return {"fused_zscore_normalize": (a_ms, a_plain), "diff_sigmoid_head": (b_ms, b_plain)}


def main() -> int:
    smi = phase_device()
    # The plain versions are the references: float32 products in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    phase_build()
    errs = {"fused_zscore_normalize": phase_zscore(dev, g),
            "diff_sigmoid_head": phase_head(dev, g)}
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        run.mkdir()
        sl = phase_slice(dev, run, smi)
    torch.cuda.empty_cache()
    times = phase_kernel_timing(dev, g, smi)
    sources = {"fused_zscore_normalize": ("adipose_tpu_torch/csrc/preprocess.cu",
                                          "adipose_tpu/ops/pallas/preprocess.py:72"),
               "diff_sigmoid_head": ("adipose_tpu_torch/csrc/unet_kernels.cu",
                                     "adipose_tpu/ops/pallas/unet_kernels.py:54")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sl["launches"][name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
