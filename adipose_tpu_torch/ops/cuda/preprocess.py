"""Dataset z-score with per-tile statistics: CUDA kernel and plain version.

Replaces the TPU kernel ``fused_zscore_normalize``
(``adipose_tpu/ops/pallas/preprocess.py:72``, body ``_fused_zscore_kernel``).
The kernel is ``csrc/preprocess.cu``. It is bound by device memory (about
five operations per input byte). Its design reads each input byte once and
writes the normalized tile once, directly in the model's input dtype; the
source's header says how.

The wrapper calls the custom op ``adipose::zscore``, whose CPU kernel is the
plain version and whose CUDA kernel launches the CUDA kernel or raises: there
is no fallback, and no other device has a kernel. Its fake implementation
gives the outputs' shapes, so ``torch.export`` keeps the op as one node.
"""

from __future__ import annotations

import numpy as np
import torch

from adipose_tpu_torch.ops.cuda import build

WHITE_THRESHOLD = 235.0
_IN_DTYPES = (torch.uint8, torch.float32)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _scalars(mean: float, std: float) -> tuple[float, float]:
    """The f32 mean and ``std + 1e-10`` both versions divide by, rounded as
    the TPU kernel rounds them (f32 operands, f32 add)."""
    return float(np.float32(mean)), float(np.float32(np.float32(std) + np.float32(1e-10)))


def fused_zscore_normalize_plain(tiles: torch.Tensor, mean: float, std: float,
                                 white_threshold: float = WHITE_THRESHOLD,
                                 out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`fused_zscore_normalize`.

    Statistics are taken in float64, exact for uint8 tiles.
    """
    b = tiles.shape[0]
    mean_f, denom_f = _scalars(mean, std)
    dev = tiles.device
    xf = tiles.to(torch.float32)
    # Tensor operands: on CUDA a Python-scalar divisor is applied as a
    # multiply by its reciprocal, one rounding away from the kernel's quotient.
    mean_t = torch.tensor(mean_f, dtype=torch.float32, device=dev)
    denom_t = torch.tensor(denom_f, dtype=torch.float32, device=dev)
    normalized = ((xf - mean_t) / denom_t).to(out_dtype).unsqueeze(1)
    xd = tiles.reshape(b, -1).to(torch.float64)
    n = torch.tensor(float(xd.shape[1]), dtype=torch.float64, device=dev)
    m = xd.sum(1) / n
    var = (xd * xd).sum(1) / n - m * m
    white = (xf.reshape(b, -1) >= white_threshold).sum(1).to(torch.float64) / n
    stats = torch.stack([m, var.clamp_min(0.0).sqrt(), white], 1).to(torch.float32)
    return normalized, stats


def _check(tiles: torch.Tensor, out_dtype: torch.dtype) -> None:
    """What the kernel takes; the fake implementation checks it too, so a
    trace for the card fails where the kernel would."""
    if tiles.dtype not in _IN_DTYPES:
        raise TypeError(f"fused_zscore_normalize: tiles dtype {tiles.dtype} not in {_IN_DTYPES}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"fused_zscore_normalize: out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if tiles.dim() != 3 or not tiles.is_contiguous() or tiles.numel() == 0:
        raise ValueError(
            f"fused_zscore_normalize: needs non-empty contiguous (B, H, W) tiles, "
            f"got shape {tuple(tiles.shape)} strides {tiles.stride()}")
    if not tiles.is_cuda:
        raise ValueError(f"fused_zscore_normalize: tiles on {tiles.device}, not CPU or CUDA")


def _zscore_cuda(tiles: torch.Tensor, mean: float, std: float, white_threshold: float,
                 out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel of ``adipose::zscore``: one launch, counted."""
    _check(tiles, out_dtype)
    b, h, w = tiles.shape
    mean_f, denom_f = _scalars(mean, std)
    dev = tiles.device
    out = torch.empty((b, 1, h, w), dtype=out_dtype, device=dev)
    stats = torch.empty((b, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((b, 3), dtype=torch.int64, device=dev)
    index, stream = build.launch_target(dev)
    code = build.library().adipose_zscore(
        index, tiles.data_ptr(), int(tiles.dtype == torch.uint8),
        out.data_ptr(), int(out_dtype == torch.bfloat16),
        acc.data_ptr(), stats.data_ptr(), b, h * w,
        mean_f, denom_f, float(white_threshold), stream)
    build.check(code, "fused_zscore_normalize")
    fused_zscore_normalize.launches += 1
    return out, stats


# The op: the plain version on the CPU, the kernel on CUDA, no kernel on any
# other device (the dispatcher raises there). The CPU kernel looks the plain
# version up at call time, so a counting shim put in its place is seen.
@torch.library.custom_op("adipose::zscore", mutates_args=(), device_types="cpu")
def zscore_op(tiles: torch.Tensor, mean: float, std: float, white_threshold: float,
              out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    return fused_zscore_normalize_plain(tiles, mean, std, white_threshold, out_dtype)


zscore_op.register_kernel("cuda")(_zscore_cuda)


@zscore_op.register_fake
def _zscore_fake(tiles, mean, std, white_threshold, out_dtype):
    if tiles.device.type != "cpu":
        _check(tiles, out_dtype)
    b, h, w = tiles.shape
    return (tiles.new_empty((b, 1, h, w), dtype=out_dtype),
            tiles.new_empty((b, 3), dtype=torch.float32))


def fused_zscore_normalize(tiles: torch.Tensor, mean: float, std: float,
                           white_threshold: float = WHITE_THRESHOLD,
                           out_dtype: torch.dtype = torch.float32):
    """One pass: per-tile stats plus the dataset z-score ``(x-mean)/(std+1e-10)``,
    through the op ``adipose::zscore`` (one node in a ``torch.export`` graph).

    Args:
      tiles: (B, H, W) uint8 or float32 tiles, contiguous.
      mean, std: the dataset statistics (``normalization_stats.json``).
      out_dtype: float32 or bfloat16, the dtype of the normalized output.

    Returns:
      (normalized (B, 1, H, W) ``out_dtype``, stats (B, 3) float32
      ``[mean, std, white_ratio]`` of each tile).
    """
    return torch.ops.adipose.zscore(tiles, float(mean), float(std), float(white_threshold),
                                    out_dtype)


fused_zscore_normalize.launches = 0
