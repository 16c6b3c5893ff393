"""Bytes and operations of the port's hand-written kernels from their
shapes, and the least time the card could take for them.

``bound`` and the counts are ``chip_smoke.py``'s (``bound()``,
``HBM_BYTES_PER_S``, ``F32_FLOP_PER_S`` and the bytes of its kernel table):
each input byte read once and each output byte written once, whatever the
kernel reads again. A kernel is one or more device functions; ``FUNCTIONS``
names them (``__global__`` functions of each source's anonymous namespace),
and a launch of the kernel is one launch of each.
"""

from __future__ import annotations

from bench_h100.work import F32_FLOP_PER_S, HBM_BYTES_PER_S

# kernel -> its device functions
FUNCTIONS = {
    "A": ("zscore_kernel", "zscore_finalize"),
    "B": ("head_kernel",),
    "P": ("hist_kernel", "percentile_kernel", "apply_kernel"),
    "D": ("d4_kernel",),
}
# kernel -> the wrapper whose ``.launches`` counts its calls
WRAPPERS = {
    "A": ("adipose_tpu_torch.ops.cuda.preprocess", "fused_zscore_normalize"),
    "B": ("adipose_tpu_torch.ops.cuda.unet_kernels", "diff_sigmoid_head"),
    "P": ("adipose_tpu_torch.ops.cuda.percentile", "percentile_normalize_u8"),
    "D": ("adipose_tpu_torch.ops.cuda.d4", "d4_transform_batch"),
}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least seconds the card could take, what bounds it): bytes over the
    memory rate against float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def zscore(batch: int, pixels: int, in_bytes: int = 1, out_bytes: int = 2):
    """A: (B, H, W) tiles read, the (B, 1, H, W) z-score and (B, 3) f32
    statistics written; ~5 operations a pixel."""
    return batch * pixels * (in_bytes + out_bytes) + batch * 3 * 4, 5.0 * batch * pixels


def head(batch: int, channels: int, pixels: int, in_bytes: int = 2):
    """B: (B, C, H, W) features and C taps read, (B, H, W) f32 written; a
    multiply-add a channel and a sigmoid a pixel."""
    return (batch * channels * pixels * in_bytes + channels * in_bytes + batch * pixels * 4,
            batch * pixels * (2.0 * channels + 4.0))


def percentile(batch: int, pixels: int, in_bytes: int = 1):
    """P: (B, H, W) tiles read, (B, H, W) f32 written; a bin and a stretch
    a pixel."""
    return batch * pixels * (in_bytes + 4), 4.0 * batch * pixels


def d4(batch: int, pixels: int):
    """D: (B, N, N) f32 read and written; no arithmetic."""
    return batch * pixels * 8, 0.0


SHAPES = {"A": zscore, "B": head, "P": percentile, "D": d4}


def launch_work(kernel: str, *shape) -> dict:
    """``{"kernel", "bytes", "flops", "bound_s", "bound_by"}`` of one launch."""
    nbytes, flops = SHAPES[kernel](*shape)
    seconds, by = bound(nbytes, flops)
    return {"kernel": kernel, "bytes": nbytes, "flops": flops, "bound_s": seconds,
            "bound_by": by}
