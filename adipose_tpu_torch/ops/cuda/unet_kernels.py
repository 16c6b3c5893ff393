"""U-Net sigmoid head over a channels-last activation: CUDA kernel and plain version.

Replaces the TPU kernel ``diff_sigmoid_head``
(``adipose_tpu/ops/pallas/unet_kernels.py:54``, body ``_head_kernel``),
forward only; its VJP belongs to training. The kernel is
``csrc/unet_kernels.cu``. It is bound by device memory: it reads every
channel of the full-resolution activation once for two operations each.
Its design stages each block's contiguous channels-last span in shared
memory with 16-byte loads and reduces one pixel per thread; the source's
header says more.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda import build

_DTYPES = (torch.bfloat16, torch.float32)


def diff_sigmoid_head_plain(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`diff_sigmoid_head`: f32 products of
    exact upcasts, f32 accumulation."""
    logit = torch.matmul(x.permute(0, 2, 3, 1).to(torch.float32), w.to(torch.float32))
    return torch.sigmoid(logit + bias)


def diff_sigmoid_head(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """``sigmoid(einsum('bchw,c->bhw', x, w) + bias)`` with f32 accumulation.

    Args:
      x: (B, C, H, W) activation, bf16 or f32, ``torch.channels_last``.
      w: (C,) taps in x's dtype.
      bias: scalar logit offset (float or 0-dim float32 tensor).

    Returns:
      (B, H, W) float32 probabilities.
    """
    if x.device.type == "cpu":
        return diff_sigmoid_head_plain(x, w, bias)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"diff_sigmoid_head: x {x.dtype} and w {w.dtype} must share a dtype in {_DTYPES}")
    if x.dim() != 4 or w.shape != (x.shape[1],) or x.numel() == 0:
        raise ValueError(
            f"diff_sigmoid_head: needs (B, C, H, W) x and (C,) w, got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"diff_sigmoid_head: x must be channels-last contiguous, strides {x.stride()}")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(
            f"diff_sigmoid_head: x on {x.device} and w on {w.device}, need one CUDA device")
    b, c, h, wd = x.shape
    dev = x.device
    w = w.contiguous()
    bias_t = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(())
    out = torch.empty((b, h, wd), dtype=torch.float32, device=dev)
    index, stream = build.launch_target(dev)
    code = build.library().adipose_sigmoid_head(
        index, x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        bias_t.data_ptr(), out.data_ptr(), b * h * wd, c, stream)
    build.check(code, "diff_sigmoid_head")
    diff_sigmoid_head.launches += 1
    return out


diff_sigmoid_head.launches = 0
