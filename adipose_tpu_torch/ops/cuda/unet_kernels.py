"""U-Net sigmoid head over a channels-last activation, and its backward:
CUDA kernels and plain versions.

Replaces the TPU kernel ``diff_sigmoid_head``
(``adipose_tpu/ops/pallas/unet_kernels.py:54``, body ``_head_kernel``) and
its custom VJP ``diff_sigmoid_head_vjp`` (``:94``, ``_head_bwd``). Both
kernels are in ``csrc/unet_kernels.cu`` and are bound by device memory: the
forward reads every channel of the full-resolution activation once for two
operations each, the backward reads it and writes its gradient. The forward
stages each block's contiguous channels-last span in shared memory with
16-byte loads and reduces one pixel per thread. The backward streams x in
16-byte vectors straight into registers, with a block and grid stride of
whole channel periods so that each thread keeps the same channels' dw sums in
registers (:func:`head_bwd_plan` makes its plan, and sends shapes the period
path does not take to a general kernel), and reduces dw and dbias through
per-block partials in a fixed order. The source's header says more.

:func:`diff_sigmoid_head` calls the custom op ``adipose::sigmoid_head``,
differentiable through the backward kernel (``register_autograd``), whose
CPU kernel is the plain version and whose CUDA kernel launches the head
kernel or raises; no other device has a kernel. Its fake implementation
gives the output's shape, so ``torch.export`` keeps the op as one node. On a
CPU tensor the backward wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from adipose_tpu_torch.ops.cuda import build

_DTYPES = (torch.bfloat16, torch.float32)
# The backward's most blocks (csrc kBwdMaxBlocks): its grid is as many blocks
# as fit on the card at once, 132 SMs x at most 8 blocks on an H100, capped here.
_BWD_PARTIAL_ROWS = 1024


class HeadBwdPlan(NamedTuple):
    """How the head backward kernel runs. ``path`` "period": 16-byte vectors
    of ``vec`` elements, whose channels repeat every ``period`` vectors, and
    blocks of ``block[0]`` threads, a multiple of 32 and of the period;
    "general": one thread per column and pixel lane, blocks of ``block``
    (columns, pixel lanes), ``vec`` 1 and ``period`` 0."""
    path: str
    vec: int
    period: int
    block: tuple[int, int]


def head_bwd_plan(channels: int, itemsize: int, x_addr: int, dx_addr: int) -> HeadBwdPlan:
    """The backward kernel's plan for ``channels`` channels of ``itemsize``
    bytes, x at byte address ``x_addr`` and dx at ``dx_addr``.

    The period path takes every C whose period ``C / gcd(C, V)`` vectors
    has a least common multiple with 32 of at most 1024 (a block's most
    threads) and whose vectors span at most two pixels (``V <= C + 1``), with
    both tensors 16-byte aligned; its block is that multiple, repeated up to
    256 threads. Everything else takes the general path: a block of 256
    threads, the columns (C and dbias) rounded up to a warp across, at most
    256."""
    vec = 16 // itemsize
    period = channels // math.gcd(channels, vec)
    base = math.lcm(period, 32)
    if base <= 1024 and vec <= channels + 1 and (x_addr | dx_addr) % 16 == 0:
        return HeadBwdPlan("period", vec, period, (base * max(1, 256 // base), 1))
    cols = min(-(-(channels + 1) // 32) * 32, 256)
    return HeadBwdPlan("general", 1, 0, (cols, 256 // cols))


def diff_sigmoid_head_plain(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`diff_sigmoid_head`: f32 products of
    exact upcasts, f32 accumulation."""
    logit = torch.matmul(x.permute(0, 2, 3, 1).to(torch.float32), w.to(torch.float32))
    return torch.sigmoid(logit + bias)


def diff_sigmoid_head_backward_plain(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                                     g: torch.Tensor):
    """Plain PyTorch version of :func:`diff_sigmoid_head_backward`, the
    JAX ``_head_bwd``: ``dlogit = g * p * (1 - p)`` in f32; ``dx = dlogit * w``
    rounded once to x's dtype, channels-last; ``dw = sum x * dlogit`` in f32
    cast to w's dtype; ``dbias = sum dlogit``."""
    dlogit = g * p * (1.0 - p)
    dx = (dlogit[..., None] * w.to(torch.float32)).to(x.dtype).permute(0, 3, 1, 2)
    dw = torch.einsum("bchw,bhw->c", x.to(torch.float32), dlogit).to(w.dtype)
    return dx, dw, dlogit.sum()


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and w {w.dtype} must share a dtype in {_DTYPES}")
    if x.dim() != 4 or w.shape != (x.shape[1],) or x.numel() == 0:
        raise ValueError(
            f"{what}: needs (B, C, H, W) x and (C,) w, got {tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: x must be channels-last contiguous, strides {x.stride()}")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{what}: x on {x.device} and w on {w.device}, need one CUDA device")


def _head_cuda(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel of ``adipose::sigmoid_head``: one launch, counted."""
    _check(x, w, "diff_sigmoid_head")
    b, c, h, wd = x.shape
    dev = x.device
    w = w.contiguous()
    bias_t = bias.to(device=dev, dtype=torch.float32).reshape(())
    out = torch.empty((b, h, wd), dtype=torch.float32, device=dev)
    index, stream = build.launch_target(dev)
    code = build.library().adipose_sigmoid_head(
        index, x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        bias_t.data_ptr(), out.data_ptr(), b * h * wd, c, stream)
    build.check(code, "diff_sigmoid_head")
    diff_sigmoid_head.launches += 1
    return out


# The op: the plain version on the CPU, the kernel on CUDA, no kernel on any
# other device (the dispatcher raises there); differentiable through the
# backward kernel B'. The CPU kernel looks the plain version up at call time,
# so a counting shim put in its place is seen.
@torch.library.custom_op("adipose::sigmoid_head", mutates_args=(), device_types="cpu")
def sigmoid_head_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return diff_sigmoid_head_plain(x, w, bias)


sigmoid_head_op.register_kernel("cuda")(_head_cuda)


@sigmoid_head_op.register_fake
def _head_fake(x, w, bias):
    if x.device.type != "cpu":  # a trace for the card fails where the kernel would
        _check(x, w, "diff_sigmoid_head")
    b, _, h, wd = x.shape
    return x.new_empty((b, h, wd), dtype=torch.float32)


def _head_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w, output)


def _head_backward(ctx, g):
    x, w, p = ctx.saved_tensors
    return diff_sigmoid_head_backward(x, w, p, g.contiguous())


sigmoid_head_op.register_autograd(_head_backward, setup_context=_head_setup)


def diff_sigmoid_head_forward(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """The head kernel alone, outside autograd; see :func:`diff_sigmoid_head`.
    Counts its launches on ``diff_sigmoid_head.launches``."""
    with torch.no_grad():
        return diff_sigmoid_head(x, w, bias)


def diff_sigmoid_head_backward(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                               g: torch.Tensor):
    """``(dx, dw, dbias)`` of ``p = diff_sigmoid_head(x, w, bias)`` for the
    cotangent ``g``.

    Args:
      x: (B, C, H, W) activation, bf16 or f32, ``torch.channels_last``.
      w: (C,) taps in x's dtype.
      p: (B, H, W) float32, the forward's output.
      g: (B, H, W) float32 cotangent of p.

    Returns:
      dx (B, C, H, W) in x's dtype, channels-last; dw (C,) in w's dtype;
      dbias, a 0-dim float32 tensor.
    """
    if x.device.type == "cpu":
        return diff_sigmoid_head_backward_plain(x, w, p, g)
    _check(x, w, "diff_sigmoid_head_backward")
    b, c, h, wd = x.shape
    for name, t in (("p", p), ("g", g)):
        if t.dtype != torch.float32 or t.shape != (b, h, wd) or t.device != x.device:
            raise ValueError(f"diff_sigmoid_head_backward: {name} must be ({b}, {h}, {wd}) "
                             f"float32 on {x.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    dev = x.device
    w, p, g = w.contiguous(), p.contiguous(), g.contiguous()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    partial = torch.empty((_BWD_PARTIAL_ROWS, c + 1), dtype=torch.float32, device=dev)
    dw = torch.empty_like(w)
    dbias = torch.empty((), dtype=torch.float32, device=dev)
    plan = head_bwd_plan(c, x.element_size(), x.data_ptr(), dx.data_ptr())
    index, stream = build.launch_target(dev)
    code = build.library().adipose_sigmoid_head_bwd(
        index, x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), g.data_ptr(),
        p.data_ptr(), dx.data_ptr(), partial.data_ptr(), _BWD_PARTIAL_ROWS, dw.data_ptr(),
        dbias.data_ptr(), b * h * wd, c, plan.period, *plan.block, stream)
    build.check(code, "diff_sigmoid_head_backward")
    diff_sigmoid_head_backward.launches += 1
    return dx, dw, dbias


def diff_sigmoid_head(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """``sigmoid(einsum('bchw,c->bhw', x, w) + bias)`` with f32 accumulation,
    differentiable in x, w and bias, through the op ``adipose::sigmoid_head``
    (one node in a ``torch.export`` graph).

    Args:
      x: (B, C, H, W) activation, bf16 or f32, ``torch.channels_last``.
      w: (C,) taps in x's dtype.
      bias: scalar logit offset (float or 0-dim float32 tensor).

    Returns:
      (B, H, W) float32 probabilities.
    """
    bias = torch.as_tensor(bias, dtype=torch.float32, device=x.device)
    return torch.ops.adipose.sigmoid_head(x, w, bias)


diff_sigmoid_head.launches = 0
diff_sigmoid_head_backward.launches = 0
