"""Plain PyTorch references of what the port computes: float32, TF32 off,
no kernels of the port, nothing imported from it. They read the inputs
and seeded weights the benchmark made, never what the port made of them.

``quant`` selects the control: the same computation with every conv's
input and weights rounded to float8 (e4m3, one scale a tensor), the
precision below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), returned in float32; gradients pass the
    rounding unchanged, so a backward sees the rounded operands."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (rounded - x.detach())


def conv_input(x: torch.Tensor, w: torch.Tensor, quant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """A conv's (input, weight) in the reference's precision: float32, or
    with ``quant == "fp8"`` rounded to float8 first."""
    if quant == "fp8":
        return fp8_round(x), fp8_round(w)
    if quant != "fp32":
        raise ValueError(f"quant must be 'fp32' or 'fp8', got {quant!r}")
    return x, w


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convs inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
