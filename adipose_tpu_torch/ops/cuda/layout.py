"""Identity copy of a 4-D bf16 tensor over its logical (H, W, B, C) view:
CUDA kernel and plain version.

Replaces the TPU kernel ``pallas_ident_hwbc`` (``scripts/exp_layout_probe.py:37``,
body ``ident_kernel``), which the layout probe puts between two convs on the
(H, W, B, C) view of a conv activation. The kernel is ``csrc/layout.cu``.
:func:`ident_plan` makes its launch plan on the host from the shape and the
strides: the dimensions folded by stride into one run, copied in 16-byte
vectors where both tensors start 16-byte aligned and element by element
otherwise. Each thread of a grid that covers the run copies one vector. The output has the input's strides,
so the permuted channels-last activation of a cuDNN conv comes out in the
same byte order and the next conv takes it as it is.

The plain version, ``torch.empty_like(t).copy_(t)``, is also the one library
call that computes the same function; its time is the kernel's yardstick.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adipose_tpu_torch.ops.cuda import build


def ident_hwbc_plain(t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ident_hwbc`: a copy with ``t``'s
    strides where ``t`` is dense."""
    return torch.empty_like(t).copy_(t)


class IdentPlan(NamedTuple):
    """How kernel I copies one dense tensor: one run of ``run_len``
    elements, as whole vectors of ``vec`` elements (8, 16 bytes; or 1), then
    ``tail`` single elements."""
    run_len: int
    vec: int
    tail: int


def coalesce(shape, strides) -> list[tuple[int, int]]:
    """``(size, stride)`` dimensions that reach the same element offsets as
    ``shape`` and ``strides``, folded as PyTorch's TensorIterator folds them:
    size-1 dimensions dropped, the rest sorted by stride, and each one whose
    stride is the size times the stride of the one inside it merged into it.
    Innermost first; a tensor of one element is ``[(1, 1)]``."""
    merged: list[tuple[int, int]] = []
    for size, stride in sorted(((n, s) for n, s in zip(shape, strides) if n != 1),
                               key=lambda d: d[1]):
        if merged and stride == merged[-1][0] * merged[-1][1]:
            merged[-1] = (merged[-1][0] * size, merged[-1][1])
        else:
            merged.append((size, stride))
    return merged or [(1, 1)]


def ident_plan(shape, strides, x_addr: int, out_addr: int) -> IdentPlan:
    """Kernel I's plan for a bf16 tensor of ``shape`` and ``strides``
    (elements) at byte address ``x_addr``, copied to ``out_addr`` with the
    same strides.

    The dimensions must fold into one run of stride 1, as every dense tensor
    does. The run goes in 16-byte vectors where both addresses are 16-byte
    aligned (the output, a fresh allocation, always is), element by element
    where the input is not."""
    runs = coalesce(shape, strides)
    if len(runs) != 1 or runs[0][1] != 1:
        raise ValueError(f"ident_plan: shape {tuple(shape)} and strides {tuple(strides)} fold "
                         f"into {runs}, not one run of stride 1")
    n = runs[0][0]
    vec = 8 if (x_addr | out_addr) % 16 == 0 else 1
    return IdentPlan(n, vec, n % vec)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its span of memory once each, in some
    order of its dimensions (non-overlapping and dense): whether they fold
    into one run of stride 1."""
    runs = coalesce(t.shape, t.stride())
    return len(runs) == 1 and runs[0][1] == 1


def ident_hwbc(t: torch.Tensor) -> torch.Tensor:
    """Copy ``t`` into a new tensor with the same strides.

    Args:
      t: (H, W, B, C) bfloat16, non-overlapping and dense, C's stride 1;
        for example ``y.permute(2, 3, 0, 1)`` of a channels-last (B, C, H, W)
        conv activation ``y``.

    Returns:
      (H, W, B, C) bfloat16 equal to ``t``, with ``t``'s strides.
    """
    if t.device.type == "cpu":
        return ident_hwbc_plain(t)
    if t.dtype != torch.bfloat16:
        raise TypeError(f"ident_hwbc: needs bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.numel() == 0:
        raise ValueError(f"ident_hwbc: needs a non-empty (H, W, B, C) tensor, got "
                         f"{tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"ident_hwbc: C's stride must be 1, got strides {t.stride()}")
    if not _dense(t):
        raise ValueError(f"ident_hwbc: needs a non-overlapping and dense tensor, got shape "
                         f"{tuple(t.shape)} and strides {t.stride()}")
    if not t.is_cuda:
        raise ValueError(f"ident_hwbc: t on {t.device}, needs one CUDA device")
    out = torch.empty_like(t)
    if any(a != b for a, b, n in zip(out.stride(), t.stride(), t.shape) if n > 1):
        raise RuntimeError(f"ident_hwbc: empty_like gave strides {out.stride()} for "
                           f"{t.stride()}")
    plan = ident_plan(t.shape, t.stride(), t.data_ptr(), out.data_ptr())
    index, stream = build.launch_target(t.device)
    code = build.library().adipose_layout_ident(index, t.data_ptr(), out.data_ptr(),
                                                plan.run_len, plan.vec, stream)
    build.check(code, "ident_hwbc")
    ident_hwbc.launches += 1
    return out


ident_hwbc.launches = 0
