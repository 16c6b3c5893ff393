"""Identity copy of a 4-D bf16 tensor over its logical (H, W, B, C) view:
CUDA kernel and plain version.

Replaces the TPU kernel ``pallas_ident_hwbc`` (``scripts/exp_layout_probe.py:37``,
body ``ident_kernel``), which the layout probe puts between two convs on the
(H, W, B, C) view of a conv activation. The kernel is ``csrc/layout.cu``: one
block per h, as the Pallas grid, copying its (W, B, C) slab by the input's
strides with 16-byte vectors along C where a row is aligned. The output has
the input's strides, so the permuted channels-last activation of a cuDNN
conv comes out in the same byte order and the next conv takes it as it is.

The plain version, ``torch.empty_like(t).copy_(t)``, is also the one library
call that computes the same function; its time is the kernel's yardstick.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda import build


def ident_hwbc_plain(t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ident_hwbc`: a copy with ``t``'s
    strides where ``t`` is dense."""
    return torch.empty_like(t).copy_(t)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its span of memory once each, in some
    order of its dimensions (non-overlapping and dense)."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


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
    index, stream = build.launch_target(t.device)
    code = build.library().adipose_layout_ident(index, t.data_ptr(), out.data_ptr(), *t.shape,
                                                *t.stride(), stream)
    build.check(code, "ident_hwbc")
    ident_hwbc.launches += 1
    return out


ident_hwbc.launches = 0
