"""Per-sample D4 transform of a (B, N, N) float32 batch: CUDA kernel and
plain version.

Replaces the TPU kernel ``pin_default_layout``
(``adipose_tpu/ops/pallas/layout.py:29``) at its only site,
``apply_transform_batch`` (``adipose_tpu/ops/d4.py:101``). The Pallas kernel
is an identity copy that pins the transposed batch to the default TPU
layout; PyTorch has no layout assignment for such a copy to steer, so the
port's kernel is the whole transform the pin guards. Each sample's id
selects (transpose, flip rows, flip columns) from the tables
``_D4_TRANSPOSE``, ``_D4_FLIP_H`` and ``_D4_FLIP_W``. The kernel is
``csrc/d4.cu``; it is bound by device memory (one read and one write of each
element) and moves 32x32 tiles through shared memory so that both sides are
coalesced. It reads the ids from device memory, so nothing waits for the
host. It has no backward: augmentation is not differentiated, and
``pin_default_layout_grad`` has no caller in the JAX package.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda import build

# flipH^a . flipW^b . transpose^t for each id (adipose_tpu/ops/d4.py:72-74)
D4_TRANSPOSE = (0, 1, 0, 1, 0, 1, 0, 1)
D4_FLIP_H = (0, 1, 1, 0, 0, 0, 1, 1)
D4_FLIP_W = (0, 0, 1, 1, 1, 0, 0, 1)


def d4_transform_batch_plain(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`d4_transform_batch`, the JAX
    formulation: one batched transpose, then two flips, each selected per
    sample. Ids are clamped to [0, 7], as a jnp gather clamps."""
    ids = ids.to(device=x.device, dtype=torch.int64).clamp(0, 7)

    def table(values):
        return torch.tensor(values, dtype=torch.bool, device=x.device)[ids][:, None, None]

    y = torch.where(table(D4_TRANSPOSE), x.transpose(1, 2), x)
    y = torch.where(table(D4_FLIP_H), y.flip(1), y)
    return torch.where(table(D4_FLIP_W), y.flip(2), y)


def d4_transform_batch(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Apply D4 transform ``ids[b]`` to sample b of a square batch.

    Args:
      x: (B, N, N) float32, contiguous.
      ids: (B,) int32 transform ids in [0, 8), on x's device.

    Returns:
      (B, N, N) float32, a new tensor.
    """
    if x.device.type == "cpu":
        return d4_transform_batch_plain(x, ids)
    if x.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"d4_transform_batch: needs float32 x and int32 ids, got {x.dtype} "
                        f"and {ids.dtype}")
    if (x.dim() != 3 or x.shape[1] != x.shape[2] or x.numel() == 0
            or ids.shape != (x.shape[0],)):
        raise ValueError(f"d4_transform_batch: needs (B, N, N) x and (B,) ids, got "
                         f"{tuple(x.shape)} and {tuple(ids.shape)}")
    if not (x.is_contiguous() and ids.is_contiguous()):
        raise ValueError("d4_transform_batch: x and ids must be contiguous")
    if not (x.is_cuda and ids.device == x.device):
        raise ValueError(f"d4_transform_batch: x on {x.device} and ids on {ids.device}, "
                         "need one CUDA device")
    b, n, _ = x.shape
    out = torch.empty_like(x)
    index, stream = build.launch_target(x.device)
    code = build.library().adipose_d4(index, x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                                      b, n, stream)
    build.check(code, "d4_transform_batch")
    d4_transform_batch.launches += 1
    return out


d4_transform_batch.launches = 0
