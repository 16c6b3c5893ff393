"""The D4 symmetry group on square tiles (``adipose_tpu/ops/d4.py``).

Transform ids, as in the JAX package (spatial axes are the first two of a
single tile, the last two of a batch):

  0: identity            4: fliplr
  1: rot90               5: fliplr -> rot90
  2: rot180              6: fliplr -> rot180
  3: rot270              7: fliplr -> rot270

:func:`apply_transform_batch` applies one id per sample of a (B, N, N) batch
in one launch of the D4 kernel (:mod:`adipose_tpu_torch.ops.cuda.d4`), with
the ids on the device.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch

# De-augmentation table: the inverse of each transform id, as a transform id.
INVERSE_IDS = (0, 3, 2, 1, 4, 5, 6, 7)


def _branch(x: torch.Tensor, transform_id: int) -> torch.Tensor:
    flipped = x.flip(1) if transform_id >= 4 else x
    return torch.rot90(flipped, transform_id % 4, dims=(0, 1))


def apply_transform(x: torch.Tensor, transform_id: int) -> torch.Tensor:
    """Apply D4 transform ``transform_id``; spatial axes are (0, 1)."""
    return _branch(x, int(transform_id))


def invert_transform(x: torch.Tensor, transform_id: int) -> torch.Tensor:
    """Apply the inverse of a transform id (for de-augmenting predictions)."""
    return _branch(x, INVERSE_IDS[int(transform_id)])


def _ids_on(x: torch.Tensor, transform_ids) -> torch.Tensor:
    return torch.as_tensor(transform_ids, dtype=torch.int32).to(x.device).contiguous()


def apply_transform_batch(x: torch.Tensor, transform_ids) -> torch.Tensor:
    """Per-sample D4 transforms over a (B, N, N) float32 batch of SQUARE
    tiles; ``transform_ids`` (B,) int32, best already on x's device."""
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"apply_transform_batch needs (B, N, N), got {tuple(x.shape)}")
    return d4_transform_batch(x, _ids_on(x, transform_ids))


def invert_transform_batch(x: torch.Tensor, transform_ids) -> torch.Tensor:
    """Batched inverse of :func:`apply_transform_batch` (same id vector)."""
    ids = _ids_on(x, transform_ids)
    inverse = torch.tensor(INVERSE_IDS, dtype=torch.int32, device=x.device)
    return apply_transform_batch(x, inverse[ids.long().clamp(0, 7)])
