"""The D4 symmetry group on square tiles (``adipose_tpu/ops/d4.py``).

Transform ids, as in the JAX package (spatial axes are the first two of a
single tile, the last two of a batch):

  0: identity            4: fliplr
  1: rot90               5: fliplr -> rot90
  2: rot180              6: fliplr -> rot180
  3: rot270              7: fliplr -> rot270

:func:`apply_transform_batch` applies one id per sample of a (B, N, N) batch
in one launch of the D4 kernel (:mod:`adipose_tpu_torch.ops.cuda.d4`), with
the ids on the device. Test-time augmentation makes its views with
:func:`tta_views` and undoes them with :func:`tta_collapse`: one launch each.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch

NUM_TRANSFORMS = 8

# De-augmentation table: the inverse of each transform id, as a transform id.
INVERSE_IDS = (0, 3, 2, 1, 4, 5, 6, 7)

# The reference's named TTA modes as id subsets.
# 'minimal': identity, fliplr (full_evaluation_enhanced.py:551-554)
# 'basic':   identity, fliplr, flipud, rot90 (:556-561); flipud = rot180.fliplr = id 6
MODE_IDS = {
    "minimal": (0, 4),
    "basic": (0, 4, 6, 1),
    "full": (0, 1, 2, 3, 4, 5, 6, 7),
}

# Classifier TTA modes: 'basic' is the four rotations, 'full' adds their
# horizontal flips (classification_inference.py:323-348).
CLASSIFIER_MODE_IDS = {
    "basic": (0, 1, 2, 3),
    "full": (0, 1, 2, 3, 4, 5, 6, 7),
}


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


def expand_tta(x: torch.Tensor, num: int = 8) -> torch.Tensor:
    """All ``num`` D4 views of one (H, W[, C]) tile -> (num, H, W[, C])."""
    return torch.stack([apply_transform(x, t) for t in range(num)])


def _mean_of_views(views) -> torch.Tensor:
    """The mean of a sequence of equal-shape maps, summed in order and then
    divided, as XLA reduces the JAX package's ``jnp.mean(axis=0)``."""
    total = views[0]
    for v in views[1:]:
        total = total + v
    return total / len(views)


def collapse_tta(views: torch.Tensor, num: int = 8) -> torch.Tensor:
    """De-augment (num, H, W[, C]) predictions and average -> (H, W[, C])."""
    return _mean_of_views([invert_transform(views[t], t) for t in range(num)])


def tta_view_ids(ids, batch: int, device) -> torch.Tensor:
    """The (n * batch,) int32 id of each view, view-major as the JAX
    package's (n, B) views: ``ids[k]`` for views ``k * batch .. k * batch +
    batch - 1``."""
    return torch.tensor(ids, dtype=torch.int32).repeat_interleave(batch).to(device)


def tta_views(images: torch.Tensor, view_ids: torch.Tensor) -> torch.Tensor:
    """The (n * B, N, N) views of a (B, N, N) float32 batch in one launch of
    the D4 kernel: view ``k * B + b`` is image b under ``view_ids[k * B + b]``
    (from :func:`tta_view_ids`)."""
    n = view_ids.shape[0] // images.shape[0]
    return apply_transform_batch(images.repeat(n, 1, 1), view_ids)


def tta_collapse(preds: torch.Tensor, view_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Undo each view of (n * B, N, N) float32 predictions with the inverse
    of its id (one launch of the D4 kernel) and average the n views of each
    image -> (B, N, N)."""
    restored = invert_transform_batch(preds.contiguous(), view_ids)
    return _mean_of_views(restored.view(n, -1, *preds.shape[1:]))
