"""The classifier's inference input path (``adipose_tpu/train/trainer_classifier.py``).

Only what serving needs: :func:`make_inception_preprocess` and
:func:`_make_val_step`, which the WSI cascade's classifier gate calls as
``_make_val_step(model, True, 1.0, 99.0)``. Training waits for its slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from adipose_tpu_torch.ops.normalize import batched_percentile_unit_fast

INCEPTION_SIZE = 299


def make_inception_preprocess(percentile_norm: bool = True, p_low: float = 1.0,
                              p_high: float = 99.0):
    """(B, H, W) grayscale or (B, H, W, 3) RGB uint8/float tiles ->
    (B, 299, 299, 3) float32 Inception input.

    The reference's ``_preprocess`` (``train_adipose_classifier_v0.py:251-298``):
    optional per-tile percentile stretch back to [0, 255], bilinear resize
    to 299^2, grayscale tiled to 3 channels, then ``x / 127.5 - 1``. The
    resize is ``jax.image.resize(..., "bilinear")``, which antialiases when
    it shrinks: ``F.interpolate`` needs ``antialias=True`` to match it
    (without it, 1024^2 -> 299^2 differs by up to 139 grey levels).
    """
    def resize(x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W)
        return F.interpolate(x, size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                             align_corners=False, antialias=True)

    def preprocess(images: torch.Tensor) -> torch.Tensor:
        if percentile_norm:
            imgs = batched_percentile_unit_fast(images, p_low, p_high) * 255.0
        else:
            imgs = images.to(torch.float32)
        if imgs.dim() == 4:  # RGB: no channel tiling
            x = resize(imgs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            x = resize(imgs[:, None]).permute(0, 2, 3, 1).expand(-1, -1, -1, 3)
        return x / 127.5 - 1.0

    return preprocess


def _make_val_step(model: torch.nn.Module, percentile_norm: bool, p_low: float,
                   p_high: float):
    """``step(state, images)``: preprocess a tile batch and run the
    classifier under ``torch.inference_mode()`` with ``state`` (its state
    dict, the JAX ``params`` and ``batch_stats`` together, on the images'
    device) in place of the module's own. Returns (B,) probabilities."""
    pre = make_inception_preprocess(percentile_norm, p_low, p_high)
    model.eval()

    def step(state: dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return functional_call(model, state, (pre(images),), strict=True)

    return step
