"""Test-time augmentation (``adipose_tpu/eval/tta.py``): one batched
forward per tile chunk.

Modes, as in ``TestTimeAugmentation`` (``full_evaluation_enhanced.py:522-600``):
minimal (identity + fliplr), basic (+ flipud, rot90), full (the 8-member
D4); predictions are de-augmented and averaged. Classifier TTA averages the
same D4 views in logit space (``eval_adipose_classifier.py:98-102,311-336``).

The n views of a (B, N, N) chunk are stacked view-major into one (n * B, N,
N) batch by one launch of the D4 kernel, pushed through one forward, and
undone by a second launch with the inverse ids. The views are made from the
raw tiles, before the z-score: the z-score is the same affine map on every
pixel, so it commutes with a permutation of the pixels.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.ops.d4 import (CLASSIFIER_MODE_IDS, MODE_IDS, apply_transform,
                                      tta_collapse, tta_view_ids, tta_views)


def _view_ids_for(ids):
    """``view_ids(batch, device)``: :func:`tta_view_ids` made once per batch
    size and device, so no predict waits on a host-to-device copy."""
    made: dict = {}

    def view_ids(batch: int, device) -> torch.Tensor:
        key = (batch, str(device))
        if key not in made:
            made[key] = tta_view_ids(ids, batch, device)
        return made[key]

    return view_ids


def make_tta_predict(predict_fn, mode: str = "basic"):
    """Wrap ``predict_fn(params, images (B, H, W)) -> (B, H, W)`` with
    batched TTA; an unknown mode is 'basic', as in the JAX package.

    Returns ``tta_predict(params, images) -> (B, H, W)`` float32, the mean of
    the mode's de-augmented views. ``images`` are square uint8 or float32
    tiles; they are cast to float32 for the D4 kernel.
    """
    ids = MODE_IDS[mode if mode in MODE_IDS else "basic"]
    n = len(ids)
    view_ids = _view_ids_for(ids)

    def tta_predict(params, images: torch.Tensor) -> torch.Tensor:
        vids = view_ids(images.shape[0], images.device)
        preds = predict_fn(params, tta_views(images.to(torch.float32), vids))
        return tta_collapse(preds, vids, n)

    return tta_predict


def make_classifier_tta_predict(predict_fn, mode: str = "full", logit_space: bool = True):
    """Classifier TTA: average ``predict_fn(variables, views) -> (n * B,)``
    probabilities over the D4 views of each input tile; an unknown mode is
    'full'. A (B, N, N) batch goes through the D4 kernel as float32; a
    channel-last (B, H, W, C) batch is transformed sample by sample. With
    ``logit_space`` the views' clipped logits are averaged
    (``eval_adipose_classifier.py:324-336``)."""
    ids = CLASSIFIER_MODE_IDS.get(mode, CLASSIFIER_MODE_IDS["full"])
    n = len(ids)
    view_ids = _view_ids_for(ids)

    def tta_predict(variables, images: torch.Tensor) -> torch.Tensor:
        with tracing.span("tta.predict"):
            b = images.shape[0]
            with tracing.span("tta.views", device=True):
                if images.dim() == 3:
                    views = tta_views(images.to(torch.float32), view_ids(b, images.device))
                else:
                    views = torch.cat([torch.stack([apply_transform(im, t) for im in images])
                                       for t in ids])
            probs = predict_fn(variables, views)
            with tracing.span("tta.collapse"):
                probs = probs.reshape(n, b)
                if logit_space:
                    p = probs.clamp(1e-7, 1 - 1e-7)
                    return torch.sigmoid(torch.log(p / (1 - p)).mean(0))
                return probs.mean(0)

    return tta_predict
