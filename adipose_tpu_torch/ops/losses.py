"""Segmentation losses (``adipose_tpu/ops/losses.py``): the ones the U-Net
trainer's loss selection uses.

Masks and probabilities are (B, H, W) float tensors (any shape where the
losses flatten); probabilities are post-softmax / post-sigmoid values in
[0, 1], as the Keras losses received them. Keras's binary cross-entropy
reduces over the last axis before the remaining axes are averaged, so OHEM's
``granularity="row"`` ranks per-row means (``train_adipose_unet_v3.py:296-310``);
``"pixel"`` ranks true per-pixel losses.
"""

from __future__ import annotations

import torch

EPSILON = 1e-7  # K.epsilon()


def dice_coef(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Global soft Dice with smooth = 1 (``src/utils/model.py:93-98``)."""
    yt = y_true.reshape(-1).to(torch.float32)
    yp = y_pred.reshape(-1).to(torch.float32)
    intersection = torch.sum(yt * yp)
    return (2.0 * intersection + smooth) / (torch.sum(yt) + torch.sum(yp) + smooth)


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """1 - soft Dice on clipped probabilities (``train_adipose_unet_v3.py:218-227``)."""
    yp = y_pred.to(torch.float32).clamp(EPSILON, 1.0 - EPSILON).reshape(-1)
    yt = y_true.reshape(-1).to(torch.float32)
    intersection = torch.sum(yt * yp)
    score = (2.0 * intersection + smooth) / (torch.sum(yt) + torch.sum(yp) + smooth)
    return 1.0 - score


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, clipped like Keras."""
    yt = y_true.to(torch.float32)
    yp = y_pred.to(torch.float32).clamp(EPSILON, 1.0 - EPSILON)
    return -(yt * torch.log(yp) + (1.0 - yt) * torch.log(1.0 - yp))


def combined_loss_standard(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Mean BCE + Dice loss (``train_adipose_unet_v3.py:229-241``)."""
    return torch.mean(binary_crossentropy(y_true, y_pred)) + dice_loss(y_true, y_pred)


def smooth_labels(y_true: torch.Tensor, epsilon_pos: float = 0.03,
                  epsilon_neg: float = 0.07) -> torch.Tensor:
    """Asymmetric label smoothing: 1 -> 1 - eps_pos - eps_neg, 0 -> eps_neg
    (``train_adipose_unet_v3.py:273-275``)."""
    return y_true.to(torch.float32) * (1.0 - epsilon_pos - epsilon_neg) + epsilon_neg


def combined_loss_with_label_smoothing(y_true: torch.Tensor, y_pred: torch.Tensor,
                                       epsilon_pos: float = 0.03,
                                       epsilon_neg: float = 0.07) -> torch.Tensor:
    """BCE + Dice on asymmetrically smoothed labels (``train_adipose_unet_v3.py:244-280``)."""
    return combined_loss_standard(smooth_labels(y_true, epsilon_pos, epsilon_neg), y_pred)


def ohem_loss(y_true: torch.Tensor, y_pred: torch.Tensor, keep_ratio: float = 0.7,
              granularity: str = "row") -> torch.Tensor:
    """Online hard example mining: the mean of the top-k hardest BCE terms
    per sample plus the global Dice loss (``train_adipose_unet_v3.py:282-318``)."""
    yt = y_true.to(torch.float32)
    per_pixel = binary_crossentropy(yt, y_pred)
    if granularity == "row":
        ranked = torch.mean(per_pixel, dim=-1)  # Keras last-axis reduction
    elif granularity == "pixel":
        ranked = per_pixel
    else:
        raise ValueError(f"granularity must be 'row' or 'pixel', got {granularity}")
    flat = ranked.reshape(ranked.shape[0], -1)
    k = max(1, int(flat.shape[1] * keep_ratio))
    hard_bce = torch.mean(torch.topk(flat, k, dim=1).values)
    return hard_bce + dice_loss(yt, y_pred)


def ohem_loss_with_smoothing(y_true: torch.Tensor, y_pred: torch.Tensor,
                             keep_ratio: float = 0.7, epsilon_pos: float = 0.03,
                             epsilon_neg: float = 0.07, granularity: str = "row") -> torch.Tensor:
    """OHEM on smoothed labels (``train_adipose_unet_v3.py:320-360``)."""
    return ohem_loss(smooth_labels(y_true, epsilon_pos, epsilon_neg), y_pred,
                     keep_ratio=keep_ratio, granularity=granularity)


def deep_supervision_loss(y_true: torch.Tensor, outputs: dict, loss_fn_main, loss_fn_aux,
                          weight_main: float = 1.0, weight_aux1: float = 0.4,
                          weight_aux2: float = 0.3) -> torch.Tensor:
    """Weighted multi-head loss (``train_adipose_unet_v3.py:839-855``): one
    target supervises main_out, aux_out1 and aux_out2."""
    total = weight_main * loss_fn_main(y_true, outputs["main_out"])
    total = total + weight_aux1 * loss_fn_aux(y_true, outputs["aux_out1"])
    return total + weight_aux2 * loss_fn_aux(y_true, outputs["aux_out2"])
