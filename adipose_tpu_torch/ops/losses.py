"""Segmentation and classifier losses (``adipose_tpu/ops/losses.py``): the
U-Net trainer's selection, the reference's coefficient and border-weighted
losses (``src/utils/model.py:8-153``), its one-hot metrics and the
classifier's label-smoothed BCE.

Masks and probabilities are (B, H, W) float tensors (any shape where the
losses flatten); probabilities are post-softmax / post-sigmoid values in
[0, 1], as the Keras losses received them. Keras's binary cross-entropy
reduces over the last axis before the remaining axes are averaged, so OHEM's
``granularity="row"`` ranks per-row means (``train_adipose_unet_v3.py:296-310``);
``"pixel"`` ranks true per-pixel losses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPSILON = 1e-7  # K.epsilon()


def dice_coef(y_true: torch.Tensor, y_pred: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Global soft Dice with smooth = 1 (``src/utils/model.py:93-98``)."""
    yt = y_true.reshape(-1).to(torch.float32)
    yp = y_pred.reshape(-1).to(torch.float32)
    intersection = torch.sum(yt * yp)
    return (2.0 * intersection + smooth) / (torch.sum(yt) + torch.sum(yp) + smooth)


def dice_coef_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """``-dice_coef`` (``src/utils/model.py:100-101``)."""
    return -1.0 * dice_coef(y_true, y_pred)


def _jaccard(y_true: torch.Tensor, y_pred_num: torch.Tensor, y_pred: torch.Tensor):
    """Mean over the non-reduced axes of (I + eps) / (sum - I + eps), I and
    sum reduced over (batch, H, W), as the reference's axes=(0, -1, -2)."""
    yt = y_true.to(torch.float32)
    axes = (0, yt.dim() - 1, yt.dim() - 2)
    intersection = torch.sum(yt * y_pred_num, dim=axes)
    union_sum = torch.sum(yt + y_pred, dim=axes)
    return torch.mean((intersection + EPSILON) / (union_sum - intersection + EPSILON))


def jaccard_coef(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Soft Jaccard reduced over (batch, H, W) (``src/utils/model.py:8-12``)."""
    yp = y_pred.to(torch.float32)
    return _jaccard(y_true, yp, yp)


def jaccard_coef_int(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Jaccard with rounded predictions in the intersection and the soft
    sum in the denominator, as the reference (``src/utils/model.py:14-19``)."""
    yp = y_pred.to(torch.float32)
    return _jaccard(y_true, torch.round(yp.clamp(0.0, 1.0)), yp)


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


# ---- border-weighted losses (src/utils/model.py:103-153) ------------------------


def _border_weight(y_true: torch.Tensor, kernel_size: int = 21) -> torch.Tensor:
    """Border weight map with its mean preserved (``src/utils/model.py:106-116``):
    the SAME-padded kernel_size^2 window mean of the mask (over the valid
    pixels), border where it lies in (0.005, 0.995), border weight tripled,
    then the map rescaled so its sum is the uniform map's."""
    yt = y_true.to(torch.float32)
    squeeze = yt.dim() == 2
    x = (yt[None] if squeeze else yt)[:, None]  # (B, 1, H, W)
    pool = dict(kernel_size=kernel_size, stride=1, padding=kernel_size // 2,
                count_include_pad=True, divisor_override=1)
    averaged = F.avg_pool2d(x, **pool) / F.avg_pool2d(torch.ones_like(x), **pool)
    border = ((averaged > 0.005) & (averaged < 0.995)).to(torch.float32)
    weight = torch.ones_like(averaged)
    w0 = torch.sum(weight)
    weight = weight + border * 2.0
    weight = (weight * (w0 / torch.sum(weight)))[:, 0]
    return weight[0] if squeeze else weight


def weighted_dice_coeff(y_true: torch.Tensor, y_pred: torch.Tensor, weight: torch.Tensor,
                        smooth: float = 1.0) -> torch.Tensor:
    """(``src/utils/model.py:120-125``): the weight enters squared."""
    w = weight.to(torch.float32) ** 2
    m1, m2 = y_true.to(torch.float32), y_pred.to(torch.float32)
    return (2.0 * torch.sum(w * (m1 * m2)) + smooth) / (
        torch.sum(w * m1) + torch.sum(w * m2) + smooth)


def weighted_dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """(``src/utils/model.py:103-118``)."""
    return 1.0 - weighted_dice_coeff(y_true, y_pred, _border_weight(y_true))


def weighted_bce(y_true: torch.Tensor, y_pred: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted BCE in the stable logit form (``src/utils/model.py:127-136``)."""
    yt = y_true.to(torch.float32)
    yp = y_pred.to(torch.float32).clamp(EPSILON, 1.0 - EPSILON)
    logit = torch.log(yp / (1.0 - yp))
    loss = (1.0 - yt) * logit + (1.0 + (weight - 1.0) * yt) * (
        torch.log1p(torch.exp(-torch.abs(logit))) + torch.clamp(-logit, min=0.0))
    return torch.sum(loss) / torch.sum(weight)


def weighted_bce_dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Border-weighted BCE + border-weighted Dice (``src/utils/model.py:139-153``)."""
    weight = _border_weight(y_true)
    return weighted_bce(y_true, y_pred, weight) + (
        1.0 - weighted_dice_coeff(y_true, y_pred, weight))


# ---- one-hot classification metrics (src/utils/model.py:64-91) -------------------


def _onehot_counts(y_true: torch.Tensor, y_pred: torch.Tensor):
    """(true positives, predicted positives, actual positives) of the
    argmax class, each a rounded clipped sum as the reference's."""
    yt = torch.argmax(y_true, dim=-1).to(torch.float32)
    yp = torch.argmax(y_pred, dim=-1).to(torch.float32)
    count = lambda v: torch.sum(torch.round(v.clamp(0.0, 1.0)))  # noqa: E731
    return count(yt * yp), count(yp), count(yt)


def precision_onehot(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Argmax-based precision for one-hot outputs (``src/utils/model.py:64-73``)."""
    tp, predicted, _ = _onehot_counts(y_true, y_pred)
    return tp / (predicted + EPSILON)


def recall_onehot(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """(``src/utils/model.py:75-84``)."""
    tp, _, possible = _onehot_counts(y_true, y_pred)
    return tp / (possible + EPSILON)


def fmeasure_onehot(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """(``src/utils/model.py:86-91``)."""
    p, r = precision_onehot(y_true, y_pred), recall_onehot(y_true, y_pred)
    return 2.0 * (p * r) / (p + r + EPSILON)


# ---- classifier loss ---------------------------------------------------------------


def bce_with_label_smoothing(y_true: torch.Tensor, y_pred: torch.Tensor,
                             label_smoothing: float = 0.1) -> torch.Tensor:
    """Keras ``BinaryCrossentropy(label_smoothing=s)``: y -> y (1 - s) + s / 2,
    then the mean BCE (``Classification/train_adipose_classifier_v0.py:369-378``)."""
    yt = y_true.to(torch.float32) * (1.0 - label_smoothing) + 0.5 * label_smoothing
    return torch.mean(binary_crossentropy(yt, y_pred))
