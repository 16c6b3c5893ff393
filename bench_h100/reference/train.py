"""One U-Net training step as the reference trains it, plain float32: the
tier's augmentation, the per-tile percentile stretch to [0, 1], the
forward with dropout and both auxiliary heads, the deep-supervision loss
(OHEM on the main output, BCE + Dice on the auxiliary ones,
``train_adipose_unet_v3.py:282-318,839-855``), the gradients and the
Keras Adam update.

``gen`` is a generator in the state the trainer's is in before the step:
the step draws the augmentation and then the dropout masks from it, in the
trainer's order, so both see the same draws.
"""

from __future__ import annotations

import math

import torch

from bench_h100.reference import augment, unet
from bench_h100.reference.inception import percentile_unit

EPSILON = 1e-7  # Keras's K.epsilon()


def bce(y, p):
    p = p.clamp(EPSILON, 1.0 - EPSILON)
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def dice_loss(y, p, smooth: float = 1.0):
    p = p.clamp(EPSILON, 1.0 - EPSILON)
    return 1.0 - (2.0 * (y * p).sum() + smooth) / (y.sum() + p.sum() + smooth)


def bce_dice(y, p):
    return bce(y, p).mean() + dice_loss(y, p)


def ohem(y, p, keep: float = 0.7):
    """The mean of each tile's hardest rows' BCE (Keras reduces the last
    axis first, so rows are ranked by their mean) plus the Dice loss."""
    rows = bce(y, p).mean(dim=-1)
    k = max(1, int(rows.shape[1] * keep))
    return torch.topk(rows, k, dim=1).values.mean() + dice_loss(y, p)


def deep_supervision_loss(y, out, keep: float = 0.7, weights=(1.0, 0.4, 0.3)):
    return (weights[0] * ohem(y, out["main_out"], keep)
            + weights[1] * bce_dice(y, out["aux_out1"])
            + weights[2] * bce_dice(y, out["aux_out2"]))


class KerasAdam:
    """Keras Adam: m += (1 - b1)(g - m); v += (1 - b2)(g^2 - v);
    p -= lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps)."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-7):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        alpha = math.sqrt(1.0 - self.b2 ** self.t) / (1.0 - self.b1 ** self.t)
        for k, p in params.items():
            g = grads[k]
            self.m[k] += (1.0 - self.b1) * (g - self.m[k])
            self.v[k] += (1.0 - self.b2) * (g * g - self.v[k])
            p -= self.lr * alpha * self.m[k] / (self.v[k].sqrt() + self.eps)


def step(params: dict, opt: KerasAdam, gen: torch.Generator, images_u8, masks_u8,
         config: dict, traffic: dict, quant: str = "fp32") -> tuple[float, dict]:
    """One step on (B, H, W) uint8 tiles and masks; returns (loss, grads)
    and updates ``params`` in place."""
    b, h, w = images_u8.shape
    draws = augment.draw(gen, traffic["augment_level"], b, h, w)
    images, masks = augment.apply(draws, images_u8.to(torch.float32),
                                  masks_u8.to(torch.float32), traffic["augment_level"])
    x = percentile_unit(images, traffic["percentile_low"], traffic["percentile_high"])
    keep_prob = 1.0 - unet.DROPOUT_RATE

    def dropout(shape):
        n, c, hh, ww = shape
        u = torch.rand((n, hh, ww, c), generator=gen, device=gen.device)
        return u.permute(0, 3, 1, 2) < keep_prob

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = unet.forward(leaves, x, config["dilation_rates"], deep_supervision=True,
                       dropout=dropout, quant=quant)
    loss = deep_supervision_loss(masks, out, traffic["ohem_ratio"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    del out
    opt.step(params, grads)
    return float(loss.detach()), grads
