"""The dilated-bottleneck U-Net as published
(``Segmentation/train_adipose_unet_v3.py:660-758``), plain float32.

  encoder    three levels of Conv3x3-ReLU x2 -> MaxPool2, at init_nb x (1, 2, 4)
  bottleneck six Conv3x3-ReLU at 8 init_nb, dilation 1..32, each fed the
             one before, dropout after the first, all six summed
  decoder    three levels of nearest-x2 upsample -> Conv3x3-ReLU -> concat
             with the encoder's map (skip first) -> Conv3x3-ReLU x2 -> dropout
  head       Conv1x1 to 2 classes -> softmax -> class 1
  aux heads  Conv1x1-sigmoid at the /4 and /2 decoder levels, resized
             bilinearly (half-pixel centres) to the tile

Weights are a dict of (out, in, kh, kw) kernels and biases keyed
``<layer>.weight`` / ``<layer>.bias``, the names of the published layers.
Dropout (rate 0.3) is Flax's: keep where a uniform is below 0.7, scale by
1 / 0.7; ``dropout(shape)`` gives the keep-mask of a (B, C, H, W) map, or
None outside training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import conv_input

DROPOUT_RATE = 0.3


def conv(x, params, name, quant="fp32", dilation=1):
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    x, w = conv_input(x, w, quant)
    pad = dilation * (w.shape[-1] // 2)
    return F.conv2d(x, w, b, padding=pad, dilation=dilation)


def _drop(x, dropout):
    keep = None if dropout is None else dropout(x.shape)
    if keep is None:
        return x
    keep_prob = 1.0 - DROPOUT_RATE
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def forward(params: dict, x: torch.Tensor, rates=(1, 2, 4, 8, 16, 32),
            deep_supervision: bool = False, dropout=None, quant: str = "fp32"):
    """Class-1 probabilities (B, H, W) of a (B, H, W) float32 input, or with
    ``deep_supervision`` a dict ``main_out``, ``aux_out1``, ``aux_out2``."""
    h, w = x.shape[-2:]
    x = x[:, None].to(torch.float32)

    def block(y, names):
        for name in names:
            y = F.relu(conv(y, params, name, quant))
        return y

    down1 = block(x, ("down1_conv1", "down1_conv2"))
    down2 = block(F.max_pool2d(down1, 2), ("down2_conv1", "down2_conv2"))
    down3 = block(F.max_pool2d(down2, 2), ("down3_conv1", "down3_conv2"))
    d = F.max_pool2d(down3, 2)
    total = None
    for i, rate in enumerate(rates):
        d = F.relu(conv(d, params, f"dilate{i + 1}", quant, dilation=rate))
        if i == 0:
            d = _drop(d, dropout)
        total = d if total is None else total + d
    y = total
    ups = {}
    for level, skip in ((3, down3), (2, down2), (1, down1)):
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        y = F.relu(conv(y, params, f"up{level}_conv1", quant))
        y = block(torch.cat([skip, y], dim=1), (f"up{level}_conv2", f"up{level}_conv3"))
        y = _drop(y, dropout)
        ups[level] = y
    main = torch.softmax(conv(ups[1], params, "output_softmax", quant), dim=1)[:, 1]
    if not deep_supervision:
        return main

    def aux(name, level):
        p = torch.sigmoid(conv(ups[level], params, name, quant))
        return F.interpolate(p, size=(h, w), mode="bilinear", align_corners=False)[:, 0]

    return {"main_out": main, "aux_out1": aux("aux_out1", 3), "aux_out2": aux("aux_out2", 2)}


def zscore(tiles: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """The dataset z-score ``(x - mean) / (std + 1e-10)`` in float32."""
    return (tiles.to(torch.float32) - mean) / (std + 1e-10)
