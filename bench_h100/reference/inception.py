"""InceptionV3 with the reference's binary head, plain float32 (Szegedy et
al., arXiv:1512.00567, as Keras builds it; the head of
``Classification/train_adipose_classifier_v0.py:312-319``), and the
classifier's preprocess and test-time augmentation.

Each ``conv2d_bn`` is a bias-free conv, BatchNorm without scale (epsilon
1e-3, running statistics) and ReLU. Weights are a dict keyed
``backbone.cbn_<i>.conv.weight`` (out, in, kh, kw), ``backbone.cbn_<i>.bn.
{bias,mean,var}`` and ``adipose_score.{weight,bias}``, ``i`` counting the
convs in the order Keras creates them. Strided convs and pools are VALID;
stride-1 convs SAME; the 3x3 average pool of each branch averages the
valid cells only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import conv_input

BN_EPSILON = 1e-3
SIZE = 299


def topology(x, conv_bn, avg_pool, max_pool, cat):
    """The InceptionV3 graph; ``conv_bn(x, filters, kh, kw, stride=1,
    valid=False)`` is called in Keras's creation order."""
    x = conv_bn(x, 32, 3, 3, 2, True)
    x = conv_bn(x, 32, 3, 3, 1, True)
    x = conv_bn(x, 64, 3, 3)
    x = max_pool(x)
    x = conv_bn(x, 80, 1, 1, 1, True)
    x = conv_bn(x, 192, 3, 3, 1, True)
    x = max_pool(x)
    for pool_filters in (32, 64, 64):  # mixed0-2, 35 x 35
        branch1x1 = conv_bn(x, 64, 1, 1)
        branch5x5 = conv_bn(conv_bn(x, 48, 1, 1), 64, 5, 5)
        dbl = conv_bn(conv_bn(conv_bn(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        pool = conv_bn(avg_pool(x), pool_filters, 1, 1)
        x = cat([branch1x1, branch5x5, dbl, pool])
    branch3x3 = conv_bn(x, 384, 3, 3, 2, True)  # mixed3
    dbl = conv_bn(conv_bn(x, 64, 1, 1), 96, 3, 3)
    dbl = conv_bn(dbl, 96, 3, 3, 2, True)
    x = cat([branch3x3, dbl, max_pool(x)])
    for c7 in (128, 160, 160, 192):  # mixed4-7, 17 x 17
        branch1x1 = conv_bn(x, 192, 1, 1)
        b7 = conv_bn(conv_bn(conv_bn(x, c7, 1, 1), c7, 1, 7), 192, 7, 1)
        b7d = conv_bn(x, c7, 1, 1)
        for filters, kh, kw in ((c7, 7, 1), (c7, 1, 7), (c7, 7, 1), (192, 1, 7)):
            b7d = conv_bn(b7d, filters, kh, kw)
        pool = conv_bn(avg_pool(x), 192, 1, 1)
        x = cat([branch1x1, b7, b7d, pool])
    b3 = conv_bn(conv_bn(x, 192, 1, 1), 320, 3, 3, 2, True)  # mixed8
    b7 = conv_bn(conv_bn(conv_bn(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7 = conv_bn(b7, 192, 3, 3, 2, True)
    x = cat([b3, b7, max_pool(x)])
    for _ in range(2):  # mixed9-10, 8 x 8
        branch1x1 = conv_bn(x, 320, 1, 1)
        b3 = conv_bn(x, 384, 1, 1)
        b3 = cat([conv_bn(b3, 384, 1, 3), conv_bn(b3, 384, 3, 1)])
        dbl = conv_bn(conv_bn(x, 448, 1, 1), 384, 3, 3)
        dbl = cat([conv_bn(dbl, 384, 1, 3), conv_bn(dbl, 384, 3, 1)])
        pool = conv_bn(avg_pool(x), 192, 1, 1)
        x = cat([branch1x1, b3, dbl, pool])
    return x


def conv_shapes(channels: int = 3) -> list[tuple[int, int, int, int, int, bool]]:
    """(cin, filters, kh, kw, stride, valid) of every conv, in order."""
    shapes = []

    def record(c, filters, kh, kw, stride=1, valid=False):
        shapes.append((c, filters, kh, kw, stride, valid))
        return filters

    topology(channels, record, lambda c: c, lambda c: c, sum)
    return shapes


def features(params: dict, x: torch.Tensor, quant: str = "fp32") -> torch.Tensor:
    """(B, 2048, 8, 8) features of a (B, 3, 299, 299) float32 input."""
    index = iter(range(10 ** 6))

    def conv_bn(y, filters, kh, kw, stride=1, valid=False):
        p = f"backbone.cbn_{next(index)}"
        y, w = conv_input(y, params[f"{p}.conv.weight"], quant)
        pad = (0, 0) if valid else (kh // 2, kw // 2)
        y = F.conv2d(y, w, stride=stride, padding=pad)
        mean, var, bias = (params[f"{p}.bn.{k}"][:, None, None] for k in ("mean", "var", "bias"))
        return F.relu((y - mean) * torch.rsqrt(var + BN_EPSILON) + bias)

    return topology(x, conv_bn,
                    lambda y: F.avg_pool2d(y, 3, 1, 1, count_include_pad=False),
                    lambda y: F.max_pool2d(y, 3, 2),
                    lambda ys: torch.cat(ys, dim=1))


def classify(params: dict, x: torch.Tensor, quant: str = "fp32") -> torch.Tensor:
    """(B,) probabilities of (B, 3, 299, 299) inputs: global average pool,
    Dense(1) and sigmoid (dropout is off in inference)."""
    pooled = features(params, x, quant).mean(dim=(2, 3))
    return torch.sigmoid(pooled @ params["adipose_score.weight"].T
                         + params["adipose_score.bias"])[:, 0]


def percentiles(tiles: torch.Tensor, p_low: float, p_high: float):
    """numpy-'linear' percentiles of each (H, W) tile of a float32 batch,
    its values first rounded half to even: the rank p / 100 * (n - 1) split
    into floor and fraction in float32, one sort a tile."""
    flat = torch.round(tiles.reshape(tiles.shape[0], -1))
    ordered = flat.sort(dim=1).values
    n = flat.shape[1]
    out = []
    for p in (p_low, p_high):
        rank = p / 100.0 * (n - 1)
        lo = int(rank // 1)
        frac = torch.tensor(rank - lo, dtype=torch.float32)
        hi = min(lo + 1, n - 1)
        a, b = ordered[:, lo], ordered[:, hi]
        out.append(a + frac.to(a.device) * (b - a))
    return flat.reshape(tiles.shape), out[0], out[1]


def percentile_unit(tiles: torch.Tensor, p_low: float = 1.0, p_high: float = 99.0):
    """Per-tile stretch ``clip((x - P_low) / max(P_high - P_low, 1e-3), 0, 1)``."""
    x, low, high = percentiles(tiles.to(torch.float32), p_low, p_high)
    scale = (high - low).clamp_min(1e-3)
    return ((x - low[:, None, None]) / scale[:, None, None]).clamp(0.0, 1.0)


def preprocess(tiles: torch.Tensor, p_low: float = 1.0, p_high: float = 99.0) -> torch.Tensor:
    """(B, H, W) grayscale tiles -> (B, 3, 299, 299) inputs: the percentile
    stretch to [0, 255], a bilinear resize that antialiases when it
    shrinks, the gray copied to three channels, ``x / 127.5 - 1``."""
    x = percentile_unit(tiles, p_low, p_high)[:, None] * 255.0
    x = F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.expand(-1, 3, -1, -1) / 127.5 - 1.0


def d4(tile: torch.Tensor, k: int) -> torch.Tensor:
    """D4 member ``k`` of an (H, W) or (B, H, W) map: a left-right flip when
    k >= 4, then ``k % 4`` quarter turns counter-clockwise."""
    y = tile.flip(-1) if k >= 4 else tile
    return torch.rot90(y, k % 4, dims=(-2, -1))


def tta_probabilities(params: dict, tiles: torch.Tensor, views=(0, 1, 2, 3, 4, 5, 6, 7),
                      p_low: float = 1.0, p_high: float = 99.0, quant: str = "fp32",
                      block: int = 64) -> torch.Tensor:
    """(B,) probabilities of (B, H, W) tiles under test-time augmentation:
    each view classified, the views' logits (probabilities clipped to
    [1e-7, 1 - 1e-7]) averaged, the sigmoid of the mean; ``block`` views
    at a time."""
    logits = []
    for k in views:
        probs = torch.cat([classify(params, preprocess(d4(tiles[i:i + block].to(torch.float32),
                                                          k), p_low, p_high), quant)
                           for i in range(0, tiles.shape[0], block)])
        p = probs.clamp(1e-7, 1 - 1e-7)
        logits.append(torch.log(p / (1 - p)))
    return torch.sigmoid(torch.stack(logits).mean(0))
