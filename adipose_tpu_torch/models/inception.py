"""InceptionV3 tile classifier (``adipose_tpu/models/inception.py``) in
PyTorch, for inference.

The reference classifier is Keras ``InceptionV3(include_top=False)`` ->
GlobalAveragePooling -> Dropout(0.4) -> Dense(1, sigmoid)
(``Classification/train_adipose_classifier_v0.py:312-319``). Casts follow
the JAX module:

  ConvBN   bias-free conv in the compute dtype (bf16 in serving), then
           BatchNorm in float32 with running statistics, no scale and
           epsilon 1e-3, then ReLU, then a cast back to the compute dtype.
           BN is not folded into the conv: that would move bf16 roundings.
  pools    3x3/2 VALID max-pool; 3x3/1 SAME average pool that divides by
           the number of valid cells (``count_include_pad=False``, as Keras
           and the JAX module do).
  head     global average pool and Dense(2048 -> 1) in float32, sigmoid.

Every strided conv and pool is VALID; stride-1 convs are SAME. Activations
are NCHW tensors in ``torch.channels_last`` memory, so cuDNN runs NHWC.
The ``cbn_<i>`` modules are numbered in creation order, the order the JAX
module (and Keras) creates them, which the weight converter keys on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_CL = torch.channels_last
NUM_CONVS = 94


def _topology(x, cbn, avg_pool, max_pool, cat):
    """The InceptionV3 graph, written once: run on channel counts it
    records each ConvBN's shape in creation order; run on tensors it is the
    forward pass. ``cbn(x, features, kh, kw, stride=1, valid=False)``."""
    x = cbn(x, 32, 3, 3, 2, True)
    x = cbn(x, 32, 3, 3, 1, True)
    x = cbn(x, 64, 3, 3)
    x = max_pool(x)
    x = cbn(x, 80, 1, 1, 1, True)
    x = cbn(x, 192, 3, 3, 1, True)
    x = max_pool(x)
    # mixed 0..2: 35x35 Inception-A
    for pool_features in (32, 64, 64):
        b1 = cbn(x, 64, 1, 1)
        b5 = cbn(cbn(x, 48, 1, 1), 64, 5, 5)
        b3 = cbn(cbn(cbn(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = cbn(avg_pool(x), pool_features, 1, 1)
        x = cat([b1, b5, b3, bp])
    # mixed 3: 17x17 reduction
    b3 = cbn(x, 384, 3, 3, 2, True)
    b3d = cbn(cbn(x, 64, 1, 1), 96, 3, 3)
    b3d = cbn(b3d, 96, 3, 3, 2, True)
    x = cat([b3, b3d, max_pool(x)])
    # mixed 4..7: 17x17 Inception-B (factorized 7x7)
    for c7 in (128, 160, 160, 192):
        b1 = cbn(x, 192, 1, 1)
        b7 = cbn(cbn(cbn(x, c7, 1, 1), c7, 1, 7), 192, 7, 1)
        b7d = cbn(cbn(cbn(cbn(cbn(x, c7, 1, 1), c7, 7, 1), c7, 1, 7), c7, 7, 1), 192, 1, 7)
        bp = cbn(avg_pool(x), 192, 1, 1)
        x = cat([b1, b7, b7d, bp])
    # mixed 8: 8x8 reduction
    b3 = cbn(cbn(x, 192, 1, 1), 320, 3, 3, 2, True)
    b7 = cbn(cbn(cbn(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7 = cbn(b7, 192, 3, 3, 2, True)
    x = cat([b3, b7, max_pool(x)])
    # mixed 9..10: 8x8 Inception-C (expanded filter bank)
    for _ in range(2):
        b1 = cbn(x, 320, 1, 1)
        b3 = cbn(x, 384, 1, 1)
        b3 = cat([cbn(b3, 384, 1, 3), cbn(b3, 384, 3, 1)])
        b3d = cbn(cbn(x, 448, 1, 1), 384, 3, 3)
        b3d = cat([cbn(b3d, 384, 1, 3), cbn(b3d, 384, 3, 1)])
        bp = cbn(avg_pool(x), 192, 1, 1)
        x = cat([b1, b3, b3d, bp])
    return x


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kh: int, kw: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw, device=device))


class _BatchNorm(nn.Module):
    """Inference BatchNorm without scale: ``(x - mean) * rsqrt(var + eps) + bias``."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("mean", torch.empty(c, device=device))
        self.register_buffer("var", torch.empty(c, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + 1e-3)
        return (x - self.mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm (f32, no scale, eps 1e-3) -> ReLU, the
    Keras ``conv2d_bn``."""

    def __init__(self, cin: int, features: int, kh: int, kw: int, stride: int = 1,
                 valid: bool = False, device=None):
        super().__init__()
        self.conv = _Conv(cin, features, kh, kw, device=device)
        self.bn = _BatchNorm(features, device=device)
        self.stride = stride
        self.padding = (0, 0) if valid else (kh // 2, kw // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(x.dtype, memory_format=_CL)
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        return F.relu(self.bn(y.to(torch.float32))).to(x.dtype)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 SAME average over the valid cells only, with Flax's casting
    points: the window sum in x's dtype, divided by the cell count in
    float32, cast back (a single bf16 rounding of the mean drifts the
    probability by 1e-3)."""
    window_sum = F.avg_pool2d(x, 3, 1, 1, divisor_override=1)
    ones = torch.ones((1, 1) + x.shape[2:], dtype=torch.float32, device=x.device)
    cells = F.avg_pool2d(ones, 3, 1, 1, divisor_override=1)
    return (window_sum.to(torch.float32) / cells).to(x.dtype)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionV3(nn.Module):
    """Feature extractor: (B, 3, 299, 299) -> (B, 2048, 8, 8) in the
    compute dtype, channels-last. Params are allocated uninitialized."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        shapes = []

        def record(c, features, kh, kw, stride=1, valid=False):
            shapes.append((c, features, kh, kw, stride, valid))
            return features

        _topology(3, record, lambda c: c, lambda c: c, sum)
        for i, shape in enumerate(shapes):
            setattr(self, f"cbn_{i}", ConvBN(*shape, device=device))
        assert len(shapes) == NUM_CONVS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        index = iter(range(NUM_CONVS))

        def cbn(y, *_shape):
            return getattr(self, f"cbn_{next(index)}")(y)

        x = x.to(self.compute_dtype).contiguous(memory_format=_CL)
        return _topology(x, cbn, _avg_pool_same, _max_pool_valid,
                         lambda ys: torch.cat(ys, dim=1))


class InceptionV3Classifier(nn.Module):
    """InceptionV3 -> GAP -> Dropout(0.4) -> Dense(1, sigmoid); input
    (B, 299, 299, 3) channels-last as in the JAX module, output (B,)
    float32 probabilities."""

    def __init__(self, dropout_rate: float = 0.4,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.backbone = InceptionV3(compute_dtype, device=device)
        self.adipose_score = nn.Linear(2048, 1, device=device)

    def init_params(self, generator: torch.Generator) -> "InceptionV3Classifier":
        """Seeded weights, drawn in creation order: He-scaled conv kernels
        and randomized BN statistics (bias N(0, 0.1), mean N(0, 0.2), var
        U(0.5, 1.5)), so activations stay in range through 94 layers; head
        kernel N(0, 1/2048), bias 0.1."""
        with torch.no_grad():
            for i in range(NUM_CONVS):
                m = getattr(self.backbone, f"cbn_{i}")
                w = m.conv.weight
                std = math.sqrt(2.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                m.bn.bias.copy_(torch.randn(m.bn.bias.shape, generator=generator) * 0.1)
                m.bn.mean.copy_(torch.randn(m.bn.mean.shape, generator=generator) * 0.2)
                m.bn.var.copy_(torch.rand(m.bn.var.shape, generator=generator) + 0.5)
            head = self.adipose_score
            head.weight.copy_(torch.randn(head.weight.shape, generator=generator) / math.sqrt(2048))
            head.bias.fill_(0.1)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x.permute(0, 3, 1, 2))
        pooled = feats.to(torch.float32).mean(dim=(2, 3))
        pooled = F.dropout(pooled, self.dropout_rate, self.training)
        return torch.sigmoid(self.adipose_score(pooled))[:, 0]
