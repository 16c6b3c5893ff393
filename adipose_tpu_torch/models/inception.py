"""InceptionV3 tile classifier (``adipose_tpu/models/inception.py``) in
PyTorch, for inference and two-phase fine-tuning.

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
  head     global average pool, Dropout(0.4) in training, and Dense(2048 ->
           1) in float32, sigmoid.

Training (``forward(x, train=True, frozen_below=k)``) is explicit, as in the
JAX module, never ``module.train()``: ConvBN ``i >= k`` normalizes with the
batch statistics and returns its updated running statistics (Flax's
``BatchNorm(momentum=0.99)``: the biased variance ``max(0, E[x^2] - E[x]^2)``,
``ra <- 0.99 ra + 0.01 batch``); ConvBN ``i < k`` runs in inference mode
and keeps its statistics, as Keras runs a ``trainable=False`` BatchNorm.
With a ``batch_shard`` (one process's rows of a global batch), the batch
statistics and the dropout mask are the global batch's, as the JAX
package's sharded step computes them.

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

from adipose_tpu_torch.models.unet import lecun_normal_
from adipose_tpu_torch.parallel.collectives import all_reduce_sum

_CL = torch.channels_last
NUM_CONVS = 94
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


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
    """BatchNorm without scale: ``(x - mean) * rsqrt(var + eps) + bias``
    with the running statistics, or in training with the batch's."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.register_buffer("mean", torch.empty(c, device=device))
        self.register_buffer("var", torch.empty(c, device=device))

    def forward(self, x: torch.Tensor, train: bool = False, shard=None):
        """(normalized x, None), or in training (normalized x, (updated
        running mean, updated running var)); x is float32 (B, C, H, W).
        With a ``shard`` (a ``BatchShard``) the training statistics are the
        global batch's: the per-channel (sum x, sum x^2) all-reduced over
        its group, differentiably."""
        if not train:
            mean, var, stats = self.mean, self.var, None
        elif shard is None:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        else:
            sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2, 3)),
                                               (x * x).sum(dim=(0, 2, 3))]), shard.group)
            count = shard.total * x.shape[2] * x.shape[3]
            mean, sq = sums[0] / count, sums[1] / count
            var = (sq - mean * mean).clamp_min(0.0)
        if train:
            with torch.no_grad():
                stats = (BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean,
                         BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPSILON)
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None], stats


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm (f32, no scale, eps 1e-3) -> ReLU, the
    Keras ``conv2d_bn``; returns (output, updated running statistics or
    None)."""

    def __init__(self, cin: int, features: int, kh: int, kw: int, stride: int = 1,
                 valid: bool = False, device=None):
        super().__init__()
        self.conv = _Conv(cin, features, kh, kw, device=device)
        self.bn = _BatchNorm(features, device=device)
        self.stride = stride
        self.padding = (0, 0) if valid else (kh // 2, kw // 2)

    def forward(self, x: torch.Tensor, train: bool = False, shard=None):
        w = self.conv.weight.to(x.dtype, memory_format=_CL)
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        y, stats = self.bn(y.to(torch.float32), train, shard)
        return F.relu(y).to(x.dtype), stats


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

    def forward(self, x: torch.Tensor, train: bool = False, frozen_below: int = 0,
                shard=None):
        """The features; in training ``(features, stats)``, where ``stats``
        maps ``cbn_<i>.bn.{mean,var}`` to the updated running statistics of
        each ConvBN ``i >= frozen_below`` (over the global batch of
        ``shard``, a ``BatchShard``, when given)."""
        index = iter(range(NUM_CONVS))
        stats = {}

        def cbn(y, *_shape):
            i = next(index)
            y, new = getattr(self, f"cbn_{i}")(y, train and i >= frozen_below, shard)
            if new is not None:
                stats[f"cbn_{i}.bn.mean"], stats[f"cbn_{i}.bn.var"] = new
            return y

        x = x.to(self.compute_dtype).contiguous(memory_format=_CL)
        feats = _topology(x, cbn, _avg_pool_same, _max_pool_valid,
                          lambda ys: torch.cat(ys, dim=1))
        return (feats, stats) if train else feats


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
        # The rows of a global batch this process holds (a BatchShard): in
        # training, BatchNorm uses the global batch's statistics and dropout
        # the global batch's mask, sliced to these rows.
        self.batch_shard = None

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

    def init_flax(self, generator: torch.Generator) -> "InceptionV3Classifier":
        """Flax's initialization of the JAX module, drawn from ``generator``
        in creation order: lecun_normal conv and Dense kernels, zero biases,
        running mean 0 and variance 1."""
        with torch.no_grad():
            for i in range(NUM_CONVS):
                m = getattr(self.backbone, f"cbn_{i}")
                lecun_normal_(m.conv.weight, generator)
                m.bn.bias.zero_()
                m.bn.mean.zero_()
                m.bn.var.fill_(1.0)
            lecun_normal_(self.adipose_score.weight, generator)
            self.adipose_score.bias.zero_()
        return self

    def _dropout(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """Flax ``nn.Dropout`` in training: keep where ``uniform < 1 - rate``,
        scaled by 1 / (1 - rate); the identity at rate 0."""
        if self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("InceptionV3Classifier in training needs a generator for dropout")
        keep_prob = 1.0 - self.dropout_rate
        shard = self.batch_shard
        rows = x.shape[0] if shard is None else shard.total
        u = torch.rand((rows,) + x.shape[1:], generator=generator, device=x.device)
        if shard is not None:
            u = shard.rows(u)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros((), device=x.device))

    def forward(self, x: torch.Tensor, train: bool = False, frozen_below: int = 0,
                generator: torch.Generator | None = None):
        """(B,) probabilities; in training ``(probabilities, stats)`` as the
        JAX module's ``apply(..., train=True, mutable=["batch_stats"])``
        gives them: ``stats`` maps each updated ``backbone.cbn_<i>.bn.{mean,
        var}`` state-dict name to its new running statistics. ConvBN
        ``i < frozen_below`` runs in inference mode; ``generator`` draws the
        dropout mask."""
        x = x.permute(0, 3, 1, 2)
        feats, stats = (self.backbone(x, True, frozen_below, self.batch_shard) if train
                        else (self.backbone(x), {}))
        pooled = feats.to(torch.float32).mean(dim=(2, 3))
        if train:
            pooled = self._dropout(pooled, generator)
        probs = torch.sigmoid(self.adipose_score(pooled))[:, 0]
        if not train:
            return probs
        return probs, {f"backbone.{k}": v for k, v in stats.items()}


# The conv index at which each mixed block starts (Keras creation order).
MIXED_CONV_START = {
    "mixed0": 5, "mixed1": 12, "mixed2": 19, "mixed3": 26,
    "mixed4": 30, "mixed5": 40, "mixed6": 50, "mixed7": 60,
    "mixed8": 70, "mixed9": 76, "mixed10": 85,
}
_MIXED_ORDER = [f"mixed{k}" for k in range(11)]


def unfreeze_conv_start(unfreeze_from: str | None) -> int:
    """The first trainable conv index of Keras's ``unfreeze_from_layer``
    (``train_adipose_classifier_v0.py:361-367``): Keras unfreezes from the
    layer named 'mixedK', the block's Concatenate, created after the
    block's own convs. So 'mixed7' unfreezes convs 70.. (mixed8 on), not
    mixed7's own 60..69; None freezes the whole backbone."""
    if unfreeze_from is None:
        return NUM_CONVS
    k = _MIXED_ORDER.index(unfreeze_from)
    if k + 1 < len(_MIXED_ORDER):
        return MIXED_CONV_START[_MIXED_ORDER[k + 1]]
    return NUM_CONVS


def frozen_conv_boundary(unfreeze_from: str | None) -> int:
    """The ``frozen_below`` of a phase: the conv index below which the
    backbone's BatchNorms run in inference mode during training."""
    return unfreeze_conv_start(unfreeze_from)


def _conv_index(name: str) -> int | None:
    seg = next((s for s in name.split(".") if s.startswith("cbn_")), None)
    return int(seg.split("_")[1]) if seg else None


def backbone_param_mask(params, unfreeze_from: str | None = "mixed7") -> dict[str, bool]:
    """Trainability of each param name of a classifier state dict: the head
    always trains; phase 1 (``unfreeze_from=None``) freezes the whole
    backbone, phase 2 trains the convs from :func:`unfreeze_conv_start`."""
    start = unfreeze_conv_start(unfreeze_from)
    mask = {}
    for name in params:
        if not name.startswith("backbone."):
            mask[name] = True
        else:
            idx = _conv_index(name)
            mask[name] = unfreeze_from is not None and (NUM_CONVS if idx is None else idx) >= start
    return mask
