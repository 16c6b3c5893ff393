"""Seeded weights, made on the device in a few large draws, in float32 (the
type both configurations keep their parameters in).

U-Net: He-normal kernels truncated at two standard deviations and small
normal biases. InceptionV3: He-normal kernels and BatchNorm statistics
randomized as ``InceptionV3Classifier.init_params`` draws them (bias
N(0, 0.1), mean N(0, 0.2), variance U(0.5, 1.5)), so activations stay in
range through 94 layers; the head N(0, 1/2048) with bias 0.1. Names are
the port's state-dict names; the references read the same dict.
"""

from __future__ import annotations

import math

import torch

from bench_h100.reference.inception import conv_shapes
from bench_h100.work.unet import conv_layers


def _split(flat: torch.Tensor, shapes: dict) -> dict:
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def unet(config: dict, gen: torch.Generator, deep_supervision: bool = False) -> dict:
    """The U-Net's state dict on ``gen``'s device."""
    layers = conv_layers(config["init_nb"], len(config["dilation_rates"]), deep_supervision)
    shapes = {}
    for name, cin, cout, k, _ in layers:
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)
    total = sum(math.prod(s) for s in shapes.values())
    draws = _split(torch.randn(total, generator=gen, device=gen.device), shapes)
    params = {}
    for name, cin, cout, k, _ in layers:
        std = math.sqrt(2.0 / (cin * k * k))
        params[f"{name}.weight"] = (draws[f"{name}.weight"].clamp(-2.0, 2.0) * std).contiguous()
        params[f"{name}.bias"] = (draws[f"{name}.bias"] * 0.02).contiguous()
    return params


def inception(gen: torch.Generator) -> dict:
    """The classifier's state dict on ``gen``'s device."""
    shapes = {}
    convs = conv_shapes()
    for i, (cin, filters, kh, kw, _, _) in enumerate(convs):
        shapes[f"backbone.cbn_{i}.conv.weight"] = (filters, cin, kh, kw)
        for k in ("bias", "mean", "var"):
            shapes[f"backbone.cbn_{i}.bn.{k}"] = (filters,)
    shapes["adipose_score.weight"] = (1, 2048)
    total = sum(math.prod(s) for s in shapes.values())
    normal = _split(torch.randn(total, generator=gen, device=gen.device), shapes)
    uniform = _split(torch.rand(total, generator=gen, device=gen.device), shapes)
    params = {}
    for i, (cin, _, kh, kw, _, _) in enumerate(convs):
        p = f"backbone.cbn_{i}"
        params[f"{p}.conv.weight"] = (normal[f"{p}.conv.weight"]
                                      * math.sqrt(2.0 / (cin * kh * kw))).contiguous()
        params[f"{p}.bn.bias"] = (normal[f"{p}.bn.bias"] * 0.1).contiguous()
        params[f"{p}.bn.mean"] = (normal[f"{p}.bn.mean"] * 0.2).contiguous()
        params[f"{p}.bn.var"] = (uniform[f"{p}.bn.var"] + 0.5).contiguous()
    params["adipose_score.weight"] = (normal["adipose_score.weight"]
                                      / math.sqrt(2048)).contiguous()
    params["adipose_score.bias"] = torch.full((1,), 0.1, device=gen.device)
    return params
