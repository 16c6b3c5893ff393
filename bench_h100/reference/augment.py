"""The training augmentation tiers, plain float32 (``src/utils/data.py``
of the reference as the trainer applies it): a D4 member per tile, then the
tier's stages in order, each applied per tile where its gate says.

The draws are made in the order the trainer makes them from its
generator, so that the same generator state gives the same draws: the
(B,) int32 D4 ids, then for each stage a (B,) gate uniform and either a
(B,) factor in [lo, hi) or, for the elastic warp, two (B, H, W) uniform
fields, and for noise a (B, H, W) normal field.

Images are (B, H, W) float32 in [0, 255]; masks (B, H, W) float32 {0, 1}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference.inception import d4

BLUR_TAPS = 11  # a fixed support of 2 * 5 + 1 taps

# (kind, lo, hi, prob, alpha, sigma) of each stage, in order.
TIERS = {
    "light": (("brightness", 0.95, 1.05, 0.3, 0, 0),),
    "moderate": (("scale", 0.95, 1.05, 0.3, 0, 0), ("elastic", 0, 0, 0.15, 8.0, 3.0),
                 ("brightness", 0.9, 1.1, 0.5, 0, 0), ("contrast", 0.9, 1.1, 0.5, 0, 0),
                 ("blur", 0.0, 0.8, 0.15, 0, 0)),
    "heavy": (("scale", 0.9, 1.1, 0.5, 0, 0), ("elastic", 0, 0, 0.3, 15.0, 3.0),
              ("brightness", 0.8, 1.2, 0.7, 0, 0), ("contrast", 0.8, 1.2, 0.7, 0, 0),
              ("gamma", 0.8, 1.2, 0.7, 0, 0), ("blur", 0.0, 1.0, 0.2, 0, 0),
              ("noise", 0.0, 5.0, 0.2, 0, 0)),
}


def draw(gen: torch.Generator, tier: str, b: int, h: int, w: int) -> dict:
    dev = gen.device

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)

    ids = torch.randint(0, 8, (b,), generator=gen, device=dev, dtype=torch.int32)
    stages = []
    for kind, lo, hi, *_ in TIERS[tier]:
        d = {"gate": uniform((b,))}
        if kind == "elastic":
            d["ux"], d["uy"] = uniform((b, h, w)), uniform((b, h, w))
        else:
            d["value"] = uniform((b,)) * (hi - lo) + lo
            if kind == "noise":
                d["normal"] = torch.randn((b, h, w), generator=gen, device=dev,
                                          dtype=torch.float32)
        stages.append(d)
    return {"ids": ids, "stages": stages}


def _per_tile(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian of 11 taps with a per-tile sigma, rows then
    columns, mirrored at the edges without repeating the edge pixel."""
    r = BLUR_TAPS // 2
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma.clamp_min(1e-3)[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    h, w = x.shape[-2:]
    y = F.pad(x[:, None], (0, 0, r, r), mode="reflect")[:, 0]
    x = sum(_per_tile(k[:, i]) * y[:, i:i + h, :] for i in range(BLUR_TAPS))
    y = F.pad(x[:, None], (r, r, 0, 0), mode="reflect")[:, 0]
    return sum(_per_tile(k[:, i]) * y[:, :, i:i + w] for i in range(BLUR_TAPS))


def _gather(x: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.gather(x, dim, index.clamp(0, n - 1))


def _warp(x: torch.Tensor, d: torch.Tensor, dim: int, nearest: bool) -> torch.Tensor:
    """Sample ``x`` at position + ``d`` along ``dim`` (1 rows, 2 columns),
    clamped at the edges: linearly, or at the nearest position (half to
    even)."""
    n = x.shape[dim]
    shape = [1, 1, 1]
    shape[dim] = n
    pos = torch.arange(n, device=x.device).view(shape)
    if nearest:
        return _gather(x, pos + torch.round(d).long(), dim)
    k = torch.floor(d)
    f = d - k
    i0 = pos + k.long()
    return (1.0 - f) * _gather(x, i0, dim) + f * _gather(x, i0 + 1, dim)


def elastic(images, masks, ux, uy, alpha: float, sigma: float):
    """A smooth random warp: the uniform fields blurred to displacements
    in [-alpha, alpha]; rows by dy first, then columns by dx."""
    s = torch.full((images.shape[0],), sigma, device=images.device)
    dx = gaussian_blur(ux * 2.0 - 1.0, s) * alpha
    dy = gaussian_blur(uy * 2.0 - 1.0, s) * alpha
    images = _warp(_warp(images, dy, 1, False), dx, 2, False)
    masks = _warp(_warp(masks, dy, 1, True), dx, 2, True)
    return images, masks


def _zoom_axis(x: torch.Tensor, scale: torch.Tensor, dim: int, nearest: bool) -> torch.Tensor:
    """Centre zoom along ``dim``: output position i samples the input at
    (i - c) / s + c. Images mirror out-of-range positions and interpolate
    linearly; masks take the nearest position (the lower on a tie) and are
    zero outside the tile."""
    n = x.shape[dim]
    shape = [-1, 1, 1]
    shape[dim] = n
    c = (n - 1) / 2.0
    src = (torch.arange(n, dtype=torch.float32, device=x.device)[None] - c) / scale[:, None] + c
    src = src.view(shape)
    if nearest:
        inside = (src >= 0) & (src <= n - 1)
        index = torch.ceil(src - 0.5).long().expand_as(x)
        return torch.where(inside, _gather(x, index, dim), torch.zeros((), device=x.device))
    period = 2.0 * (n - 1)
    m = torch.remainder(src, period)
    m = torch.where(m > n - 1, period - m, m)
    i0 = torch.floor(m)
    f = m - i0
    i0 = i0.long().expand_as(x)
    return (1.0 - f) * _gather(x, i0, dim) + f * _gather(x, i0 + 1, dim)


def zoom(images, masks, scale):
    images = _zoom_axis(_zoom_axis(images, scale, 1, False), scale, 2, False)
    masks = _zoom_axis(_zoom_axis(masks, scale, 1, True), scale, 2, True)
    return images, masks


def apply(draws: dict, images: torch.Tensor, masks: torch.Tensor, tier: str):
    """The tier on its draws."""
    ids = draws["ids"].tolist()
    images = torch.stack([d4(images[b], k) for b, k in enumerate(ids)])
    masks = torch.stack([d4(masks[b], k) for b, k in enumerate(ids)])
    for (kind, _, _, prob, alpha, sigma), d in zip(TIERS[tier], draws["stages"], strict=True):
        gate = d["gate"]
        if kind == "scale":
            on = _per_tile(gate <= prob)
            zi, zm = zoom(images, masks, d["value"])
            images, masks = torch.where(on, zi, images), torch.where(on, zm, masks)
        elif kind == "elastic":
            on = _per_tile(gate > 1.0 - prob)
            wi, wm = elastic(images, masks, d["ux"], d["uy"], alpha, sigma)
            images, masks = torch.where(on, wi, images), torch.where(on, wm, masks)
        elif kind == "blur":
            on = _per_tile((gate <= prob) & (d["value"] >= 0.1))
            images = torch.where(on, gaussian_blur(images, d["value"]), images)
        elif kind == "noise":
            noisy = (images + d["normal"] * _per_tile(d["value"])).clamp(0.0, 255.0)
            images = torch.where(_per_tile(gate <= prob), noisy, images)
        else:
            f = _per_tile(d["value"])
            if kind == "brightness":
                changed = (images * f).clamp(0.0, 255.0)
            elif kind == "contrast":
                mean = _per_tile(images.mean(dim=(1, 2)))
                changed = ((images - mean) * f + mean).clamp(0.0, 255.0)
            else:  # gamma
                changed = torch.pow((images / 255.0).clamp(0.0, 1.0), f) * 255.0
            images = torch.where(_per_tile(gate > 1.0 - prob), changed, images)
    return images, masks

