"""Image/mask augmentation on the device (``adipose_tpu/data/augment.py``).

Four tiers (light / moderate / heavy / tta_style) plus ``none``, each a
uniform D4 transform per sample followed by the tier's "rest" stages: zoom,
elastic warp, brightness, contrast, gamma, Gaussian blur and noise; and the
classifier's mask-free stage (``classification``, :func:`batched_classification`).
Images are (B, H, W) float32 in [0, 255]; masks (B, H, W) float32 in {0, 1}.

Every primitive is split in two:

* :func:`draw_tier` makes every random draw of a tier from one
  ``torch.Generator``, on that generator's device: the D4 ids, each stage's
  gate uniform and factor, and the per-pixel fields (the elastic warp's two
  uniform fields, the noise field). Nothing is drawn on the host.
* The ``apply_*`` functions and :func:`batched_tier` are deterministic in
  those draws. They keep the JAX formulations and summation orders: the
  shifted-add blur, the banded-matrix zoom, the bounded shifted-sum warp;
  every stage is computed for the whole batch and selected per sample with
  ``torch.where``, as the JAX tiers do with ``jnp.where``, so no value is
  read back to the host.

The tests feed these functions draws made with ``jax.random`` from the JAX
package's keys, so the two packages are compared on identical draws; torch
itself cannot reproduce ``jax.random``'s streams.

The D4 stage runs batch-level through :func:`adipose_tpu_torch.ops.d4.apply_transform_batch`
(the D4 kernel), once for the images and once for the masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from adipose_tpu_torch.ops.d4 import apply_transform_batch

BLUR_RADIUS = 5  # supports sigma <= ~1.7 (reference max 1.5)


@dataclass(frozen=True)
class Stage:
    """One rest stage of a tier: ``kind`` with its factor range [lo, hi),
    gate probability ``prob`` and, for the elastic warp, alpha and sigma."""

    kind: str  # scale | elastic | brightness | contrast | gamma | blur | noise
    lo: float = 0.0
    hi: float = 0.0
    prob: float = 1.0
    alpha: float = 0.0
    sigma: float = 0.0


# The tiers' rest stages, in the JAX order (adipose_tpu/data/augment.py:273-307).
TIER_STAGES = {
    "light": (Stage("brightness", 0.95, 1.05, 0.3),),
    "moderate": (
        Stage("scale", 0.95, 1.05, 0.3),
        Stage("elastic", prob=0.15, alpha=8.0, sigma=3.0),
        Stage("brightness", 0.9, 1.1, 0.5),
        Stage("contrast", 0.9, 1.1, 0.5),
        Stage("blur", 0.0, 0.8, 0.15),
    ),
    "heavy": (
        Stage("scale", 0.9, 1.1, 0.5),
        Stage("elastic", prob=0.3, alpha=15.0, sigma=3.0),
        Stage("brightness", 0.8, 1.2, 0.7),
        Stage("contrast", 0.8, 1.2, 0.7),
        Stage("gamma", 0.8, 1.2, 0.7),
        Stage("blur", 0.0, 1.0, 0.2),
        Stage("noise", 0.0, 5.0, 0.2),
    ),
    "tta_style": (
        Stage("scale", 0.95, 1.05, 0.3),
        Stage("brightness", 0.85, 1.15, 0.6),
        Stage("contrast", 0.85, 1.15, 0.6),
        Stage("gamma", 0.85, 1.15, 0.5),
        Stage("blur", 0.0, 0.7, 0.15),
    ),
}
TIER_STAGES["tta-style"] = TIER_STAGES["tta_style"]  # reference spelling
# The classifier tiles' stage (_rest_classification, augment.py:310-318);
# its zoom acts on the image alone.
TIER_STAGES["classification"] = (
    Stage("scale", 0.95, 1.05, 0.3),
    Stage("brightness", 0.9, 1.1, 0.6),
    Stage("contrast", 0.9, 1.1, 0.6),
    Stage("gamma", 0.9, 1.1, 0.5),
    Stage("blur", 0.0, 0.8, 0.15),
    Stage("noise", 0.0, 5.0, 0.15),
)


def _col(v: torch.Tensor) -> torch.Tensor:
    """A (B,) per-sample value broadcast over (B, H, W)."""
    return v[:, None, None]


# ---- Photometric primitives --------------------------------------------------


def apply_brightness(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``clip(image * f, 0, 255)`` (``data.py:32-35``)."""
    return (images * _col(factor)).clamp(0.0, 255.0)


def apply_contrast(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``clip((image - mean) * f + mean, 0, 255)`` per sample (``data.py:38-42``)."""
    m = _col(images.mean(dim=(1, 2)))
    return ((images - m) * _col(factor) + m).clamp(0.0, 255.0)


def apply_gamma(images: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``clip(image / 255, 0, 1) ** g * 255`` (``data.py:45-50``)."""
    return torch.pow((images / 255.0).clamp(0.0, 1.0), _col(gamma)) * 255.0


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of a reflect-padded axis (numpy's
    'reflect': the edge is not repeated)."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def blur_fixed(images: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Gaussian blur with a fixed support of 2 * BLUR_RADIUS + 1 taps and a
    per-sample sigma (B,): statically shifted weighted adds over rows, then
    columns, reflect-padded, in the JAX order (``_blur_fixed``)."""
    b, h, w = images.shape
    x = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32, device=images.device)
    z = x / sigma.clamp_min(1e-3)[:, None]
    k = torch.exp(-0.5 * (z * z))
    taps = 2 * BLUR_RADIUS + 1
    total = k[:, 0]
    for i in range(1, taps):  # in tap order, as XLA sums the 11 taps
        total = total + k[:, i]
    k = k / total[:, None]
    padded = images[:, _reflect_index(h, BLUR_RADIUS, images.device), :]
    out = torch.zeros_like(images)
    for i in range(taps):
        out = out + _col(k[:, i]) * padded[:, i:i + h, :]
    padded = out[:, :, _reflect_index(w, BLUR_RADIUS, images.device)]
    out2 = torch.zeros_like(images)
    for i in range(taps):
        out2 = out2 + _col(k[:, i]) * padded[:, :, i:i + w]
    return out2


def apply_gaussian_blur(images: torch.Tensor, gate: torch.Tensor, sigma: torch.Tensor,
                        prob: float) -> torch.Tensor:
    """Blur where ``gate <= prob`` and sigma >= 0.1 (``data.py:53-60``)."""
    on = (gate <= prob) & (sigma >= 0.1)
    return torch.where(_col(on), blur_fixed(images, sigma), images)


def apply_gaussian_noise(images: torch.Tensor, gate: torch.Tensor, std: torch.Tensor,
                         normal: torch.Tensor, prob: float) -> torch.Tensor:
    """Add ``normal * std`` where ``gate <= prob``, clipped (``data.py:63-69``)."""
    noisy = (images + normal * _col(std)).clamp(0.0, 255.0)
    return torch.where(_col(gate <= prob), noisy, images)


# ---- Geometric primitives ----------------------------------------------------


def _reflect_coords(src: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect out-of-range sample coordinates into [0, n - 1] (mirror mode)."""
    period = 2.0 * (n - 1)
    s = torch.remainder(src, period)
    return torch.where(s > (n - 1), period - s, s)


def _axis_weights(src: torch.Tensor, n: int, order: int) -> torch.Tensor:
    """(B, n_out, n) interpolation matrices: row i holds the weights over
    source positions for output coordinate src[:, i]. order 1 = tent
    (bilinear), order 0 = nearest one-hot."""
    j = torch.arange(n, dtype=torch.float32, device=src.device)
    d = (src[..., None] - j).abs()
    if order == 0:
        near = (d <= 0.5).to(torch.float32)
        return near * (near.cumsum(dim=-1) <= 1.0).to(torch.float32)
    return (1.0 - d).clamp_min(0.0)


def apply_scale(images: torch.Tensor, masks: torch.Tensor | None, gate: torch.Tensor,
                scale: torch.Tensor, prob: float):
    """Center zoom in/out with same-size output where ``gate <= prob``
    (``data.py:72-106``), as the separable resample ``W_y @ X @ W_x^T`` with
    banded tent matrices; zoom-out reflects the image at the borders and
    zero-fills the mask. ``masks`` None: the image alone, and None back."""
    _, h, w = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    s = scale[:, None]
    src_y = (torch.arange(h, dtype=torch.float32, device=dev) - cy) / s + cy
    src_x = (torch.arange(w, dtype=torch.float32, device=dev) - cx) / s + cx
    in_y = (src_y >= 0) & (src_y <= h - 1)
    in_x = (src_x >= 0) & (src_x <= w - 1)
    wy_img = _axis_weights(_reflect_coords(src_y, h), h, order=1)
    wx_img = _axis_weights(_reflect_coords(src_x, w), w, order=1)
    img_s = wy_img @ images @ wx_img.transpose(1, 2)
    on = _col(gate <= prob)
    if masks is None:
        return torch.where(on, img_s, images), None
    wy_m = _axis_weights(src_y, h, order=0) * in_y[..., None]
    wx_m = _axis_weights(src_x, w, order=0) * in_x[..., None]
    mask_s = wy_m @ masks @ wx_m.transpose(1, 2)
    return torch.where(on, img_s, images), torch.where(on, mask_s, masks)


def _warp_axis(img: torch.Tensor, delta: torch.Tensor, dim: int, order: int,
               max_shift: int) -> torch.Tensor:
    """Warp along ``dim`` by a bounded per-pixel displacement as a weighted
    sum over statically shifted copies of one edge-padded buffer
    (``_warp_axis``): bilinear weights for order 1, nearest for order 0.
    Exact for |delta| <= max_shift."""
    n = img.shape[dim]
    hi = max_shift + (0 if order == 0 else 1)
    index = (torch.arange(-max_shift, n + hi, device=img.device)).clamp(0, n - 1)
    padded = img.index_select(dim, index)

    def shifted(s):
        return padded.narrow(dim, max_shift + s, n)

    out = torch.zeros_like(img)
    if order == 0:
        k = torch.round(delta)
        for s in range(-max_shift, max_shift + 1):
            out = out + (k == s).to(img.dtype) * shifted(s)
        return out
    k0 = torch.floor(delta)
    f = (delta - k0).to(img.dtype)
    for s in range(-max_shift, max_shift + 2):
        wt = (k0 == s).to(img.dtype) * (1.0 - f) + (k0 == s - 1).to(img.dtype) * f
        out = out + wt * shifted(s)
    return out


def apply_elastic(images: torch.Tensor, masks: torch.Tensor, gate: torch.Tensor,
                  ux: torch.Tensor, uy: torch.Tensor, prob: float, alpha: float,
                  sigma: float):
    """Smooth random warp where ``gate > 1 - prob`` (``data.py:109-143``):
    the uniform fields ``ux``, ``uy`` (B, H, W) in [0, 1) become blurred
    displacements in [-alpha, alpha]; the image warps bilinearly and the
    mask by nearest neighbour, vertically by dy and then horizontally by
    dx, as the JAX package's two sequential axis warps."""
    sig = torch.full((images.shape[0],), sigma, dtype=torch.float32, device=images.device)
    dx = blur_fixed(ux * 2.0 - 1.0, sig) * alpha
    dy = blur_fixed(uy * 2.0 - 1.0, sig) * alpha
    max_shift = int(math.ceil(float(alpha)))  # |blurred U(-1, 1) * alpha| <= alpha
    img_d = _warp_axis(_warp_axis(images, dy, 1, 1, max_shift), dx, 2, 1, max_shift)
    mask_d = _warp_axis(_warp_axis(masks, dy, 1, 0, max_shift), dx, 2, 0, max_shift)
    on = _col(gate > (1.0 - prob))
    return torch.where(on, img_d, images), torch.where(on, mask_d, masks)


# ---- Draws and tiers ---------------------------------------------------------


def draw_tier(generator: torch.Generator, tier: str, batch: int, height: int,
              width: int) -> dict | None:
    """Every random draw of ``tier`` for a (batch, height, width) batch, on
    the generator's device: ``{"tid": (B,) int32, "stages": [dict per
    stage]}``; each stage's dict holds ``gate`` (B,) uniform and, by kind,
    ``value`` (B,) in [lo, hi), ``ux``/``uy`` (elastic) or ``normal``
    (noise) fields of (B, H, W). None for tier ``none``."""
    if tier == "none":
        return None
    stages = TIER_STAGES[tier]  # unknown tiers raise
    dev, g = generator.device, generator

    def uniform(shape):
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float32)

    tid = torch.randint(0, 8, (batch,), generator=g, device=dev, dtype=torch.int32)
    out = []
    for st in stages:
        d = {"gate": uniform((batch,))}
        if st.kind == "elastic":
            d["ux"] = uniform((batch, height, width))
            d["uy"] = uniform((batch, height, width))
        else:
            d["value"] = uniform((batch,)) * (st.hi - st.lo) + st.lo
            if st.kind == "noise":
                d["normal"] = torch.randn((batch, height, width), generator=g, device=dev,
                                          dtype=torch.float32)
        out.append(d)
    return {"tid": tid, "stages": out}


def _rest(stages: tuple, draws: list, images: torch.Tensor, masks: torch.Tensor | None):
    """A tier's rest stages, in order, on their draws: the JAX package's
    ``_rest_light``, ``_rest_moderate``, ``_rest_heavy``, ``_rest_tta_style``
    and ``_rest_classification`` over ``TIER_STAGES`` (masks None for the
    last)."""
    for st, d in zip(stages, draws, strict=True):
        if st.kind == "scale":
            images, masks = apply_scale(images, masks, d["gate"], d["value"], st.prob)
        elif st.kind == "elastic":
            images, masks = apply_elastic(images, masks, d["gate"], d["ux"], d["uy"],
                                          st.prob, st.alpha, st.sigma)
        elif st.kind == "blur":
            images = apply_gaussian_blur(images, d["gate"], d["value"], st.prob)
        elif st.kind == "noise":
            images = apply_gaussian_noise(images, d["gate"], d["value"], d["normal"], st.prob)
        else:  # _maybe(brightness | contrast | gamma): applied where gate > 1 - prob
            fn = {"brightness": apply_brightness, "contrast": apply_contrast,
                  "gamma": apply_gamma}[st.kind]
            images = torch.where(_col(d["gate"] > (1.0 - st.prob)), fn(images, d["value"]),
                                 images)
    return images, masks


def select_tier(n_tiles: int) -> str:
    """Dataset-size-keyed tier choice (<200 heavy, 100-500 moderate, >500
    light)."""
    if n_tiles < 200:
        return "heavy"
    if n_tiles <= 500:
        return "moderate"
    return "light"


def batched_tier(draws: dict | None, images: torch.Tensor, masks: torch.Tensor, tier: str):
    """Tier augmentation of a (B, H, W) batch on its draws: the D4 stage
    batch-level through the D4 kernel, then the rest stages."""
    if tier == "none":
        return images, masks
    stages = TIER_STAGES[tier]
    images = apply_transform_batch(images, draws["tid"])
    masks = apply_transform_batch(masks, draws["tid"])
    return _rest(stages, draws["stages"], images, masks)


def draw_for_shard(generator: torch.Generator, tier: str, batch: int, height: int, width: int,
                   shard=None) -> dict | None:
    """``draw_tier`` for a local batch of ``batch`` rows; with a ``shard``
    (a ``BatchShard``), drawn for its global batch and sliced to its rows,
    so the draws do not depend on how the batch is split."""
    if shard is None:
        return draw_tier(generator, tier, batch, height, width)
    draws = draw_tier(generator, tier, shard.total, height, width)
    if draws is None:
        return None
    return {"tid": shard.rows(draws["tid"]),
            "stages": [{k: shard.rows(v) for k, v in d.items()} for d in draws["stages"]]}


def augment_batch(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  tier: str = "moderate", shard=None):
    """Draw and apply ``tier`` over a (B, H, W) float32 batch (this
    process's rows of ``shard``'s global batch, when given)."""
    b, h, w = images.shape
    return batched_tier(draw_for_shard(generator, tier, b, h, w, shard), images, masks, tier)


def batched_classification(draws: dict, images: torch.Tensor) -> torch.Tensor:
    """The classifier tiles' augmentation of a (B, N, N) float32 batch on its
    draws (``draw_tier(generator, "classification", B, N, N)``): the D4
    stage through the D4 kernel, then the mask-free rest stages
    (``batched_classification``, ``_classification_stage``)."""
    images = apply_transform_batch(images, draws["tid"])
    return _rest(TIER_STAGES["classification"], draws["stages"], images, None)[0]


def augment_classification_batch(generator: torch.Generator,
                                 images: torch.Tensor) -> torch.Tensor:
    """Draw and apply the classification stage over a (B, N, N) float32 batch."""
    b, h, w = images.shape
    return batched_classification(draw_tier(generator, "classification", b, h, w), images)


def augment_grayscale_classification(generator: torch.Generator,
                                     image: torch.Tensor) -> torch.Tensor:
    """The classification stage of one (N, N) tile (``data.py:342-393``)."""
    return augment_classification_batch(generator, image[None])[0]
