"""CLAHE (contrast-limited adaptive histogram equalization)
(``adipose_tpu/ops/clahe.py``), plain PyTorch on the tensor's device, with the
JAX package's float32 formulas: per-tile 256-bin histograms, single-pass
clip-limit redistribution, the CDF mapping, and bilinear interpolation
between the four surrounding tiles' mappings.

The JAX package builds a one-hot (G, G, pixels, 256) histogram and gathers
(H, W, 256) mappings; at a 6144^2 chunk each is ~38 GB. Here the histogram
is one ``bincount`` over ``tile * 256 + bin`` (exact counts, as the one-hot
sum is exact below 2^24 pixels a tile) and each of the four lookups is one
gather on a flat index. A division by a constant is a multiply by its
float32 reciprocal, as XLA compiles it, on either device.

The clip excess and the CDF are summed in float64 and rounded once to
float32 (torch's CPU cumsum accumulates in float64 anyway): a 768^2 tile's
CDF runs to 2^19.2 in steps of 1/256, which float32 cannot hold, so a float32
running sum rounds at every step, and the card's parallel scan rounds in
another order than a sequential one. Summed exactly, both devices give the
same bits. Below 256^2 pixels a tile, float32 holds the sums exactly, and
they equal the JAX package's float32 running sums.
"""

from __future__ import annotations

import torch

from adipose_tpu_torch.ops.fftops import recip, reflect_pad
from adipose_tpu_torch.ops.normalize import _percentiles
from adipose_tpu_torch.ops.qc import laplacian_variance

#: Quality cutoffs published by the reference's contrast-grouping analysis
#: (``analysis/contrast_and_normalization_analysis/adaptive_clahe_function.py:18-26``).
DEFAULT_ADAPTIVE_CUTOFFS = {
    "contrast_ratio": {"poor_cutoff": 0.183, "good_cutoff": 0.267},
    "laplacian_variance": {"good_cutoff": 38.2},
}


def _tile_histograms(pix_bins: torch.Tensor, tile_grid: int, nbins: int) -> torch.Tensor:
    """(G, G, nbins) int64 counts of the bins of each of the G x G tiles of an
    (H, W) int64 bin image whose sides are multiples of G."""
    h, w = pix_bins.shape
    g = tile_grid
    rows = torch.arange(h, device=pix_bins.device) // (h // g)
    cols = torch.arange(w, device=pix_bins.device) // (w // g)
    tile = rows[:, None] * g + cols[None, :]
    return torch.bincount((tile * nbins + pix_bins).reshape(-1),
                          minlength=g * g * nbins).view(g, g, nbins)


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tile_grid: int = 8,
          nbins: int = 256) -> torch.Tensor:
    """CLAHE on a uint8-range grayscale image; float32 in [0, 255]. H and W
    must be multiples of ``tile_grid`` (:func:`_clahe_any_shape` pads)."""
    x = img.to(torch.float32)
    h, w = x.shape
    g = tile_grid
    th, tw = h // g, w // g
    npx = th * tw
    dev = x.device

    pix_bins = x.to(torch.int32).clamp(0, nbins - 1).to(torch.int64)
    hist = _tile_histograms(pix_bins, g, nbins).to(torch.float32).view(g * g, nbins)

    # clip-limit redistribution (cv2 scales the clip by tile pixels / nbins)
    clip = (torch.tensor(clip_limit, dtype=torch.float32) * npx / nbins).clamp_min(1.0).to(dev)
    excess = (hist - clip).clamp_min(0.0).to(torch.float64).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, clip) + excess.to(torch.float32) / nbins
    cdf = hist.to(torch.float64).cumsum(dim=-1).to(torch.float32)
    # (G * G * nbins,): the output level of each tile's bins
    mapping = ((cdf * recip(npx)) * (nbins - 1)).clamp(0.0, nbins - 1.0).reshape(-1)

    # bilinear interpolation between the 4 surrounding tile mappings
    ty = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * recip(th) - 0.5
    tx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * recip(tw) - 0.5
    y0 = ty.floor().clamp(0, g - 1).to(torch.int64)
    x0 = tx.floor().clamp(0, g - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(0, g - 1)
    x1 = (x0 + 1).clamp(0, g - 1)
    wy = (ty - y0).clamp(0.0, 1.0)[:, None]
    wx = (tx - x0).clamp(0.0, 1.0)[None, :]

    def lookup(tyi, txi):
        return mapping[(tyi[:, None] * g + txi[None, :]) * nbins + pix_bins]

    out = (lookup(y0, x0) * (1 - wy) * (1 - wx)
           + lookup(y0, x1) * (1 - wy) * wx
           + lookup(y1, x0) * wy * (1 - wx)
           + lookup(y1, x1) * wy * wx)
    return out.clamp(0.0, 255.0)


def _clahe_any_shape(x: torch.Tensor, clip_limit: float, tile_grid: int) -> torch.Tensor:
    """CLAHE with reflect padding to the next grid multiple (cropped back)."""
    h, w = x.shape
    x = reflect_pad(x.to(torch.float32), 0, (-h) % tile_grid, 0, (-w) % tile_grid)
    return clahe(x, clip_limit=clip_limit, tile_grid=tile_grid)[:h, :w]


def _percentile_unit(x: torch.Tensor, p_low: float, p_high: float) -> torch.Tensor:
    """``clip((x - p_lo) / (p_hi - p_lo + 1e-3), 0, 1)``: the reference's
    adaptive stretch (``adaptive_clahe_function.py:23-24``)."""
    lo, hi = (v[0] for v in _percentiles(x.reshape(1, -1).to(torch.float32), p_low, p_high))
    return ((x - lo) / (hi - lo + 1e-3)).clamp(0.0, 1.0)


def adaptive_clahe_normalize(img, cutoffs: dict | None = None,
                             device="cuda") -> tuple[torch.Tensor, str]:
    """Quality-adaptive CLAHE + percentile stretch to [0, 1]
    (``adaptive_clahe_function.py:5-38``), routed by the contrast ratio
    (std / mean) and the Laplacian variance of the uint8-clipped image:
    below the poor cutoff, CLAHE (clip 2.0, 8x8) then the 5-95 stretch
    ("poor"); above the good cutoffs, the 2-98 stretch alone ("good");
    else CLAHE (clip 1.5, 12x12) then 5-95 ("medium"). ``img`` is numpy or a
    tensor; a tensor stays on its device. Returns (image, strategy)."""
    cuts = cutoffs or DEFAULT_ADAPTIVE_CUTOFFS
    if not torch.is_tensor(img):
        img = torch.as_tensor(img, device=device)
    x = img.to(torch.float32)
    mean = float(x.mean())
    std = float(x.std(correction=0))
    contrast_ratio = std / (mean + 1e-6)
    sharpness = float(laplacian_variance(x.clamp(0, 255).to(torch.uint8)[None])[0])

    cr = cuts["contrast_ratio"]
    lap_good = cuts["laplacian_variance"]["good_cutoff"]
    if contrast_ratio < cr["poor_cutoff"]:
        return _percentile_unit(_clahe_any_shape(x, 2.0, 8), 5.0, 95.0), "poor"
    if contrast_ratio > cr["good_cutoff"] and sharpness > lap_good:
        return _percentile_unit(x, 2.0, 98.0), "good"
    return _percentile_unit(_clahe_any_shape(x, 1.5, 12), 5.0, 95.0), "medium"
