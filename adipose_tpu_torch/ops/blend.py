"""Overlap-blended reconstruction from tile predictions
(``adipose_tpu/ops/blend.py``), plain PyTorch.

Gaussian blending (``Segmentation/full_evaluation_enhanced.py:115-230``):
each tile adds ``tile * w`` to an accumulator canvas and ``w`` to a weight
canvas, where ``w`` is a peak-normalized 2-D Gaussian of sigma
``0.25 * tile_size``; the map is ``acc / max(wsum, 1e-8)``.

The canvases live on the device and are updated in place (the JAX package
donates them). The scatter-add is one ``acc[y:y+t, x:x+t] += w[i]`` per
tile, in tile order, as its ``fori_loop``: deterministic, no atomics. Tile
positions are host integers, so slicing never waits on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_weight_map(tile_size: int, sigma_factor: float = 0.25,
                        device=None) -> torch.Tensor:
    """Gaussian tile-center weight map, peak-normalized to 1
    (``full_evaluation_enhanced.py:133-148``), float32 (T, T). Computed on
    the CPU, in float32 as the JAX package computes it, then moved."""
    center = tile_size / 2.0
    coords = torch.arange(tile_size, dtype=torch.float32)
    sigma = tile_size * sigma_factor
    dist_sq = (coords[None, :] - center) ** 2 + (coords[:, None] - center) ** 2
    weights = torch.exp(-dist_sq / (2.0 * sigma ** 2))
    return (weights / weights.max()).to(device)


def _scatter_add(canvas: torch.Tensor, patches: torch.Tensor, positions,
                 valid) -> torch.Tensor:
    """Add the valid (N, T, T) patches into ``canvas`` at (y, x) corners, in
    order, in place. The JAX package adds an invalid entry as a zero patch,
    which leaves the canvas as it is, so it is skipped here."""
    t = patches.shape[-1]
    for i, ((y, x), keep) in enumerate(zip(np.asarray(positions).tolist(),
                                          np.asarray(valid).tolist())):
        if keep:
            canvas[y:y + t, x:x + t] += patches[i]
    return canvas


def accumulate_predictions(acc: torch.Tensor, tiles: torch.Tensor, positions,
                           weight_map: torch.Tensor, valid) -> torch.Tensor:
    """Add weighted (N, T, T) tiles into the accumulator canvas at host
    ``positions`` (N, 2); the host mask ``valid`` (N,) drops the pad
    entries that batch alignment appends. Updates ``acc`` in place and
    returns it."""
    return _scatter_add(acc, tiles.to(torch.float32) * weight_map[None], positions, valid)


def accumulate_weights(wsum: torch.Tensor, positions, weight_map: torch.Tensor,
                       valid) -> torch.Tensor:
    """Add the weight map at each valid position (denominator canvas), in place."""
    return _scatter_add(wsum, weight_map[None].expand(len(positions), -1, -1),
                        positions, valid)


def finalize_blend(acc: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    return acc / wsum.clamp_min(1e-8)


def blend_tiles(tiles: torch.Tensor, positions, weight_map: torch.Tensor, out_h: int,
                out_w: int) -> torch.Tensor:
    """Weighted blend of (N, T, T) tiles at host (y, x) ``positions`` into a
    fresh (out_h, out_w) float32 map on the tiles' device: accumulate
    ``tile * w`` and ``w`` in tile order, then divide with a 1e-8 floor
    (``GaussianBlender.reconstruct``, ``full_evaluation_enhanced.py:150-183``;
    a ``weight_map`` of ones is the LinearBlender)."""
    every = np.ones(len(positions), bool)
    acc = torch.zeros((out_h, out_w), dtype=torch.float32, device=tiles.device)
    wsum = accumulate_weights(torch.zeros_like(acc), positions, weight_map, every)
    return finalize_blend(accumulate_predictions(acc, tiles, positions, weight_map, every), wsum)


def blend_tiles_gaussian(tiles, positions, out_shape, sigma_factor: float = 0.25) -> torch.Tensor:
    """GaussianBlender-equivalent convenience wrapper; numpy or torch tiles."""
    tiles = torch.as_tensor(tiles)
    wm = gaussian_weight_map(tiles.shape[-1], sigma_factor, device=tiles.device)
    return blend_tiles(tiles, positions, wm, int(out_shape[0]), int(out_shape[1]))


def blend_tiles_linear(tiles, positions, out_shape) -> torch.Tensor:
    """LinearBlender-equivalent: uniform weights, so a plain average
    (``full_evaluation_enhanced.py:186-205``)."""
    tiles = torch.as_tensor(tiles)
    t = tiles.shape[-1]
    wm = torch.ones((t, t), dtype=torch.float32, device=tiles.device)
    return blend_tiles(tiles, positions, wm, int(out_shape[0]), int(out_shape[1]))


def _quantize_u8(p: torch.Tensor) -> torch.Tensor:
    """``(clip(p, 0, 1) * 255).astype(uint8)``: a truncating cast, as the
    reference saves ``prediction * 255``."""
    return (p.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def finalize_blend_u8(acc: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Finalize and quantize to the probability PNG's uint8 payload."""
    return _quantize_u8(finalize_blend(acc, wsum))


_OUT_DTYPES = {"uint8": torch.uint8, "float16": torch.float16, "float32": torch.float32}


def finalize_blend_stripe(acc: torch.Tensor, wsum: torch.Tensor, y_start: int,
                          height: int, out_dtype: str = "uint8") -> torch.Tensor:
    """Finalize the canvas row stripe ``[y_start, y_start + height)``, as
    ``uint8`` (the PNG payload), ``float16`` or ``float32``."""
    p = finalize_blend(acc[y_start:y_start + height], wsum[y_start:y_start + height])
    if out_dtype == "uint8":
        return _quantize_u8(p)
    return p.to(_OUT_DTYPES[out_dtype])


def sliding_window_positions(image_shape, tile_size: int = 1024,
                             overlap: float = 0.5) -> np.ndarray:
    """Sliding-window tile origins (N, 2) int32, clamped to bounds, overlap
    <= 0.75 (``full_evaluation_enhanced.py:240-273``)."""
    overlap = max(0.0, min(overlap, 0.75))
    stride = int(tile_size * (1 - overlap))
    h, w = int(image_shape[0]), int(image_shape[1])
    y_steps = max(1, math.ceil((h - tile_size) / stride) + 1)
    x_steps = max(1, math.ceil((w - tile_size) / stride) + 1)
    positions = []
    for yi in range(y_steps):
        for xi in range(x_steps):
            y = min(yi * stride, h - tile_size)
            x = min(xi * stride, w - tile_size)
            if y >= 0 and x >= 0 and y + tile_size <= h and x + tile_size <= w:
                positions.append((y, x))
    # an image smaller than the tile yields an empty (0, 2) array
    return np.asarray(positions, dtype=np.int32).reshape(-1, 2)


def extract_tiles(image: torch.Tensor, positions, tile_size: int) -> torch.Tensor:
    """Gather (N, T, T) tiles of a device-resident (H, W) image at host
    (y, x) origins, in one copy."""
    return torch.stack([image[y:y + tile_size, x:x + tile_size]
                        for y, x in np.asarray(positions).tolist()])
