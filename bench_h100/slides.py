"""The cascade's traffic: seeded slides, each the chunks a chunker cuts a
slide into, made on the device and kept in host memory.

A chunk extends ``chunk_image`` of ``chip_smoke.py`` (smooth cubic-resized
noise with Gaussian grain, near-white background) tile by tile, on the
tiles the cascade cuts (:func:`bench_h100.reference.cascade.tile_origins`):

  white    about a sixth of the tiles: 245-254, all above QC's 235, so
           their white share is 1 (QC: empty)
  blurry   about a twelfth: the smooth noise without grain, out of focus
           (QC: blurry, its Laplacian's variance that of the rounding);
           drawn among the tiles that overlap no other, so none of them
           takes another tile's texture
  coarse   half the rest, and ``fine`` the other half: smooth noise on a
           ``grid`` x ``grid`` lattice with grain of standard deviation
           ``grain``, both drawn a tile from the texture's ranges, so the
           gate's probabilities spread within each texture

Textured tiles are painted first, in tile order, then the blurry and the
white ones, so a tile that overlaps a white one (only the clamped last row
and column overlap) holds at most a strip of white. At the cell's sizes
no tile comes within 10% of a QC threshold: textured white shares stay
under 0.12, Laplacian variances of textured tiles over 50 and of blurry
ones under 3.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.cascade import tile_origins

COARSE, FINE, BLURRY, WHITE = 0, 1, 2, 3
TEXTURES = {COARSE: {"grid": (3, 6), "grain": (10.0, 14.0)},
            FINE: {"grid": (24, 48), "grain": (2.0, 5.0)}}
BLURRY_GRID = 4


@dataclass
class Chunk:
    image: np.ndarray  # (H, W) uint8
    origins: np.ndarray  # (N, 2) int32, the cascade's tiles
    kind: np.ndarray  # (N,) int8: COARSE, FINE, BLURRY or WHITE


def _noise(gen: torch.Generator, tile: int, grid: int, grain: float) -> torch.Tensor:
    """(tile, tile) float32: 60 + 140 x bicubic lattice noise, plus grain."""
    dev = gen.device
    lattice = torch.rand((1, 1, grid, grid), generator=gen, device=dev)
    img = 60.0 + 140.0 * F.interpolate(lattice, size=(tile, tile), mode="bicubic",
                                       align_corners=False)[0, 0]
    if grain > 0:
        img = img + grain * torch.randn((tile, tile), generator=gen, device=dev)
    return img


def _isolated(origins: np.ndarray, tile: int) -> np.ndarray:
    """(N,) bool: the tiles whose footprint meets no other tile's."""
    d = np.abs(origins[:, None, :] - origins[None, :, :]) < tile
    meets = d.all(axis=-1)
    np.fill_diagonal(meets, False)
    return ~meets.any(axis=1)


def chunk(shape, tile: int, gen: torch.Generator, overlap: float = 0.0,
          white_share: float = 1 / 6, blurry_share: float = 1 / 12) -> Chunk:
    """One seeded (H, W) chunk and the kind of each of its tiles."""
    dev = gen.device
    origins = tile_origins(shape, tile, overlap)
    n = len(origins)
    n_white = math.floor(n * white_share + 0.5)
    n_blurry = math.floor(n * blurry_share + 0.5)
    isolated = np.flatnonzero(_isolated(origins, tile))
    if len(isolated) < n_blurry:
        raise ValueError(f"chunk {tuple(shape)}: {len(isolated)} tiles overlap no other, "
                         f"{n_blurry} blurry wanted")
    kind = np.full(n, -1, dtype=np.int8)
    pick = torch.randperm(len(isolated), generator=gen, device=dev).cpu().numpy()
    kind[isolated[pick[:n_blurry]]] = BLURRY
    rest = np.flatnonzero(kind < 0)
    order = rest[torch.randperm(len(rest), generator=gen, device=dev).cpu().numpy()]
    kind[order[:n_white]] = WHITE
    good = order[n_white:]
    n_fine = len(good) // 2 + (len(good) % 2) * int(
        torch.randint(0, 2, (), generator=gen, device=dev))
    kind[good[:n_fine]] = FINE
    kind[good[n_fine:]] = COARSE

    img = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    for group in ((COARSE, FINE), (BLURRY,), (WHITE,)):
        for i in np.flatnonzero(np.isin(kind, group)).tolist():
            y, x = origins[i].tolist()
            if kind[i] in TEXTURES:
                tex = TEXTURES[int(kind[i])]
                grid = int(torch.randint(tex["grid"][0], tex["grid"][1] + 1, (),
                                         generator=gen, device=dev))
                lo, hi = tex["grain"]
                grain = lo + (hi - lo) * float(torch.rand((), generator=gen, device=dev))
                patch = _noise(gen, tile, grid, grain)
            elif kind[i] == BLURRY:
                patch = _noise(gen, tile, BLURRY_GRID, 0.0)
            else:
                patch = 245.0 + torch.randint(0, 10, (tile, tile), generator=gen,
                                              device=dev).to(torch.float32)
            img[y:y + tile, x:x + tile] = patch
    image = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return Chunk(image=image, origins=origins, kind=kind)

