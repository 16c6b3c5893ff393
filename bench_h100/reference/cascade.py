"""The dual-model WSI cascade as the reference describes it, plain float32
(``README.md:3-15`` of github.com/MAGIC-SCAN/adipose_tissue-unet): a chunk
is cut into tiles, each tile passes QC, the InceptionV3 gate classifies
every tile, the U-Net segments the QC-good tiles the gate passes, and the
tiles' maps are blended with a Gaussian weight into the chunk's map.

  tiles   origins ``y = 0, s, 2s, ...`` with ``s = tile * (1 - overlap)``,
          the last one of each axis clamped to ``side - tile``, row-major
  QC      empty when the share of pixels >= 235 exceeds 0.70; blurry, when
          not empty, when the population variance of the 3x3 Laplacian
          (reflect-101 border) is below 7.5
          (``Segmentation/build_dataset.py:1253-1284``)
  gate    :func:`inception.preprocess` (1-99 percentile stretch, the
          antialiased resize to 299^2) -> :func:`inception.classify`
  U-Net   the dataset z-score -> :func:`unet.forward`, on the positive tiles
  blend   the Gaussian weight map peak-normalised to 1
          (``full_evaluation_enhanced.py:133-148``); the weights summed
          over every tile, the weighted maps over the positive tiles only,
          the map their quotient

Departures: QC's Laplacian is computed in float64 (the reference's cv2
call gives float64); a chunk smaller than a tile is not handled (the
program pads it by reflection); a tile that is not positive adds nothing
to the numerator, as in the program, where the reference writes a map of
zeros for it. The gate runs on every tile, whatever its QC verdict, as
the program runs it, so that both can be compared tile by tile.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference import inception, unet

GATE_BLOCK = 16  # tiles a gate forward at a time
UNET_BLOCK = 4  # tiles a U-Net forward at a time


def axis_origins(side: int, tile: int, overlap: float) -> list[int]:
    """Tile origins along one axis of ``side`` pixels (``side >= tile``)."""
    if side < tile:
        raise ValueError(f"a side of {side} is shorter than the tile {tile}")
    stride = int(tile * (1.0 - overlap))
    origins = list(range(0, side - tile + 1, stride))
    if origins[-1] != side - tile:
        origins.append(side - tile)
    return origins


def tile_origins(shape, tile: int, overlap: float = 0.0) -> np.ndarray:
    """(N, 2) int32 (y, x) origins of a chunk's tiles, row-major."""
    ys, xs = axis_origins(shape[0], tile, overlap), axis_origins(shape[1], tile, overlap)
    return np.asarray([(y, x) for y in ys for x in xs], dtype=np.int32).reshape(-1, 2)


def cut(chunk: torch.Tensor, origins: np.ndarray, tile: int) -> torch.Tensor:
    """(N, tile, tile) tiles of an (H, W) chunk at ``origins``."""
    return torch.stack([chunk[y:y + tile, x:x + tile] for y, x in origins.tolist()])


def qc(tiles: torch.Tensor, white_threshold: float = 235.0, white_ratio: float = 0.70,
       blur_threshold: float = 7.5) -> dict[str, torch.Tensor]:
    """(B,) ``white_share``, ``laplacian_var`` (float64) and ``good`` of
    (B, H, W) grayscale tiles."""
    x = tiles.to(torch.float64)
    white_share = (x >= white_threshold).to(torch.float64).mean(dim=(1, 2))
    p = F.pad(x[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    lap = p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:] - 4.0 * x
    lap_var = lap.var(dim=(1, 2), correction=0)
    empty = white_share > white_ratio
    blurry = ~empty & (lap_var < blur_threshold)
    return {"white_share": white_share, "laplacian_var": lap_var, "good": ~(empty | blurry)}


def gate_features(params: dict, tiles: torch.Tensor, quant: str = "fp32",
                  block: int = GATE_BLOCK) -> torch.Tensor:
    """(B, 2048) globally pooled InceptionV3 features of (B, H, W) tiles, the
    input of the gate's Dense head."""
    return torch.cat([inception.features(params, inception.preprocess(
        tiles[i:i + block].to(torch.float32)), quant).mean(dim=(2, 3))
        for i in range(0, tiles.shape[0], block)])


def gate_head(params: dict, pooled: torch.Tensor) -> torch.Tensor:
    """(B,) probabilities of pooled features: Dense(1) and the sigmoid, as
    :func:`inception.classify` ends."""
    return torch.sigmoid(pooled @ params["adipose_score.weight"].T
                         + params["adipose_score.bias"])[:, 0]


def segment(params: dict, tiles: torch.Tensor, mean: float, std: float, rates,
            quant: str = "fp32", block: int = UNET_BLOCK) -> torch.Tensor:
    """(B, H, W) U-Net probabilities of (B, H, W) tiles."""
    if tiles.shape[0] == 0:
        return torch.zeros(tiles.shape, dtype=torch.float32, device=tiles.device)
    return torch.cat([unet.forward(params, unet.zscore(tiles[i:i + block], mean, std), rates,
                                   quant=quant)
                      for i in range(0, tiles.shape[0], block)])


def weight_map(tile: int, sigma_factor: float = 0.25, device=None) -> torch.Tensor:
    """(tile, tile) float32 Gaussian of the distance to the tile's centre
    ``tile / 2``, sigma ``tile * sigma_factor``, its peak 1; computed in
    float64."""
    c = torch.arange(tile, dtype=torch.float64, device=device) - tile / 2.0
    sigma = tile * sigma_factor
    w = torch.exp(-(c[:, None] ** 2 + c[None, :] ** 2) / (2.0 * sigma * sigma))
    return (w / w.max()).to(torch.float32)


def blend(shape, origins: np.ndarray, positive: np.ndarray, maps: torch.Tensor,
          weights: torch.Tensor) -> torch.Tensor:
    """The (H, W) map of a chunk: ``maps`` are the positive tiles' (P, T, T)
    probabilities in tile order; every tile adds its weight to the
    denominator."""
    t = weights.shape[-1]
    acc = torch.zeros(tuple(shape), dtype=torch.float32, device=weights.device)
    wsum = torch.zeros_like(acc)
    k = 0
    for (y, x), pos in zip(origins.tolist(), positive.tolist()):
        wsum[y:y + t, x:x + t] += weights
        if pos:
            acc[y:y + t, x:x + t] += maps[k] * weights
            k += 1
    return acc / wsum


def margins(verdict: dict, white_ratio: float = 0.70, blur_threshold: float = 7.5) -> float:
    """The least relative distance of any tile's QC number from the
    threshold that decides it: the white share from ``white_ratio``, and,
    for tiles that are not empty, the Laplacian variance from
    ``blur_threshold``."""
    share = verdict["white_share"].cpu().numpy()
    lap = verdict["laplacian_var"].cpu().numpy()
    out = np.abs(share - white_ratio) / white_ratio
    not_empty = share <= white_ratio
    if not_empty.any():
        out = np.minimum(out, np.where(not_empty, np.abs(lap - blur_threshold) / blur_threshold,
                                       math.inf))
    return float(out.min())
