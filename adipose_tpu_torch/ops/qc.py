"""Tile quality control (``adipose_tpu/ops/qc.py``), plain batched PyTorch.

A tile is *empty/white* when the share of pixels whose channels are all
>= 235 exceeds 0.70, and *blurry* when the population variance of its 3x3
Laplacian (of the cv2 grayscale, for RGB) is below 7.5; the white test runs
first, and the blur test disqualifies only non-empty tiles
(``Segmentation/build_dataset.py:1253-1284``). Both are elementwise or
small-stencil work over the whole batch at once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WHITE_THRESHOLD = 235.0
WHITE_RATIO = 0.70
BLUR_THRESHOLD = 7.5


def white_ratio(tiles: torch.Tensor, threshold: float = WHITE_THRESHOLD) -> torch.Tensor:
    """Share of near-white pixels of each (H, W) or (H, W, 3) tile of a
    batch; an RGB pixel is white only when all its channels are."""
    t = tiles.to(torch.float32)
    white = t >= threshold
    if t.dim() == 4:
        white = white.all(dim=-1)
    # XLA computes jnp.mean's division by the constant count as a multiply
    # by its float32 reciprocal; so does this, to give the same bits.
    inv_n = float(np.float32(1.0 / (white.shape[1] * white.shape[2])))
    return white.sum(dim=(1, 2)).to(torch.float32) * inv_n


def _cv2_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2's RGB->gray, bit-exact for uint8-valued input: fixed-point
    ``(R*9798 + G*19235 + B*3735 + 16384) >> 15``."""
    i = torch.round(rgb.to(torch.float32)).to(torch.int32)
    y = (i[..., 0] * 9798 + i[..., 1] * 19235 + i[..., 2] * 3735 + 16384) >> 15
    return y.to(torch.float32)


def laplacian_variance(tiles: torch.Tensor) -> torch.Tensor:
    """Population variance of each tile's 3x3 Laplacian response
    (``cv2.Laplacian(...).var()``), with reflect padding
    (cv2's BORDER_REFLECT_101, ``jnp.pad`` 'reflect')."""
    t = tiles.to(torch.float32)
    if t.dim() == 4:
        t = _cv2_gray(t)
    h, w = t.shape[-2:]
    p = F.pad(t[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    resp = (p[:, 0:h, 1:w + 1] + p[:, 2:h + 2, 1:w + 1]
            + p[:, 1:h + 1, 0:w] + p[:, 1:h + 1, 2:w + 2]
            - 4.0 * t)
    return resp.var(dim=(1, 2), correction=0)


def classify_tiles_batch(tiles: torch.Tensor, white_threshold: float = WHITE_THRESHOLD,
                         white_ratio_limit: float = WHITE_RATIO,
                         blur_threshold: float = BLUR_THRESHOLD) -> dict:
    """QC verdicts for a (B, H, W) or (B, H, W, 3) batch: a dict of (B,)
    tensors ``white_ratio``, ``laplacian_var``, ``is_empty``, ``is_blurry``
    and ``is_good``."""
    wr = white_ratio(tiles, white_threshold)
    lv = laplacian_variance(tiles)
    is_empty = wr > white_ratio_limit
    is_blurry = ~is_empty & (lv < blur_threshold)
    return {"white_ratio": wr, "laplacian_var": lv, "is_empty": is_empty,
            "is_blurry": is_blurry, "is_good": ~(is_empty | is_blurry)}


def classify_tile(tile: torch.Tensor, white_threshold: float = WHITE_THRESHOLD,
                  white_ratio_limit: float = WHITE_RATIO,
                  blur_threshold: float = BLUR_THRESHOLD) -> dict:
    """QC verdict for one (H, W) or (H, W, 3) tile, as 0-dim tensors."""
    out = classify_tiles_batch(tile[None], white_threshold, white_ratio_limit, blur_threshold)
    return {k: v[0] for k, v in out.items()}
