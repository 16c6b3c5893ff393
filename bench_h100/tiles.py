"""The traffic generator: seeded grayscale tiles and masks, made on the
device in bulk and kept in host memory as the pool the requests draw from.

The tile is ``training_tile`` of ``chip_smoke.py`` (smooth cubic-resized
noise, bright round blobs, Gaussian grain, uint8), computed for a whole
pool at once with torch instead of one tile at a time with numpy and cv2.
``dim`` darkens the blobs of every other tile, as ``write_cls_eval_set``
there makes its "not adipose" tiles. Radii scale with the tile size, so
small test tiles keep the shape of the 1024^2 ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOBS = (6, 14)  # chip_smoke.py's count of blobs a tile, drawn in [6, 14)


def blob_tiles(n: int, size: int, gen: torch.Generator, dim: float = 0.0,
               blobs: tuple[int, int] = BLOBS) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, size, size) uint8 tiles and their (n, size, size) uint8 {0, 1}
    blob masks on ``gen``'s device; tile i has its blobs darkened by ``dim``
    grey levels when i is odd, and a count of blobs drawn in ``blobs``."""
    dev = gen.device
    most = blobs[1] - 1
    coarse = torch.rand((n, 1, 10, 10), generator=gen, device=dev)
    img = 70.0 + 60.0 * F.interpolate(coarse, size=(size, size), mode="bicubic",
                                      align_corners=False)[:, 0]
    count = torch.randint(blobs[0], blobs[1], (n, 1), generator=gen, device=dev)
    centers = torch.randint(0, size, (n, most, 2), generator=gen, device=dev)
    radii = torch.randint(30, 120, (n, most), generator=gen, device=dev) * size // 1024
    radii = radii.clamp_min(2)
    grain = torch.randn((n, size, size), generator=gen, device=dev)
    axis = torch.arange(size, device=dev)
    mask = torch.zeros((n, size, size), dtype=torch.bool, device=dev)
    for k in range(most):
        dy = axis[None, :, None] - centers[:, k, 0, None, None]
        dx = axis[None, None, :] - centers[:, k, 1, None, None]
        inside = dy * dy + dx * dx <= (radii[:, k] ** 2)[:, None, None]
        mask |= inside & (k < count)[:, :, None]
    m = mask.to(torch.float32)
    odd = (torch.arange(n, device=dev) % 2 == 1).to(torch.float32)[:, None, None]
    img = img + (80.0 - dim * odd) * m + 10.0 * grain
    return img.clamp(0, 255).to(torch.uint8), mask.to(torch.uint8)


def host_pool(n: int, size: int, gen: torch.Generator, dim: float = 0.0,
              blobs: tuple[int, int] = BLOBS) -> tuple[np.ndarray, np.ndarray]:
    """:func:`blob_tiles` copied to host memory, made in blocks of 16 tiles
    so the device's share stays small."""
    imgs, masks = [], []
    for start in range(0, n, 16):
        i, m = blob_tiles(min(16, n - start), size, gen, dim, blobs)
        imgs.append(i.cpu().numpy())
        masks.append(m.cpu().numpy())
    return np.concatenate(imgs), np.concatenate(masks)


def request_rows(index: int, per_request: int, pool: int) -> slice | np.ndarray:
    """The pool rows of request ``index``: consecutive, wrapping round, so
    that no request repeats the rows of the one before it (pool >= 2 *
    per_request)."""
    start = (index * per_request) % pool
    if start + per_request <= pool:
        return slice(start, start + per_request)
    return np.arange(start, start + per_request) % pool
