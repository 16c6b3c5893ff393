"""Sliding-window inference (``adipose_tpu/eval/sliding_window.py``): the
image on the device from upload to blend, tiles predicted in batches, one
blend.

Behavioral spec: ``SlidingWindowInference``
(``full_evaluation_enhanced.py:233-329``): overlap <= 0.75, stride
tile * (1 - overlap), bounds-clamped positions, per-tile prediction (with
or without TTA), Gaussian, linear or no blending ('none' averages as
'linear' does).

An image smaller than the tile is reflect-padded up to the tile and the
map cropped back.

``group`` (a ``torch.distributed`` process group, the counterpart of the
JAX package's ``mesh``) spreads one image's tile stream over its ranks:
each rank predicts its equal share of every batch, the shares are
all-gathered, and every rank blends the same map. The batch rounds down to
a multiple of the ranks, at least one tile each, as the JAX package rounds
it to the mesh's data axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from adipose_tpu_torch.ops.blend import (blend_tiles, extract_tiles, gaussian_weight_map,
                                         sliding_window_positions)
from adipose_tpu_torch.parallel.collectives import all_gather_tensors


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of ``n`` samples followed by ``pad`` reflected past the end
    (edge not repeated), reflecting again as often as the pad needs: numpy's
    and ``jnp.pad``'s 'reflect', which ``F.pad`` gives only for pad < n."""
    period = max(2 * (n - 1), 1)
    i = np.arange(n + pad) % period
    return torch.from_numpy(np.where(i < n, i, period - i)).to(device)


class SlidingWindowInference:
    def __init__(self, tile_size: int = 1024, overlap: float = 0.5,
                 blend_mode: str = "gaussian", batch_size: int = 8,
                 sigma_factor: float = 0.25, transfer_dtype: str = "float32",
                 device="cuda", group=None):
        """``transfer_dtype`` 'float16' quantizes the blended map once, on the
        device, and halves its download. ``group``: the ranks that share
        the tile stream (see the module's docstring); every rank of it
        calls :meth:`predict` with the same image."""
        self.tile_size = tile_size
        self.overlap = max(0.0, min(overlap, 0.75))
        self.stride = int(tile_size * (1 - self.overlap))
        self.blend_mode = blend_mode
        self.group = group
        if group is not None:
            n = dist.get_world_size(group)
            batch_size = max(batch_size, n) // n * n  # a multiple of the ranks
        self.batch_size = batch_size
        self.transfer_dtype = transfer_dtype
        self.device = torch.device(device)
        if blend_mode == "gaussian":
            self.weight_map = gaussian_weight_map(tile_size, sigma_factor, device=self.device)
        else:
            self.weight_map = torch.ones((tile_size, tile_size), dtype=torch.float32,
                                         device=self.device)

    def _predict_batch(self, predict_fn, params, chunk: torch.Tensor) -> torch.Tensor:
        """``predict_fn`` of a batch; under ``group`` each rank predicts its
        share and the shares are all-gathered in rank order."""
        if self.group is None:
            return predict_fn(params, chunk)
        share = chunk.shape[0] // dist.get_world_size(self.group)
        start = dist.get_rank(self.group) * share
        mine = predict_fn(params, chunk[start:start + share].contiguous())
        return torch.cat(all_gather_tensors(mine, self.group))

    def predict(self, predict_fn, params, image) -> np.ndarray:
        """The (H, W) float32 probability map of an (H, W) image.

        ``predict_fn(params, tiles (B, T, T) float32) -> (B, T, T)``;
        normalization is the caller's business (folded into predict_fn).
        """
        # the image's own dtype crosses (a uint8 slide ships 4x fewer bytes)
        img = torch.as_tensor(np.asarray(image)).to(self.device).to(torch.float32)
        h, w = img.shape
        t = self.tile_size
        pad_h, pad_w = max(0, t - h), max(0, t - w)
        if pad_h or pad_w:
            rows = _reflect_index(h, pad_h, self.device)
            img = img[rows][:, _reflect_index(w, pad_w, self.device)]
        ph, pw = img.shape

        positions = sliding_window_positions((ph, pw), t, self.overlap)
        tiles = extract_tiles(img, positions, t)
        preds = []
        b = self.batch_size
        for i in range(0, tiles.shape[0], b):
            chunk = tiles[i:i + b]
            n = chunk.shape[0]
            if n < b:  # a fixed batch, as the JAX package compiles one program
                chunk = torch.cat([chunk, chunk[-1:].expand(b - n, -1, -1)])
            preds.append(self._predict_batch(predict_fn, params, chunk)[:n])
        full = blend_tiles(torch.cat(preds), positions, self.weight_map, ph, pw)
        if self.transfer_dtype == "float16":
            full = full.to(torch.float16)
        return full[:h, :w].cpu().numpy().astype(np.float32)
