"""Spatial (H-sharded) halo-exchange primitives (``adipose_tpu/parallel/spatial.py``).

One image too large, or too latency-critical, for one device is cut into
row slabs, one per rank of a group; a convolution sees its neighbours'
border rows through a halo exchange. Tensors are NCHW (``torch.channels_last``
memory is fine) or (B, H, W): H is always ``dim -2``.

The exchange is one all-gather of each rank's first and last ``halo`` rows,
which every backend (NCCL; gloo on CPU and CUDA tensors) runs alike; each
rank keeps its two neighbours' rows. Its backward sends the halo rows'
gradients back the same way and adds them onto the rows they came from, so
a rank's input gradient is its rows' share of the global one (the
convention of :mod:`adipose_tpu_torch.parallel.collectives`: weight
gradients sum over the ranks).

Semantics as the JAX module's: out-of-image halos are zeros (SAME zero
padding at the global border); slab heights are equal and at least the
halo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from adipose_tpu_torch.parallel.collectives import all_gather_tensors, gather_rows


def _neighbours(parts: list[torch.Tensor], idx: int, halo: int):
    """(rows from the previous rank's tail, rows from the next rank's head)
    of the gathered ``[head, tail]`` pairs, zeros at the global edges."""
    n = len(parts)
    like = parts[idx][..., :halo, :]
    prev = parts[idx - 1][..., halo:, :] if idx > 0 else torch.zeros_like(like)
    nxt = parts[idx + 1][..., :halo, :] if idx < n - 1 else torch.zeros_like(like)
    return prev, nxt


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, group) -> torch.Tensor:
        ctx.halo, ctx.group = halo, group
        ctx.idx = dist.get_rank(group)
        pair = torch.cat([x[..., :halo, :], x[..., -halo:, :]], dim=-2)
        prev, nxt = _neighbours(all_gather_tensors(pair, group), ctx.idx, halo)
        return torch.cat([prev, x, nxt], dim=-2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        halo, idx = ctx.halo, ctx.idx
        # my top halo's gradient belongs to the previous rank's tail rows,
        # my bottom halo's to the next rank's head rows
        pair = torch.cat([g[..., -halo:, :], g[..., :halo, :]], dim=-2)
        parts = all_gather_tensors(pair, ctx.group)
        dx = g[..., halo:-halo, :].clone()
        if idx > 0:
            dx[..., :halo, :] += parts[idx - 1][..., :halo, :]
        if idx < len(parts) - 1:
            dx[..., -halo:, :] += parts[idx + 1][..., halo:, :]
        return dx, None, None


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Pad an H-sharded slab with ``halo`` rows from each neighbour of
    ``group``: (..., H_local + 2 * halo, W), zeros beyond the global image.
    Differentiable."""
    if x.shape[-2] < halo:
        raise ValueError(f"slab height {x.shape[-2]} must be >= halo {halo}: one exchange "
                         "only reaches the adjacent slab")
    if dist.get_world_size(group) == 1:
        pad = torch.zeros_like(x[..., :halo, :])
        return torch.cat([pad, x, pad], dim=-2)
    return _HaloExchange.apply(x, halo, group)


def _conv_local(x: torch.Tensor, weight: torch.Tensor, dilation: tuple) -> torch.Tensor:
    """SAME on W, VALID on the (haloed) H, of one NCHW slab; weight OIHW."""
    pad_w = dilation[1] * (weight.shape[-1] - 1) // 2
    return F.conv2d(x, weight, padding=(0, pad_w), dilation=tuple(dilation))


def spatial_conv2d(x: torch.Tensor, weight: torch.Tensor, group=None,
                   dilation: tuple = (1, 1)) -> torch.Tensor:
    """H-sharded SAME convolution (odd kernel, OIHW weight) of an NCHW slab:
    the global SAME convolution's rows of this slab. The halo is
    ``dilation_h * (kh // 2)`` rows a side."""
    halo = dilation[0] * (weight.shape[-2] // 2)
    xp = halo_exchange(x, halo, group) if halo else x
    return _conv_local(xp, weight, tuple(dilation))


def spatial_max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of an H-sharded slab; the slab height must be
    even, so no window straddles two slabs."""
    if x.shape[-2] % 2:
        raise ValueError(f"slab height {x.shape[-2]} must be even for 2x2 pooling")
    return F.max_pool2d(x, 2)


def local_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slab of a global image: its equal share of ``dim -2``."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    h = x.shape[-2]
    if h % n:
        raise ValueError(f"H {h} not divisible by {n} slabs")
    return x[..., idx * (h // n):(idx + 1) * (h // n), :]


def sharded_conv_fn(group=None):
    """``f(image, weight, dilation=(1, 1))`` on a GLOBAL NCHW image held by
    every rank of ``group``: each rank convolves its slab with
    :func:`spatial_conv2d` and the slabs are all-gathered back into the
    global output. Differentiable (each rank's input gradient is its rows'
    share; weight gradients sum over the ranks)."""

    def run(x: torch.Tensor, weight: torch.Tensor, dilation: tuple = (1, 1)) -> torch.Tensor:
        y = spatial_conv2d(local_rows(x, group), weight, group, tuple(dilation))
        return gather_rows(y, -2, group)

    return run
