"""Differentiable collectives for the port's multi-process paths.

Small ``torch.autograd.Function``s with explicit backwards (the
``torch.distributed.nn`` functions are deprecated). Their convention: every
rank computes the same global loss from gathered values, and the backward
of a gather keeps only the rank's own slice. Each rank's parameter
gradient is then its rows' share of the global gradient, and the shares
are **summed** over the ranks (:func:`all_reduce_grads_`). A gather whose
backward summed over the ranks would need a mean instead; mixing the two
conventions is off by the world size.

bfloat16 tensors travel as their bytes, so a gather moves them bit for bit
whatever dtypes a backend's all-gather takes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_tensors(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on every rank), in group-rank order."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p.view(x.dtype) for p in parts] if wire is not x else parts


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group, sum_grads: bool) -> torch.Tensor:
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        ctx.group, ctx.sum_grads = group, sum_grads
        return torch.cat(all_gather_tensors(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.sum_grads:  # a reduce-scatter: every rank's share of my rows
            total = g.to(torch.float32).contiguous()
            dist.all_reduce(total, group=ctx.group)
            g = total.to(g.dtype)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


def gather_rows(x: torch.Tensor, dim: int = 0, group=None,
                sum_grads: bool = False) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order.
    Differentiable: the backward keeps this rank's slice of the gradient.

    That is right where every rank computes the same loss from the gathered
    tensor. Where each rank instead computes from it only its own share of
    the loss (a replicated computation whose output each rank slices to its
    rows), its gradient is that share alone: ``sum_grads`` then sums the
    ranks' gradients (in float32) before keeping the slice, a reduce-scatter."""
    return _GatherRows.apply(x, dim, group, sum_grads)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # the sum feeds every rank's share of the loss: its gradient is the
        # sum of the ranks' incoming gradients
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank. Differentiable."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_grads_(grads: list[torch.Tensor | None], group=None) -> list[torch.Tensor | None]:
    """Sum each rank's share of the gradients in place: one all-reduce of
    the flattened float32 gradients (None entries stay None)."""
    live = [g for g in grads if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in live])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in live:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return grads
