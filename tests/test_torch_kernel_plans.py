"""The launch plans of kernels I and B', held against brute force on the CPU.

Kernel I (``ops/cuda/layout.py:ident_plan``) copies a dense tensor as one run
folded from its dimensions by stride, in vectors as wide as the two tensors'
addresses allow. Kernel B' (``ops/cuda/unet_kernels.py:head_bwd_plan``) gives
each thread of its period path the same channels in every vector it visits.
The kernels run only on the card; these tests check, for the shapes the
kernels take, the index arithmetic their plans stand on.
"""

import itertools
import math

import pytest
import torch

from adipose_tpu_torch.ops.cuda.layout import coalesce, ident_plan
from adipose_tpu_torch.ops.cuda.unet_kernels import head_bwd_plan

B, H, W = 2, 6, 5  # small (B, H, W) for the views


def offsets(shape, strides) -> list[int]:
    """Every element offset that ``shape`` and ``strides`` reach, with
    repeats."""
    return [sum(i * s for i, s in zip(index, strides))
            for index in itertools.product(*(range(n) for n in shape))]


def hwbc(channels: int, layout: str) -> torch.Tensor:
    """A (H, W, B, C) tensor: the probe's view of a channels-last (B, C, H, W)
    activation, a contiguous tensor, or either with size-1 dimensions."""
    if layout == "channels_last_view":
        return torch.empty(B, H, W, channels).permute(1, 2, 0, 3)
    if layout == "contiguous":
        return torch.empty(H, W, B, channels)
    if layout == "size1_view":
        return torch.empty(1, 1, W, channels).permute(1, 2, 0, 3)
    return torch.empty(H, 1, 1, channels)  # "size1_contiguous"


# (x, out) byte addresses: both aligned, or x starting inside a 16-byte line
IDENT_ADDRESSES = [(0, 0), (4096, 512), (2, 0), (8, 512), (14, 256)]


@pytest.mark.parametrize("layout", ["channels_last_view", "contiguous", "size1_view",
                                    "size1_contiguous"])
@pytest.mark.parametrize("channels", [44, 64, 88, 176, 7, 37])
def test_ident_plan_runs_cover_every_offset_once(layout, channels):
    t = hwbc(channels, layout)
    runs = coalesce(t.shape, t.stride())
    assert len(runs) == 1 and runs[0][1] == 1
    for x_addr, out_addr in IDENT_ADDRESSES:
        plan = ident_plan(t.shape, t.stride(), x_addr, out_addr)
        # The run [0, run_len) holds each offset the strides reach once.
        assert sorted(offsets(t.shape, t.stride())) == list(range(plan.run_len))
        # Whole vectors, then a tail shorter than one.
        assert plan.tail == plan.run_len % plan.vec and 0 <= plan.tail < plan.vec


@pytest.mark.parametrize("x_addr,out_addr", IDENT_ADDRESSES)
def test_ident_plan_vectorizes_only_what_is_aligned(x_addr, out_addr):
    plan = ident_plan((1000, 3), (3, 1), x_addr, out_addr)
    aligned = x_addr % 16 == 0 and out_addr % 16 == 0
    assert plan.vec == (8 if aligned else 1)


@pytest.mark.parametrize("shape,strides", [
    ((4, 4, 2, 8), (64, 16, 8, 1)),  # contiguous
    ((4, 4, 2, 8), (32, 8, 128, 1)),  # the probe's view of a channels-last tensor
    ((4, 4, 2, 16), (128, 32, 16, 1)),  # contiguous, dense
    ((4, 4, 2, 8), (128, 32, 16, 1)),  # gapped: the first 8 of 16 channels
    ((4, 4, 2, 8), (32, 8, 0, 1)),  # overlapping: an expanded dimension
    ((1, 1, 1, 1), (1, 1, 1, 1)),  # one element
])
def test_coalesce_reaches_the_same_offsets(shape, strides):
    runs = coalesce(shape, strides)
    assert math.prod(n for n, _ in runs) == math.prod(shape)
    assert sorted(offsets(*zip(*runs))) == sorted(offsets(shape, strides))
    dense = sorted(offsets(shape, strides)) == list(range(math.prod(shape)))
    assert dense == (len(runs) == 1 and runs[0][1] == 1)
    if not dense:
        with pytest.raises(ValueError, match="not one run"):
            ident_plan(shape, strides, 0, 0)


def brute_force_visits(plan, channels: int, npix: int, blocks: int):
    """Replay the period path's loop: thread ``(block, t)`` with lane ``t %
    P`` visits vectors ``q * P + lane`` for ``q`` from its first period by
    the grid's stride in periods, over every period the pixels touch.
    Yields (lane, vector) for each visit."""
    period, threads = plan.period, plan.block[0]
    nper = math.ceil(npix * channels / (period * plan.vec))
    qstride = blocks * threads // period
    for b, t in itertools.product(range(blocks), range(threads)):
        for q in range((b * threads + t) // period, nper, qstride):
            yield t % period, q * period + t % period


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("channels", [44, 64, 88, 176, 7, 37, 1, 3])
def test_head_bwd_plan_lanes_keep_their_channels(channels, itemsize):
    vec = 16 // itemsize
    plan = head_bwd_plan(channels, itemsize, 0, 4096)
    period = channels // math.gcd(channels, vec)
    takes_period = math.lcm(period, 32) <= 1024 and vec <= channels + 1
    assert plan.path == ("period" if takes_period else "general")
    if plan.path == "general":
        cols, lanes = plan.block
        assert (plan.vec, plan.period) == (1, 0)
        assert cols % 32 == 0 and cols * lanes == 256 and cols >= min(channels + 1, 256)
        return
    threads = plan.block[0]
    assert (plan.vec, plan.period, plan.block[1]) == (vec, period, 1)
    assert threads % 32 == 0 and threads % period == 0 and threads <= 1024
    ppp = period * vec // channels  # pixels per period
    for npix, blocks in ((5 * ppp, 1), (37 * ppp + ppp // 2, 2), (301, 3)):
        # Every vector of every period the pixels touch, once; the last
        # period's elements past the pixels are skipped one by one.
        seen = [0] * (math.ceil(npix / ppp) * period)
        for lane, v in brute_force_visits(plan, channels, npix, blocks):
            seen[v] += 1
            k0 = lane * vec // channels
            for u in range(vec):
                e = v * vec + u
                # The lane's channels are fixed, and the pixel is the first
                # or second of the vector's period-relative pair.
                assert e % channels == (lane * vec + u) % channels
                assert e // channels - (v // period) * ppp - k0 in (0, 1)
        assert seen == [1] * len(seen)


@pytest.mark.parametrize("itemsize,x_addr", [(2, 2), (2, 6), (2, 8), (4, 4), (4, 8), (4, 12)])
def test_head_bwd_plan_sends_unaligned_x_to_the_general_path(itemsize, x_addr):
    assert head_bwd_plan(44, itemsize, 4096 + x_addr, 8192).path == "general"
    assert head_bwd_plan(44, itemsize, 4096, 8192 + x_addr).path == "general"
    assert head_bwd_plan(44, itemsize, 4096, 8192).path == "period"
