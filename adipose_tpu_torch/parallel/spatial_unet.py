"""Spatially sharded DilatedUNet inference (``adipose_tpu/parallel/spatial_unet.py``).

When the latency of one image matters more than throughput, the same params
run over a group of ranks with the image's rows cut into slabs. The
decomposition is the JAX module's, chosen by where the work is:

  * levels 1-2 run H-sharded, with a 1-row halo exchange per 3x3 conv
    (:mod:`adipose_tpu_torch.parallel.spatial`);
  * the /4 maps are all-gathered, and level 3, the dilated bottleneck and
    decoder level 3 run replicated: a rate-32 conv would need 32-row halos,
    more than a slab holds;
  * the decoder re-shards at /2 by a local slice of the replicated
    upsample, and level 1's fused upsample-conv runs on a 1-row halo;
  * the head is kernel B (``adipose::sigmoid_head``) on each slab.

The graph is the port's ``DilatedUNet`` inference, layer for layer, with
the params of its state dict (Keras names).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from adipose_tpu_torch.models.unet import upsample_nearest_2x
from adipose_tpu_torch.ops.cuda.unet_kernels import diff_sigmoid_head
from adipose_tpu_torch.parallel.collectives import gather_rows
from adipose_tpu_torch.parallel.spatial import halo_exchange, local_rows, spatial_max_pool2

_CL = torch.channels_last


@torch.inference_mode()
def spatial_unet_predict(params: dict[str, torch.Tensor], images: torch.Tensor, group=None,
                         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """H-sharded DilatedUNet inference over the ranks of ``group``:
    (B, H, W) normalized images, the same global batch on every rank ->
    (B, H, W) float32 class-1 probabilities on every rank.

    ``params`` is a DilatedUNet state dict on the images' device. H must
    divide by 8 times the group size (three pools slab-local).
    Deep-supervision params are rejected: this forward gives only the main
    head, and dropping ``aux_out*`` silently would hide a checkpoint/config
    mismatch."""
    aux = sorted({k.split(".")[0] for k in params if k.startswith("aux_out")})
    if aux:
        raise ValueError(f"spatial_unet_predict does not support deep-supervision "
                         f"checkpoints (found {aux}); run the aux-head forward through "
                         f"DilatedUNet, or drop the aux heads from the state dict explicitly "
                         f"if only main_out is wanted")
    n = dist.get_world_size(group)
    if images.shape[-2] % (8 * n):
        raise ValueError(f"H {images.shape[-2]} must divide by 8 x {n} slabs")
    dt = compute_dtype

    def wb(name):
        w = params[f"{name}.weight"].to(dt, memory_format=_CL)
        return w, params[f"{name}.bias"].to(dt)

    def conv(x, name, dilation=1, h_pad=True):
        """3x3 conv + bias + ReLU, SAME on W; SAME on H, or VALID on a
        haloed slab."""
        w, b = wb(name)
        ph = dilation if h_pad else 0
        return F.relu(F.conv2d(x, w, b, padding=(ph, dilation), dilation=dilation))

    def sconv(x, name):
        return conv(halo_exchange(x, 1, group), name, h_pad=False)

    def upconv(x, name):
        """Nearest-x2 upsample + 3x3 conv + ReLU over the global rows."""
        return conv(upsample_nearest_2x(x), name)

    def supconv(x, name):
        """The same on a slab: upsample the 1-row-haloed slab, keep one
        upsampled row each side (zeros at the image edges, as the global
        padding), VALID on H."""
        y = upsample_nearest_2x(halo_exchange(x, 1, group))[..., 1:-1, :]
        return conv(y, name, h_pad=False)

    def cat(*ts):
        return torch.cat(ts, dim=1).contiguous(memory_format=_CL)

    x = local_rows(images, group).unsqueeze(1).to(dt).contiguous(memory_format=_CL)
    # encoder levels 1-2: sharded with halos
    d1 = sconv(sconv(x, "down1_conv1"), "down1_conv2")
    d2 = sconv(sconv(spatial_max_pool2(d1), "down2_conv1"), "down2_conv2")
    # all-gather at /4; the middle of the net runs replicated
    full = gather_rows(spatial_max_pool2(d2), -2, group).contiguous(memory_format=_CL)
    d3 = conv(conv(full, "down3_conv1"), "down3_conv2")
    d = F.max_pool2d(d3, 2)
    taps = []
    for i, rate in enumerate((1, 2, 4, 8, 16, 32)):
        d = conv(d, f"dilate{i + 1}", dilation=rate)
        taps.append(d)
    y = cat(d3, upconv(sum(taps), "up3_conv1"))
    up3 = conv(conv(y, "up3_conv2"), "up3_conv3")
    # decoder level 2: replicated upsample, re-sharded by a local slice
    y2 = cat(d2, local_rows(upconv(up3, "up2_conv1"), group))
    up2 = sconv(sconv(y2, "up2_conv2"), "up2_conv3")
    # decoder level 1: sharded fused upsample-conv on a 1-row halo
    y1 = cat(d1, supconv(up2, "up1_conv1"))
    up1 = sconv(sconv(y1, "up1_conv2"), "up1_conv3").contiguous(memory_format=_CL)
    hw = params["output_softmax.weight"][:, :, 0, 0]
    hb = params["output_softmax.bias"]
    probs = diff_sigmoid_head(up1, (hw[1] - hw[0]).to(dt), hb[1] - hb[0])
    return gather_rows(probs, -2, group)
