"""Spatially sharded DilatedUNet inference (``adipose_tpu/parallel/spatial_unet.py``).

When the latency of one image matters more than throughput, the same params
run over a group of ranks with the image's rows cut into slabs. The
decomposition is ``DilatedUNet.spatial``'s, the one spatially sharded
training runs:

  * levels 1-2 run H-sharded, with a 1-row halo exchange per 3x3 conv
    (:mod:`adipose_tpu_torch.parallel.spatial`);
  * the /4 maps are all-gathered, and level 3, the dilated bottleneck and
    decoder level 3 run replicated: a rate-32 conv would need 32-row halos,
    more than a slab holds;
  * the decoder re-shards at /2 by a local slice of the replicated
    upsample, and level 1's fused upsample-conv runs on a 1-row halo;
  * the head is kernel B (``adipose::sigmoid_head``) on each slab.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import functional_call

from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.parallel.multihost import SlabShard


def spatial_unet_predict(params: dict[str, torch.Tensor], images: torch.Tensor, group=None,
                         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """H-sharded DilatedUNet inference over the ranks of ``group``:
    (B, H, W) normalized images, the same global batch on every rank ->
    (B, H, W) float32 class-1 probabilities on every rank.

    ``params`` is a DilatedUNet state dict on the images' device, run as it
    is (not copied) by the model in eval mode with the fast head. H must
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
    model = DilatedUNet(init_nb=params["down1_conv1.weight"].shape[0],
                        compute_dtype=compute_dtype, fast_head=True, device="meta").eval()
    model.spatial = slab = SlabShard(dist.get_rank(group), n, group)
    with torch.inference_mode():
        return functional_call(model, params, (slab.rows(images),), strict=True)
