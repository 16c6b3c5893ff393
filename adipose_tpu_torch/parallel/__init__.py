"""Scale-out of the port (``adipose_tpu/parallel``) over ``torch.distributed``.

The JAX package lays one logical program over a device mesh and lets GSPMD
insert the collectives. The port runs one process per device instead (NCCL
on CUDA, gloo on the CPU), and this package supplies what that needs:

  * :mod:`.mesh` - the JAX planners' ``(data, model)`` shapes over a device
    count, a rank's rows of a global batch, broadcast from rank 0;
  * :mod:`.multihost` - process-group start-up from torchrun's environment
    or explicit arguments, the process-major global layout, per-rank data
    slices, and :func:`~.multihost.spawn_ranks` for a launch without torchrun;
  * :mod:`.collectives` - differentiable all-gather and all-reduce, and the
    gradient all-reduce of a data-parallel step;
  * :mod:`.spatial` and :mod:`.spatial_unet` - the H-sharded halo-exchange
    convolutions and the spatially sharded U-Net predict.
"""

from adipose_tpu_torch.parallel.mesh import (MeshPlan, make_mesh, make_mesh_for_batch,
                                             make_mesh_spatial, pad_batch_to, replicate,
                                             shard_batch)
from adipose_tpu_torch.parallel.multihost import (BatchShard, initialize_multihost,
                                                  local_batch_slice, make_global_array,
                                                  make_global_mesh, process_count,
                                                  process_index, spawn_ranks)

__all__ = [
    "MeshPlan", "make_mesh", "make_mesh_for_batch", "make_mesh_spatial", "pad_batch_to",
    "replicate", "shard_batch", "BatchShard", "initialize_multihost", "local_batch_slice",
    "make_global_array", "make_global_mesh", "process_count", "process_index", "spawn_ranks",
]
