"""Process groups and per-process data (``adipose_tpu/parallel/multihost.py``).

The JAX package starts ``jax.distributed`` and lays a global mesh out with
the process boundary on the outermost data axis. The port runs one process
per device over ``torch.distributed``:

  * :func:`initialize_multihost` - ``init_process_group`` from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or from explicit arguments; a no-op for one process and
    safe to call twice, as the JAX function is;
  * :func:`make_global_mesh` - the process-major plan over every rank, the
    model axis inside one host's ranks;
  * :func:`local_batch_slice` / :func:`make_global_array` - each process
    reads only its rows of a global batch; an all-gather puts the rows back
    together;
  * :class:`BatchShard` - which rows of a global batch a process holds, so a
    model draws its dropout masks for the global batch and keeps its rows,
    and a train-mode BatchNorm reduces its statistics over the group;
  * :class:`SlabShard` - which row slab of each tile a process holds under
    spatial sharding, and the group of the processes that hold the others;
  * :func:`spawn_ranks` - start the ranks without a launcher: one spawned
    process each, meeting at a file store in the spawn's own directory.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from adipose_tpu_torch.parallel.mesh import MeshPlan

#: Seconds a rank waits at the rendezvous and in a collective before it fails.
DEFAULT_TIMEOUT_S = 60.0


def launched_world_size() -> int:
    """``WORLD_SIZE`` as a launcher set it, or 1."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, backend: str | None = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group when several processes are
    configured; else a no-op. True iff a process group is (now) up.

    With no arguments it reads torchrun's environment; explicit
    ``init_method``, ``world_size`` and ``rank`` cover a launch of one's own
    (:func:`spawn_ranks`). The backend defaults to NCCL where CUDA is
    available and gloo otherwise. Safe to call twice."""
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if init_method is not None and world_size is not None:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timeout)
    elif launched_world_size() > 1:  # the launcher's environment (env://)
        dist.init_process_group(backend, timeout=timeout)
    else:
        return False  # a single process: nothing to start
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_object(obj, group=None):
    """Rank 0's ``obj`` on every rank (a picklable host value); the value
    itself outside a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def barrier(group=None) -> None:
    """Wait for every rank; nothing outside a process group."""
    if dist.is_initialized():
        dist.barrier(group=group)


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` under a launcher,
    else its rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def make_global_mesh(model_axis: int = 1) -> MeshPlan:
    """(data, model) plan over every rank of every host. Ranks are numbered
    host-major (torchrun's order), so the data axis crosses hosts outermost
    and each model group is ``model_axis`` consecutive ranks of one host:
    the per-step gradient reduction is the only traffic between hosts. One
    host gives ``mesh.make_mesh(model_axis=...)`` over its ranks."""
    n = process_count()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n)
    if per_host % model_axis != 0:
        raise ValueError(f"{per_host} ranks/host not divisible by model_axis={model_axis}")
    return MeshPlan(n // model_axis, model_axis)


def local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """(start, size) of this process's contiguous rows of the global batch,
    which must divide by the process count."""
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    size = global_batch_size // n
    return process_index() * size, size


def make_global_array(local_data, group=None) -> torch.Tensor:
    """The global batch from each process's rows (``local_data``, a tensor or
    array whose leading axis is this process's slice, see
    :func:`local_batch_slice`), all-gathered in rank order. One process:
    the rows themselves, as a tensor."""
    from adipose_tpu_torch.parallel.collectives import gather_rows

    t = local_data if isinstance(local_data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(local_data))
    return gather_rows(t, 0, group) if dist.is_initialized() else t


@dataclass(frozen=True)
class BatchShard:
    """Rows ``[start, start + size)`` of a global batch of ``total`` rows,
    held by this process, whose peers form ``group`` (None: the default
    group)."""

    start: int
    size: int
    total: int
    group: object = None

    @classmethod
    def of_process(cls, global_batch: int, group=None) -> "BatchShard":
        """This process's rows (:func:`local_batch_slice`)."""
        return cls(*local_batch_slice(global_batch), global_batch, group)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``t``, a tensor of the global batch."""
        return t[self.start:self.start + self.size]


@dataclass(frozen=True)
class SlabShard:
    """Slab ``index`` of ``count`` equal slabs of rows of each tile, held by
    this process under spatial sharding; the processes that hold the
    tile's slabs form ``group``, in slab order."""

    index: int
    count: int
    group: object = None

    def rows(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This process's slab of ``t``, a tensor of whole tiles whose rows
        are ``dim``."""
        h = t.shape[dim]
        if h % self.count:
            raise ValueError(f"H {h} not divisible by {self.count} slabs")
        size = h // self.count
        return t.narrow(dim, self.index * size, size)


def _rank_entry(rank: int, fn, world_size: int, init_method: str, backend: str,
                timeout_s: float, out_dir: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "gloo" and not torch.cuda.is_available():
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_multihost(init_method, world_size, rank, backend, timeout_s)
    try:
        result = fn(rank, *args)
        if rank == 0:
            Path(out_dir, "result.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (), backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined in
    one process group (``backend``; ``timeout_s`` for the rendezvous and
    each collective). The ranks meet at a file store in the spawn's own
    temporary directory, so spawns started at once never race for a port.
    ``fn`` must be a module-level function. Returns rank 0's return value;
    when a rank fails, the others are stopped and its error is raised here."""
    with tempfile.TemporaryDirectory(prefix="adipose_ranks_") as out_dir:
        init_method = Path(out_dir, "rendezvous").as_uri()
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, world_size, init_method, backend, timeout_s, out_dir, args),
            nprocs=world_size, join=True, start_method="spawn")
        return pickle.loads(Path(out_dir, "result.pkl").read_bytes())
