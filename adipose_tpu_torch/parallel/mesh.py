"""Device plans and batch placement (``adipose_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` with a ``data`` axis (the
batch) and a ``model`` axis (image rows under spatial sharding). The port
runs one process per device, so a plan is only the mesh's shape and its
rank layout: rank ``r`` sits at ``ranks[r // model, r % model]``, the
data-major order the JAX package reshapes its device list into. The
planners keep the JAX rules exactly: the data axis is the largest device
count that divides the global batch, and under spatial sharding the
leftover devices go on a power-of-two model axis that divides H.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MeshPlan:
    """A ``(data, model)`` device plan over ``data * model`` ranks."""

    data: int
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """The JAX mesh's ``shape``: ``{"data": ..., "model": ...}``."""
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def ranks(self) -> np.ndarray:
        """(data, model) array of ranks, data-major."""
        return np.arange(self.size).reshape(self.data, self.model)

    def data_index(self, rank: int) -> int:
        return rank // self.model

    def model_index(self, rank: int) -> int:
        return rank % self.model

    def model_groups(self) -> list[list[int]]:
        """The ranks that share a tile's rows, one group per data index: the
        rows of :attr:`ranks`."""
        return self.ranks.tolist()

    def data_groups(self) -> list[list[int]]:
        """The ranks that hold the same H slab across the batch, one group
        per model index: the columns of :attr:`ranks`."""
        return self.ranks.T.tolist()


@dataclass(frozen=True)
class RankGrid:
    """This rank's place in a plan laid over the current process group: its
    (data, model) indices and the process groups of its model axis (the
    ranks that share its tiles' rows) and its data axis (the ranks that hold
    its H slab across the batch). A group's ranks are in index order, so
    the group rank of this process is its index on that axis."""

    plan: MeshPlan
    data_index: int
    model_index: int
    model_group: object
    data_group: object


def build_rank_grid(plan: MeshPlan) -> RankGrid:
    """The subgroups of ``plan`` over the current process group, whose size
    must be ``plan.size`` (the JAX package leaves surplus devices idle; here
    the launcher starts exactly the plan's ranks). Every rank creates every
    group, in the same order, the ones it is not in included: a rank that
    skipped one would leave the others waiting in ``new_group``."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != plan.size:
        raise ValueError(f"a ({plan.data}, {plan.model}) plan needs {plan.size} ranks; the "
                         f"process group has {world}")
    rank = dist.get_rank()
    data_index, model_index = plan.data_index(rank), plan.model_index(rank)
    model_groups = [dist.new_group(ranks) for ranks in plan.model_groups()]
    data_groups = [dist.new_group(ranks) for ranks in plan.data_groups()]
    return RankGrid(plan, data_index, model_index, model_groups[data_index],
                    data_groups[model_index])


def visible_devices() -> int:
    """The JAX package's ``len(jax.devices())``: the visible CUDA devices,
    or one device (the CPU) where there are none."""
    return torch.cuda.device_count() or 1


def _limit(num_devices: int, device_count: int | None) -> int:
    count = visible_devices() if device_count is None else device_count
    limit = num_devices if num_devices and num_devices > 0 else count
    return min(limit, count)


def make_mesh(num_devices: int = 0, model_axis: int = 1,
              device_count: int | None = None) -> MeshPlan:
    """A (data, model) plan over the first ``num_devices`` of
    ``device_count`` devices (0 means all; the count defaults to
    :func:`visible_devices`)."""
    n = _limit(num_devices, device_count)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    return MeshPlan(n // model_axis, model_axis)


def make_mesh_for_batch(batch_size: int, num_devices: int = 0,
                        device_count: int | None = None) -> MeshPlan:
    """A data-parallel plan whose data axis divides the global batch: the
    largest device count up to the limit that divides it (the JAX rule;
    devices beyond it stay idle)."""
    limit = _limit(num_devices, device_count)
    n = max(d for d in range(1, limit + 1) if batch_size % d == 0)
    return MeshPlan(n, 1)


def make_mesh_spatial(batch_size: int, num_devices: int = 0, image_h: int = 1024,
                      device_count: int | None = None) -> MeshPlan:
    """A plan that puts the devices the batch leaves idle on the model axis
    (image rows): the largest power of two up to ``limit // data`` that
    divides ``image_h``, as the JAX planner picks it."""
    limit = _limit(num_devices, device_count)
    n_data = max(d for d in range(1, limit + 1) if batch_size % d == 0)
    n_model = limit // n_data
    while n_model > 1 and (image_h % n_model or (n_model & (n_model - 1))):
        n_model -= 1
    return MeshPlan(n_data, n_model)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(plan: MeshPlan, batch, rank: int):
    """Rank ``rank``'s rows of a global batch (a tensor, an array, or a
    dict, list or tuple of them with a common leading batch axis): the
    contiguous block of its data index. The batch must divide by the data
    axis, as the JAX placement requires."""

    def rows(x):
        n = x.shape[0]
        if n % plan.data:
            raise ValueError(f"batch {n} not divisible by the data axis {plan.data}")
        size = n // plan.data
        start = plan.data_index(rank) * size
        return x[start:start + size]

    return _map(rows, batch)


def replicate(tree, group=None):
    """Broadcast every tensor of ``tree`` from rank 0 of ``group`` in place
    (params, optimizer state), so every rank holds rank 0's values; the
    identity outside a process group. Returns ``tree``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return tree
    src = dist.get_global_rank(group, 0) if group is not None else 0

    def bcast(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t.data, src, group=group)
        return t

    return _map(bcast, tree)


def pad_batch_to(batch_size: int, *arrays):
    """Host-side: pad arrays' leading axis up to ``batch_size`` by repeating
    the last element; returns (padded_arrays, real_count)."""
    out = []
    n = arrays[0].shape[0]
    for a in arrays:
        if a.shape[0] < batch_size:
            pad = np.repeat(a[-1:], batch_size - a.shape[0], axis=0)
            a = np.concatenate([a, pad], axis=0)
        out.append(a)
    return out, n
