"""Device->host copies into pinned memory.

:meth:`HostCopy.start` takes the host block from PyTorch's caching host
allocator and enqueues the copy without waiting; :meth:`HostCopy.numpy`
waits for it. The array it returns keeps the block alive, so a result the
caller still holds is never written over; once the caller drops it the
allocator caches the block for a later copy of the same size, and a steady
stream of copies pins no new memory. A CPU tensor is returned as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class HostCopy:
    """A device->host copy in flight: ``tensor`` is pinned host memory that
    holds the data once ``ready`` (a CUDA event) has completed; on the CPU
    there is nothing to wait for."""

    tensor: torch.Tensor
    ready: torch.cuda.Event | None

    @classmethod
    def start(cls, t: torch.Tensor) -> "HostCopy":
        if t.device.type == "cpu":
            return cls(t, None)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return cls(host, ready)

    def numpy(self) -> np.ndarray:
        if self.ready is not None:
            self.ready.synchronize()
        return self.tensor.numpy()
