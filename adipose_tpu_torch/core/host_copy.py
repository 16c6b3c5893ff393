"""Host<->device copies of a batch, and the request step that joins them.

Two copies in, both under the ``entry.h2d`` span, counting ``h2d_bytes``:
:func:`copy_in` (pageable) and :func:`copy_in_pinned` (pinned staging, an
asynchronous copy). A pageable copy makes the host wait for the work queued
on the stream; pinning it costs a host copy of the same size. So the pinned
form pays where the host runs ahead of the card (a prefetched stream: the
trainers, classifier evaluation, the cascade), and the pageable one where
it does not (a closed loop of requests: :func:`predict_batch`).

:meth:`HostCopy.start` takes the host block from PyTorch's caching host
allocator and enqueues the copy back without waiting; :meth:`HostCopy.numpy`
waits for it. The array it returns keeps the block alive, so a result the
caller still holds is never written over; once the caller drops it the
allocator caches the block for a later copy of the same size, and a steady
stream of copies pins no new memory. A CPU tensor is returned as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.parallel.mesh import pad_batch_to


def copy_in(batch: np.ndarray, device) -> torch.Tensor:
    """A host batch on ``device`` through a pageable copy."""
    with tracing.span("entry.h2d"):
        host = np.ascontiguousarray(batch)
        tracing.count("h2d_bytes", host.nbytes)
        return torch.from_numpy(host).to(device)


def copy_in_pinned(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device`` without waiting for the stream: pinned
    memory and an asynchronous copy."""
    with tracing.span("entry.h2d"):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        tracing.count("h2d_bytes", t.nbytes)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


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


def predict_batch(predict, params, batch: np.ndarray, batch_size: int, device) -> np.ndarray:
    """One device step over a chunk of n host items: pad it to
    ``batch_size`` by repeating the last, copy it in, ``predict(params,
    tiles)``, and return the n real results. From a card they come back into
    pinned host memory (:class:`HostCopy`), which the returned array holds."""
    (batch,), n = pad_batch_to(batch_size, batch)
    copy = HostCopy.start(predict(params, copy_in(batch, device))[:n])
    out = copy.numpy()
    tracing.count("d2h_bytes", out.nbytes)
    if copy.ready is not None:
        tracing.count("d2h_pinned_bytes", out.nbytes)
    return out
