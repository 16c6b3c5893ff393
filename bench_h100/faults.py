"""Faults planted under an entry's timed path, to show that the check that
decides ``correct`` catches them. Each takes a built entry, before it is
warmed up, and breaks the port's function it drives:

  altered      one answer changed where the predict produces it (a request
               entry's fault; a training step has no answer to alter)
  half_batch   half of the batch left out: the predict answers the rest with
               the mean of the first half; a training step takes its loss
               (a mean) over the first half only
  unchanged    the optimizer's update leaves the state as it was (a training
               entry's fault)
"""

from __future__ import annotations

import torch


def altered(entry) -> None:
    if entry.kind == "steps":
        raise ValueError("a training entry has no answer to alter")

    def wrap(predict):
        def broken(params, tiles):
            out = predict(params, tiles).clone()
            out[0] = 1.0 - out[0]
            return out
        return broken

    entry.predict = wrap(entry.predict)


def half_batch(entry) -> None:
    if entry.kind == "steps":
        step = entry.train_step

        def half_step(state, images, masks, generator, mean, std):
            h = max(1, images.shape[0] // 2)
            return step(state, images[:h], masks[:h], generator, mean, std)

        entry.train_step = half_step
        return

    def wrap(predict):
        def broken(params, tiles):
            h = max(1, tiles.shape[0] // 2)
            out = predict(params, tiles[:h])
            rest = out.mean(0, keepdim=True).expand(tiles.shape[0] - h, *out.shape[1:])
            return torch.cat([out, rest])
        return broken

    entry.predict = wrap(entry.predict)


def unchanged(entry) -> None:
    if entry.kind != "steps":
        raise ValueError("a request entry has no state to leave unchanged")
    entry.state.apply_gradients = lambda grads: None


FAULTS = {"altered": altered, "half_batch": half_batch, "unchanged": unchanged}

