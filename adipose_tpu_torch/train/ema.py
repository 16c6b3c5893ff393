"""Exponential moving average of parameters with best-snapshot semantics
(``adipose_tpu/train/ema.py``; ``EMACallback``, ``train_adipose_unet_v3.py:410-505``).

After each epoch: ``ema <- decay * ema + (1 - decay) * params`` (the first
update copies). Phase 1 uses decay 0.999 and never saves; phase 2 uses 0.995
and saves the EMA weights at the best monitored metric, else at the end.
Each update makes new tensors on the params' device, so a snapshot taken by
reference keeps its values.
"""

from __future__ import annotations

import torch


class EmaTracker:
    """Tracks EMA params (a name -> tensor dict) and the best snapshot by a
    monitored metric."""

    def __init__(self, decay: float = 0.995, monitor_mode: str = "max"):
        self.decay = decay
        self.mode = monitor_mode
        self.ema_params: dict[str, torch.Tensor] | None = None
        self.best_metric = None
        self.best_snapshot: dict[str, torch.Tensor] | None = None

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], metric: float | None = None):
        names = list(params)
        current = [params[k].detach() for k in names]
        if self.ema_params is None:
            new = [t.clone() for t in current]
        else:
            ema = [self.ema_params[k] for k in names]
            new = torch._foreach_add(torch._foreach_mul(ema, self.decay), current,
                                     alpha=1.0 - self.decay)
        self.ema_params = dict(zip(names, new))
        if metric is not None:
            better = self.best_metric is None or (
                metric > self.best_metric if self.mode == "max" else metric < self.best_metric)
            if better:
                self.best_metric = metric
                self.best_snapshot = self.ema_params
        return self.ema_params

    @property
    def snapshot(self):
        """Best EMA snapshot if one was recorded, else the current EMA
        (the reference's train-end fallback save, :471-480)."""
        return self.best_snapshot if self.best_snapshot is not None else self.ema_params
