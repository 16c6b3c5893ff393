"""Loss selection, the Keras Adam/AdamW update, the train state and the
inference function (``adipose_tpu/train/state.py``).

* ``unet_loss_from_config``: the reference's loss matrix {standard | label
  smoothing | OHEM | OHEM + smoothing} x {deep supervision on/off}.
* :class:`KerasAdam`: TF/Keras Adam's exact update form (the JAX package's
  ``scale_by_keras_adam``), and AdamW with the decoupled decay. It holds
  moments only for the params it is given, so the phase-1 frozen encoder is
  the params left out: they get no update and no moments, as the JAX
  package's ``multi_transform`` with ``set_to_zero`` gives them. A fresh
  optimizer per phase, as Keras recompiles.
* :func:`classifier_stats_mask`: which BatchNorm running statistics of the
  classifier may update, from its param mask.
* The learning rate is a host float, set per epoch by the schedules
  (:func:`set_learning_rate`); each update passes it to the device as a
  kernel argument, so no step waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.ops import losses as L


def unet_loss_from_config(cfg) -> Callable:
    """The main/aux loss functions of a TrainConfig
    (``train_adipose_unet_v3.py:795-879``), as one ``loss_fn(y_true,
    outputs)`` that takes a tensor or the deep-supervision dict."""
    if cfg.use_label_smoothing and cfg.use_hard_mining:
        main = partial(L.ohem_loss_with_smoothing, keep_ratio=cfg.ohem_ratio,
                       epsilon_pos=cfg.epsilon_pos, epsilon_neg=cfg.epsilon_neg)
        aux = partial(L.combined_loss_with_label_smoothing, epsilon_pos=cfg.epsilon_pos,
                      epsilon_neg=cfg.epsilon_neg)
    elif cfg.use_label_smoothing:
        main = aux = partial(L.combined_loss_with_label_smoothing,
                             epsilon_pos=cfg.epsilon_pos, epsilon_neg=cfg.epsilon_neg)
    elif cfg.use_hard_mining:
        main = partial(L.ohem_loss, keep_ratio=cfg.ohem_ratio)
        aux = L.combined_loss_standard
    else:
        main = aux = L.combined_loss_standard

    def loss_fn(y_true, outputs):
        if isinstance(outputs, dict):
            return L.deep_supervision_loss(y_true, outputs, main, aux, cfg.ds_weight_main,
                                           cfg.ds_weight_aux1, cfg.ds_weight_aux2)
        return main(y_true, outputs)

    return loss_fn


class KerasAdam:
    """TF/Keras Adam (``optimizer="adam"``) or AdamW (``"adamw"``) over a
    list of float32 params, updated in place under ``no_grad``:

        m <- m + (1 - b1) (g - m);   v <- v + (1 - b2) (g^2 - v)
        u  = alpha m / (sqrt(v) + eps),  alpha = sqrt(1 - b2^t) / (1 - b1^t)
        AdamW: u <- u + weight_decay * p
        p <- p + (-lr) u

    eps (Keras's 1e-7) sits outside the *uncorrected* sqrt(v), which
    ``torch.optim.Adam`` does not do. alpha is computed on the host in
    float32, as the JAX package computes it on the device.
    """

    def __init__(self, params: list[torch.Tensor], lr: float, optimizer: str = "adam",
                 weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        if optimizer.lower() not in ("adam", "adamw"):
            raise ValueError(f"optimizer must be 'adam' or 'adamw', got {optimizer}")
        self.params = list(params)
        self.lr = float(lr)
        self.decoupled = optimizer.lower() == "adamw"
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _alpha(self) -> float:
        t, one = np.float32(self.count), np.float32(1.0)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        return float(np.float32(np.sqrt(one - b2 ** t) / (one - b1 ** t)))

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor | None]) -> None:
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        self.mu = torch._foreach_add(self.mu, torch._foreach_mul(
            torch._foreach_sub(grads, self.mu), 1.0 - self.b1))
        self.nu = torch._foreach_add(self.nu, torch._foreach_mul(
            torch._foreach_sub(torch._foreach_mul(grads, grads), self.nu), 1.0 - self.b2))
        self.count += 1
        updates = torch._foreach_div(torch._foreach_mul(self.mu, self._alpha()),
                                     torch._foreach_add(torch._foreach_sqrt(self.nu), self.eps))
        if self.decoupled:
            updates = torch._foreach_add(updates,
                                         torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(updates, -self.lr))


def set_learning_rate(optimizer: KerasAdam, lr: float) -> KerasAdam:
    """Set the learning rate the next updates use."""
    optimizer.lr = float(lr)
    return optimizer


@dataclass
class TrainState:
    """The live params (a name -> tensor dict, the model's own) and the
    optimizer over the trainable ones."""

    params: dict[str, torch.Tensor]
    optimizer: KerasAdam
    trainable: list[str] = field(default_factory=list)

    @classmethod
    def create(cls, params: dict[str, torch.Tensor], optimizer: str, lr: float,
               weight_decay: float, trainable_mask: dict[str, bool] | None = None):
        names = [k for k in params if trainable_mask is None or trainable_mask[k]]
        for k, p in params.items():
            p.requires_grad_(k in names)
        return cls(params, KerasAdam([params[k] for k in names], lr, optimizer, weight_decay),
                   names)

    def apply_gradients(self, grads: list[torch.Tensor | None]) -> None:
        self.optimizer.step(grads)


def _cbn_prefix(name: str) -> tuple[str, ...]:
    return tuple(s for s in name.split(".") if s.startswith("cbn_") or s == "backbone")


def classifier_stats_mask(stats_names, param_mask: dict[str, bool]) -> dict[str, bool]:
    """The BatchNorm-statistics update mask of the classifier, from its param
    trainability mask: the statistics of a frozen ConvBN keep their values.
    This masks only the update; the inference-mode normalization of a
    frozen ConvBN is the model's ``frozen_below``."""
    trainable: dict[tuple, bool] = {}
    for name, v in param_mask.items():
        key = _cbn_prefix(name)
        trainable[key] = trainable.get(key, False) or bool(v)
    return {name: trainable.get(_cbn_prefix(name), True) for name in stats_names}


def make_unet_predict(model: torch.nn.Module):
    """``predict(params, images)``: the model's main output under
    ``torch.inference_mode()``, with ``params`` (a state dict on the images'
    device) in place of the module's own."""
    model.eval()

    def predict(params: dict[str, torch.Tensor], images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), tracing.span("model.forward", device=True):
            out = functional_call(model, params, (images,), strict=True)
        return out["main_out"] if isinstance(out, dict) else out

    return predict
