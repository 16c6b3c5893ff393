"""U-Net training steps through ``UNetTrainer``'s own pieces, in its loop's
order: ``_to_device`` of the host batch and masks, ``make_augment_step``'s
tier, and ``_make_fused_train_step`` (the percentile kernel, the forward
with dropout and deep supervision, the trainer's loss, the gradients and
the Keras Adam update of ``TrainState``), at the ``train-unet`` defaults
of phase 2 (every parameter trainable) but the batch.

One generator, seeded from the run's seed, draws the augmentation and the
dropout masks of every step, as the trainer's per-epoch generator does.
Set-up builds the one train state and drives it through ``checked_steps``
steps of distinct pool rows, which warm every shape up; the window's steps
continue on that same state. The check follows those first steps with the
plain float32 reference from the same weights, rows and generator seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100 import common, tiles, weights, work
from bench_h100.reference import exact_float32
from bench_h100.reference import train as ref
from bench_h100.work.kernels import launch_work

# Leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: their change is not compared.
MOVED_SHARE = 1e-3


def leaf_gaps(got: dict, want: dict, names) -> dict[str, float]:
    """Each leaf's gap between its two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    norms = {k: float(want[k].norm()) for k in names}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], median) for k in names}


def relative_difference(got: dict, want: dict, names) -> float:
    """``|got - want| / |want|`` over the leaves ``names`` taken as one vector."""
    diff = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in names)
    norm = sum(float(want[k].double().pow(2).sum()) for k in names)
    return (diff / norm) ** 0.5


class TrainUNet:
    kind = "steps"

    def __init__(self, spec: dict, seed: int, device):
        from adipose_tpu_torch.core.config import TrainConfig
        from adipose_tpu_torch.models.unet import DilatedUNet
        from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
        from adipose_tpu_torch.train.trainer_unet import (_make_fused_train_step, _to_device,
                                                           make_augment_step)

        self.config, self.traffic = spec["config"], spec["traffic"]
        tr = self.traffic
        self.device, self.seed = device, seed
        self.per_request = tr["batch"]
        self.size = tr["tile_size"]
        cfg = TrainConfig(batch_size=tr["batch"], optimizer=tr["optimizer"],
                          use_hard_mining=tr["hard_mining"], ohem_ratio=tr["ohem_ratio"],
                          augment_level=tr["augment_level"],
                          normalization_method=tr["normalization_method"],
                          percentile_low=tr["percentile_low"],
                          percentile_high=tr["percentile_high"])
        self.model = DilatedUNet(init_nb=self.config["init_nb"],
                                 dropout_rate=self.config["dropout_rate"],
                                 use_deep_supervision=tr["deep_supervision"],
                                 dilation_rates=tuple(self.config["dilation_rates"]),
                                 compute_dtype=torch.bfloat16, fast_head=tr["fast_head"],
                                 device=device)
        params = weights.unet(self.config, common.generator(seed, "weights", device),
                              deep_supervision=tr["deep_supervision"])
        self.initial = {k: v.to("cpu", copy=True) for k, v in params.items()}
        live = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, v in params.items():
                live[k].copy_(v)
        del params
        self.state = TrainState.create(live, cfg.optimizer, tr["learning_rate"],
                                       cfg.weight_decay, None)
        self.train_step = _make_fused_train_step(self.model, unet_loss_from_config(cfg),
                                                 cfg.normalization_method, cfg.percentile_low,
                                                 cfg.percentile_high)
        self.augment_step = make_augment_step(cfg.augment_level)
        self.to_device = _to_device
        self.gen = common.generator(seed, "steps", device)
        self.mean = torch.tensor(0.0, device=device)  # unused by the percentile method
        self.std = torch.tensor(1.0, device=device)
        self.images, self.masks = tiles.host_pool(tr["pool_tiles"], self.size,
                                                  common.generator(seed, "traffic", device),
                                                  blobs=tuple(tr["blobs_per_tile"]))
        self.flops_per_step = 3.0 * self.per_request * work.flops(self.config).forward_flops(
            self.config, self.size, tr["deep_supervision"])
        pixels = self.size * self.size
        self.kernel_work = {"D": launch_work("D", self.per_request, pixels),
                            "P": launch_work("P", self.per_request, pixels, 4)}
        self.metrics, self.events, self.index = [], [], 0

    def _rows(self, i: int):
        return tiles.request_rows(i, self.per_request, len(self.images))

    def step(self) -> None:
        rows = self._rows(self.index)
        start = torch.cuda.Event(enable_timing=True) if self.device.type == "cuda" else None
        end = torch.cuda.Event(enable_timing=True) if start is not None else None
        if start is not None:
            start.record()
        images, masks = self.augment_step(self.gen, self.to_device(self.images[rows], self.device),
                                          self.to_device(self.masks[rows], self.device))
        if end is not None:
            end.record()
            self.events.append((start, end))
        self.metrics.append(self.train_step(self.state, images, masks, self.gen, self.mean,
                                            self.std))
        self.index += 1

    def warm(self) -> None:
        """The checked steps: the first gradient as the optimizer holds it
        after step 1 (m = (1 - b1) g), the parameters after the last."""
        for i in range(self.traffic["checked_steps"]):
            self.step()
            if i == 0:
                b1 = self.state.optimizer.b1
                self.first_grads = {k: (m / (1.0 - b1)).cpu() for k, m in
                                    zip(self.state.trainable, self.state.optimizer.mu)}
        self.after = {k: v.detach().to("cpu", copy=True) for k, v in self.state.params.items()}
        self.checked_losses = [float(m["loss"]) for m in self.metrics]

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed_steps(self) -> int:
        losses = torch.stack([m["loss"] for m in self.metrics])
        return int((~torch.isfinite(losses)).sum())

    def augment_ms(self, steps: int) -> list[float]:
        return [s.elapsed_time(e) for s, e in self.events[-steps:]] if steps else []

    def release(self) -> None:
        self.model = self.state = self.train_step = self.augment_step = None
        self.metrics = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: str = "fp32") -> dict:
        """The reference over the checked steps: losses, the first step's
        gradients and the parameters after the last step."""
        params = {k: v.to(self.device, copy=True) for k, v in self.initial.items()}
        opt = ref.KerasAdam(params, self.traffic["learning_rate"])
        gen = common.generator(self.seed, "steps", self.device)
        losses = []
        with exact_float32():
            for i in range(self.traffic["checked_steps"]):
                rows = self._rows(i)
                x = torch.from_numpy(np.ascontiguousarray(self.images[rows])).to(self.device)
                m = torch.from_numpy(np.ascontiguousarray(self.masks[rows])).to(self.device)
                loss, grads = ref.step(params, opt, gen, x, m, self.config, self.traffic, quant)
                losses.append(loss)
                if i == 0:
                    first = {k: g.cpu() for k, g in grads.items()}
                del grads
        return {"losses": losses, "first_grads": first,
                "after": {k: v.cpu() for k, v in params.items()}}

    def check(self, samples: list, control: bool = False) -> dict[str, float]:
        """``loss_gap``: the widest relative gap of a checked step's loss;
        ``grad_gap``: of the first step's gradient norms, by the worst leaf
        (``grad_gap_median``: by the median leaf); ``change_gap``: of the
        norms of the parameters' change over the checked steps, by the worst
        leaf that the reference's gradient moves (``change_gap_median``: by
        the median one).
        With ``control`` the reference in float8 stands in for the program."""
        self.release()
        want = self.reference()
        got = (self.reference("fp8") if control else
               {"losses": self.checked_losses, "first_grads": self.first_grads,
                "after": self.after})
        if not all(math.isfinite(v) for v in got["losses"]):
            return dict.fromkeys(("grad_diff", "change_diff", "loss_gap", "grad_gap",
                                  "change_gap"), math.inf)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        names = list(want["first_grads"])
        grads = leaf_gaps(got["first_grads"], want["first_grads"], names)
        norms = {k: float(want["first_grads"][k].norm()) for k in names}
        median = float(np.median(list(norms.values())))
        moved = [k for k in names if norms[k] >= MOVED_SHARE * median]
        change = {side: {k: d["after"][k] - self.initial[k] for k in moved}
                  for side, d in (("got", got), ("want", want))}
        return {"grad_diff": relative_difference(got["first_grads"], want["first_grads"], names),
                "change_diff": relative_difference(change["got"], change["want"], moved),
                "loss_gap": loss_gap, "grad_gap": max(grads.values()),
                "change_gap": max(leaf_gaps(change["got"], change["want"], moved).values())}


def build(spec: dict, seed: int, device) -> TrainUNet:
    return TrainUNet(spec, seed, device)
