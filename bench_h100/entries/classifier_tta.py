"""``eval-classifier``'s predict at its defaults: full D4 TTA (8 views a
tile, one D4 launch), the percentile stretch (1, 99) through kernel P, the
antialiased resize to 299^2 and the bf16 InceptionV3, the views' logits
averaged. That is ``make_classifier_tta_predict(_make_val_step(...),
"full")``, called once a batch as ``_predict_dataset`` calls it: the uint8
batch goes through ``_to_device`` (pinned, asynchronous) and the (B,)
probabilities are copied back every request.

Weights are made on the card from the seed and handed to the predict as
its state dict, as ``_load_classifier`` hands it the one it read. The check
runs the plain InceptionV3 in float32 over the same views of a seeded
sample of the window's requests and compares logits.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import common, tiles, weights, work
from bench_h100.reference import exact_float32
from bench_h100.reference import inception as ref
from bench_h100.work.kernels import launch_work

REF_BLOCK = 64  # views a reference forward at a time
MODE_VIEWS = {"basic": (0, 1, 2, 3), "full": (0, 1, 2, 3, 4, 5, 6, 7)}


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.to(torch.float64).clamp(1e-7, 1 - 1e-7)
    return torch.log(p / (1 - p))


class ClassifierTTA:
    kind = "requests"

    def __init__(self, spec: dict, seed: int, device):
        from adipose_tpu_torch.eval.classifier_eval import make_classifier_tta_predict
        from adipose_tpu_torch.models.inception import InceptionV3Classifier
        from adipose_tpu_torch.train.trainer_classifier import _make_val_step
        from adipose_tpu_torch.train.trainer_unet import _to_device

        self.config, traffic = spec["config"], spec["traffic"]
        self.device = device
        self.per_request = traffic["tiles_per_request"]
        self.size = traffic["tile_size"]
        self.p_low, self.p_high = traffic["percentile_low"], traffic["percentile_high"]
        self.views = MODE_VIEWS[traffic["tta_mode"]]
        self.state = weights.inception(common.generator(seed, "weights", device))
        self.ref_params = {k: v.to("cpu", copy=True) for k, v in self.state.items()}
        model = InceptionV3Classifier(compute_dtype=torch.bfloat16, device="meta")
        self.predict = make_classifier_tta_predict(
            _make_val_step(model, True, self.p_low, self.p_high), traffic["tta_mode"])
        self.to_device = _to_device
        self.pool, _ = tiles.host_pool(traffic["pool_tiles"], self.size,
                                       common.generator(seed, "traffic", device),
                                       traffic["dim_not_adipose"])
        self.flops_per_tile = len(self.views) * work.flops(self.config).forward_flops(self.config)
        views, pixels = len(self.views) * self.per_request, self.size * self.size
        self.kernel_work = {"D": launch_work("D", views, pixels),
                            "P": launch_work("P", views, pixels, 4)}

    def _rows(self, i: int):
        return tiles.request_rows(i, self.per_request, len(self.pool))

    def request(self, i: int) -> np.ndarray:
        x = self.to_device(self.pool[self._rows(i)], self.device)
        return self.predict(self.state, x).cpu().numpy()

    def warm(self) -> None:
        for i in range(2):
            self.request(i)

    def release(self) -> None:
        self.state = self.predict = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i: int, quant: str = "fp32") -> torch.Tensor:
        params = {k: v.to(self.device) for k, v in self.ref_params.items()}
        x = torch.from_numpy(np.ascontiguousarray(self.pool[self._rows(i)])).to(self.device)
        with torch.no_grad(), exact_float32():
            return ref.tta_probabilities(params, x, self.views, self.p_low, self.p_high, quant,
                                         REF_BLOCK)

    def check(self, samples: list, control: bool = False) -> dict[str, float]:
        """Numbers of the sampled tiles' TTA logits (probabilities clipped
        to [1e-7, 1 - 1e-7]) against the reference's: ``logit_gap_max``, the
        widest gap; ``logit_gap_mean``, the mean gap; ``logit_gap_centered``,
        the mean gap once the sample's mean gap is taken out (the part of
        the error that differs from tile to tile). With ``control`` the
        reference in float8 answers instead of the program."""
        self.release()
        gaps = []
        for i, answer in samples:
            want = self.reference(i)
            got = self.reference(i, "fp8") if control else torch.from_numpy(answer).to(want)
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                return dict.fromkeys(("logit_gap_max", "logit_gap_mean", "logit_gap_centered"),
                                     float("inf"))
            gaps.append(logit(got) - logit(want))
        if not gaps:
            return {}
        d = torch.cat(gaps)
        return {"logit_gap_max": float(d.abs().max()), "logit_gap_mean": float(d.abs().mean()),
                "logit_gap_centered": float((d - d.mean()).abs().mean())}


def build(spec: dict, seed: int, device) -> ClassifierTTA:
    return ClassifierTTA(spec, seed, device)
