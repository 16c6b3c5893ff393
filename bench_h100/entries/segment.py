"""The ``segment`` subcommand's device step: ``_load_segmenter``'s predict
(kernel A's z-score, the bf16 U-Net, kernel B's head) through
``segment_batch`` at the request's batch, without TTA.

Set-up makes the seeded weights on the card, writes them as a checkpoint
under ``TMPDIR`` (``params.npz``, ``normalization_stats.json`` and
``training_settings.log``, as a training run leaves them) and loads it with
``_load_segmenter``. A request is ``tiles_per_request`` uint8 tiles of the
host pool; its answer is the (n, H, W) float32 probability maps on the host.
The check runs the plain U-Net in float32 on a seeded sample of the
window's requests and compares the maps pixel by pixel.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from bench_h100 import common, tiles, weights, work
from bench_h100.reference import exact_float32
from bench_h100.reference import unet as ref
from bench_h100.work.kernels import launch_work

REF_BLOCK = 4  # tiles a reference forward at a time


def write_checkpoint(run: Path, params: dict, config: dict, mean: float, std: float) -> None:
    from adipose_tpu_torch.models.convert import torch_unet_to_flax
    from adipose_tpu_torch.train import checkpoint as ckpt

    ckpt.save_normalization_stats(run, mean, std)
    rates = ", ".join(str(r) for r in config["dilation_rates"])
    (run / "training_settings.log").write_text(
        f"init_nb: {config['init_nb']}\ntile_size: {config['tile_size']}\n"
        f"dropout_rate: {config['dropout_rate']}\ndilation_rates: ({rates})\n"
        "use_deep_supervision: False\n")
    ckpt.save_params(run, "weights_best_overall", torch_unet_to_flax(params))


class Segment:
    kind = "requests"

    def __init__(self, spec: dict, seed: int, device):
        from adipose_tpu_torch.cli.main import _load_segmenter, segment_batch

        self.config, traffic = spec["config"], spec["traffic"]
        self.device = device
        self.per_request = traffic["tiles_per_request"]
        self.size = traffic["tile_size"]
        self.mean, self.std = traffic["zscore_mean"], traffic["zscore_std"]
        params = weights.unet(self.config, common.generator(seed, "weights", device))
        self.ref_params = {k: v.to("cpu", copy=True) for k, v in params.items()}
        with tempfile.TemporaryDirectory(prefix="bench-segment-") as tmp:
            write_checkpoint(Path(tmp), params, self.config, self.mean, self.std)
            del params
            self.predict, self.params, _, _ = _load_segmenter(tmp, device=device)
        self.segment_batch = segment_batch
        self.pool, _ = tiles.host_pool(traffic["pool_tiles"], self.size,
                                       common.generator(seed, "traffic", device))
        self.flops_per_tile = work.flops(self.config).forward_flops(self.config, self.size)
        pixels = self.size * self.size
        self.kernel_work = {"A": launch_work("A", self.per_request, pixels),
                            "B": launch_work("B", self.per_request, self.config["init_nb"],
                                             pixels)}

    def _rows(self, i: int):
        return tiles.request_rows(i, self.per_request, len(self.pool))

    def request(self, i: int) -> np.ndarray:
        return self.segment_batch(self.predict, self.params, self.pool[self._rows(i)],
                                  self.per_request, self.device)

    def warm(self) -> None:
        for i in range(2):
            self.request(i)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.predict = self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i: int, quant: str = "fp32") -> torch.Tensor:
        """The plain model's maps of request ``i``, on the device."""
        params = {k: v.to(self.device) for k, v in self.ref_params.items()}
        x = torch.from_numpy(np.ascontiguousarray(self.pool[self._rows(i)])).to(self.device)
        with torch.no_grad(), exact_float32():
            return torch.cat([ref.forward(params, ref.zscore(x[j:j + REF_BLOCK], self.mean,
                                                             self.std),
                                          self.config["dilation_rates"], quant=quant)
                              for j in range(0, x.shape[0], REF_BLOCK)])

    def check(self, samples: list, control: bool = False) -> dict[str, float]:
        """``prob_gap_max``: the widest gap of a sampled map's pixel from the
        reference's; ``prob_gap_mean``: the largest mean gap of a sampled
        request. With ``control`` the reference in float8 answers instead."""
        self.release()
        worst, mean_worst = 0.0, 0.0
        for i, answer in samples:
            want = self.reference(i)
            got = self.reference(i, "fp8") if control else torch.from_numpy(answer).to(want)
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                return {"prob_gap_max": float("inf"), "prob_gap_mean": float("inf")}
            gap = (got - want).abs()
            worst = max(worst, float(gap.max()))
            mean_worst = max(mean_worst, float(gap.mean()))
        return {"prob_gap_max": worst, "prob_gap_mean": mean_worst} if samples else {}


def build(spec: dict, seed: int, device) -> Segment:
    return Segment(spec, seed, device)
