"""``adipose-torch pipeline``'s cascade over one slide a request:
``DualModelWSIPipeline.run_many`` built as ``cli/main.py:cmd_pipeline``
builds it (``load_segmenter``, ``load_classifier``, the CLI's defaults),
fed the decoded chunks of a slide; its answer is the chunks' float32
maps on the host, with each tile's routing.

Set-up makes a pool of seeded slides (``bench_h100/slides.py``) and seeded
weights on the card. A random Dense head does not separate two textures
(its logit difference is a random projection of theirs, near zero on some
seeds), so the gate's head is fit as a trained gate's is: on the plain
reference's float32 pooled features of the pool's textured tiles, its
weight the difference of the two textures' mean features scaled so the
means lie at logits -L and +L (``gate_logit``), its bias putting their
midpoint at 0; the backbone keeps its seeded draw. The gate's threshold
is then the middle of the widest gap between consecutive reference
probabilities of the pool's QC-good tiles inside their ``threshold_band``
percentiles. Both models are written as checkpoints under ``TMPDIR`` and
loaded through the port's loaders.

The check runs the plain cascade (``reference/cascade.py``) on the slides
of a seeded sample of the window's requests and compares tile by tile.
"""

from __future__ import annotations

import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from bench_h100 import common, slides, weights, work
from bench_h100.entries.segment import write_checkpoint
from bench_h100.reference import cascade as ref
from bench_h100.reference import exact_float32
from bench_h100.work.kernels import launch_work

QC_MARGIN = 0.1  # no tile's QC number within this share of its threshold


def sub_config(value) -> dict:
    """A model configuration named by the cascade's (or given whole)."""
    if isinstance(value, dict):
        return value
    return common.load_json(common.BENCH_DIR / "configs" / f"{value}.json")


def fit_head(pooled: torch.Tensor, kind: np.ndarray, logit: float):
    """(weight (1, F), bias (1,)) of a Dense head whose logits are -logit
    and +logit at the mean features of the COARSE and FINE tiles."""
    f = pooled.to(torch.float64)
    k = torch.from_numpy(kind).to(f.device)
    mu0, mu1 = f[k == slides.COARSE].mean(0), f[k == slides.FINE].mean(0)
    d = mu1 - mu0
    w = d * (2.0 * logit / d.dot(d))
    b = -w.dot((mu0 + mu1) / 2.0)
    return w[None].to(torch.float32), b.reshape(1).to(torch.float32)


def threshold_between(probs: np.ndarray, band) -> tuple[float, float]:
    """(threshold, margin): the middle of the widest gap between consecutive
    ``probs`` inside their ``band`` percentiles, and half that gap."""
    p = np.sort(np.asarray(probs, dtype=np.float64))
    lo, hi = np.percentile(p, band)
    inside = p[(p >= lo) & (p <= hi)]
    if len(inside) < 2:
        raise ValueError(f"fewer than two probabilities inside the {band} percentiles")
    gaps = np.diff(inside)
    i = int(np.argmax(gaps))
    return float(inside[i] + gaps[i] / 2), float(gaps[i] / 2)


@dataclass
class Routed:
    """One chunk's answer: tiles, their routing and the map."""

    origins: np.ndarray
    good: np.ndarray
    prob: np.ndarray
    map: np.ndarray


class Cascade:
    kind = "requests"

    def __init__(self, spec: dict, seed: int, device):
        from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline, PipelineResult

        if "gate_prob" not in PipelineResult.__dataclass_fields__:
            raise RuntimeError("this program's PipelineResult carries no routing of its tiles "
                               "(positions, is_good, gate_prob): the check cannot compare it")
        from adipose_tpu_torch.models.convert import torch_inception_to_flax
        from adipose_tpu_torch.serving.predict import load_classifier, load_segmenter
        from adipose_tpu_torch.train import checkpoint as ckpt

        self.config, traffic = spec["config"], spec["traffic"]
        cfg = self.config
        self.device = device
        self.gate_cfg, self.seg_cfg = sub_config(cfg["gate"]), sub_config(cfg["segmenter"])
        self.tile, self.overlap = cfg["tile_size"], cfg["overlap"]
        self.qc_args = (cfg["qc"]["white_threshold"], cfg["qc"]["white_ratio"],
                        cfg["qc"]["blur_threshold"])
        self.mean, self.std = traffic["zscore_mean"], traffic["zscore_std"]
        limits = common.load_json(common.BENCH_DIR / "limits" / f"{spec['cell']['name']}.json")
        self.delta = limits["route_flips"]["delta"]

        self.pool = []  # slides, each a chunk of every shape
        for k in range(traffic["pool_slides"]):
            gen = common.generator(seed, f"traffic.{k}", device)
            self.pool.append([slides.chunk(shape, self.tile, gen, self.overlap,
                                           traffic["white_share"], traffic["blurry_share"])
                              for shape in cfg["chunks"]])
        self.per_request = sum(len(c.origins) for c in self.pool[0])
        seg = weights.unet(self.seg_cfg, common.generator(seed, "weights.segmenter", device))
        gate = weights.inception(common.generator(seed, "weights.gate", device))

        # the reference's QC and pooled gate features of every tile
        self.ref_good, pooled = [], []
        with torch.no_grad(), exact_float32():
            for s in self.pool:
                goods, feats = [], []
                for c in s:
                    tiles = ref.cut(torch.from_numpy(c.image).to(device), c.origins, self.tile)
                    verdict = ref.qc(tiles, *self.qc_args)
                    margin = ref.margins(verdict, *self.qc_args[1:])
                    if margin < QC_MARGIN:
                        raise RuntimeError(f"a tile of a {c.image.shape} chunk lies within "
                                           f"{margin:.3f} of a QC threshold")
                    goods.append(verdict["good"].cpu().numpy())
                    feats.append(ref.gate_features(gate, tiles))
                self.ref_good.append(goods)
                pooled.append(feats)
        kinds = np.concatenate([c.kind for s in self.pool for c in s])
        flat = torch.cat([f for feats in pooled for f in feats])
        gate["adipose_score.weight"], gate["adipose_score.bias"] = fit_head(
            flat, kinds, traffic["gate_logit"])
        self.ref_prob = [[ref.gate_head(gate, f).cpu().numpy() for f in feats]
                         for feats in pooled]
        good_probs = np.concatenate([p[g] for ps, gs in zip(self.ref_prob, self.ref_good)
                                     for p, g in zip(ps, gs)])
        self.threshold, self.margin = threshold_between(good_probs, traffic["threshold_band"])
        print(f"cascade: gate threshold {self.threshold!r}, margin {self.margin!r}; "
              f"QC-good tiles {len(good_probs)} of {len(kinds)}", file=sys.stderr)
        self.seg_ref = {k: v.to("cpu", copy=True) for k, v in seg.items()}
        self.gate_ref = {k: v.to("cpu", copy=True) for k, v in gate.items()}

        with tempfile.TemporaryDirectory(prefix="bench-cascade-") as tmp:
            seg_run, gate_run = Path(tmp) / "segmenter", Path(tmp) / "classifier"
            seg_run.mkdir()
            write_checkpoint(seg_run, seg, self.seg_cfg, self.mean, self.std)
            ckpt.save_params(gate_run, "weights_best", torch_inception_to_flax(gate))
            del seg, gate
            seg_predict, seg_params, _, _ = load_segmenter(seg_run, device=device)
            cls_predict, cls_state = load_classifier(gate_run, device=device)
        self.pipe = DualModelWSIPipeline(
            cls_predict, cls_state, seg_predict, seg_params,
            tile_size=self.tile,
            classifier_threshold=self.threshold,
            batch_size=cfg["batch_size"],
            transfer_dtype=cfg["transfer_dtype"],
            device=device,
        )
        pixels = self.tile * self.tile
        b = cfg["batch_size"]
        self.kernel_work = {"A": launch_work("A", b, pixels),
                            "B": launch_work("B", b, self.seg_cfg["init_nb"], pixels),
                            "P": launch_work("P", b, pixels)}
        self.flops_per_tile = None

    @property
    def predict(self):
        """The segmenter's predict, where the faults of ``faults.py`` plant."""
        return self.pipe.segmenter_predict

    @predict.setter
    def predict(self, fn) -> None:
        self.pipe.segmenter_predict = fn

    def request(self, i: int) -> list:
        return self.pipe.run_many([c.image for c in self.pool[i % len(self.pool)]])

    def warm(self) -> None:
        """Two requests, one of each slide; the FLOPs a tile from their
        positive counts."""
        positive = [sum(r.n_positive for r in self.request(i)) for i in range(2)]
        self.flops_per_tile = work.flops(self.config).request_flops(
            self.gate_cfg, self.seg_cfg, self.per_request, np.mean(positive)) / self.per_request

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, s: int, gate_quant: str = "fp32",
                  seg_quant: str = "fp32") -> list[Routed]:
        """The plain cascade's answer for slide ``s``: the gate's float32
        probabilities from set-up, or recomputed in ``gate_quant``."""
        dev = self.device
        gate = {k: v.to(dev) for k, v in self.gate_ref.items()}
        seg = {k: v.to(dev) for k, v in self.seg_ref.items()}
        wmap = ref.weight_map(self.tile, self.config["blend_sigma_factor"], dev)
        out = []
        with torch.no_grad(), exact_float32():
            for c, good, prob in zip(self.pool[s], self.ref_good[s], self.ref_prob[s]):
                x = torch.from_numpy(c.image).to(dev)
                tiles = ref.cut(x, c.origins, self.tile)
                if gate_quant != "fp32":
                    prob = ref.gate_head(gate, ref.gate_features(gate, tiles, gate_quant))
                    prob = prob.cpu().numpy()
                positive = good & (prob >= self.threshold)
                maps = ref.segment(seg, tiles[torch.from_numpy(positive).to(dev)], self.mean,
                                   self.std, self.seg_cfg["dilation_rates"], seg_quant)
                m = ref.blend(x.shape, c.origins, positive, maps, wmap)
                out.append(Routed(c.origins, good, prob, m.cpu().numpy()))
        return out

    def compare(self, got: list[Routed], want: list[Routed]) -> dict[str, float]:
        """``gate_gap_max``: the widest gap of a tile's gate probability;
        ``route_flips``: tiles routed otherwise, by QC, or by the gate where
        the reference's probability lies farther than ``delta`` from the
        threshold; ``prob_gap_max``: the widest gap of a pixel's probability
        outside the tiles routed otherwise."""
        inf = dict.fromkeys(("prob_gap_max", "gate_gap_max", "route_flips"), float("inf"))
        out = dict.fromkeys(inf, 0.0)
        if len(got) != len(want):
            return inf
        t, thr = self.tile, self.threshold
        for g, w in zip(got, want):
            if (g.origins is None or g.origins.shape != w.origins.shape
                    or (g.origins != w.origins).any() or g.map.shape != w.map.shape
                    or not np.isfinite(g.map).all() or not np.isfinite(g.prob).all()):
                return inf
            g_pos, w_pos = g.good & (g.prob >= thr), w.good & (w.prob >= thr)
            qc_flip = g.good != w.good
            gate_flip = ~qc_flip & (g_pos != w_pos)
            far = np.abs(w.prob.astype(np.float64) - thr) > self.delta
            out["route_flips"] += int((qc_flip | (gate_flip & far)).sum())
            out["gate_gap_max"] = max(out["gate_gap_max"],
                                      float(np.abs(g.prob - w.prob).max()))
            keep = np.ones(w.map.shape, dtype=bool)
            for y, x in w.origins[qc_flip | gate_flip].tolist():
                keep[y:y + t, x:x + t] = False
            if keep.any():
                gap = torch.from_numpy(g.map).to(self.device) - torch.from_numpy(w.map).to(
                    self.device)
                out["prob_gap_max"] = max(out["prob_gap_max"], float(
                    gap.abs()[torch.from_numpy(keep).to(self.device)].max()))
        return out

    def check(self, samples: list, control=False) -> dict[str, float]:
        """The numbers of ``compare`` over the sampled requests, each the
        largest. With ``control`` the reference in float8 answers instead
        of the program: both models (True), or ``"gate"`` or
        ``"segmenter"`` alone."""
        self.release()
        if not samples:
            return {}
        quant = {False: ("fp32", "fp32"), True: ("fp8", "fp8"), "gate": ("fp8", "fp32"),
                 "segmenter": ("fp32", "fp8")}[control]
        wants: dict[int, list[Routed]] = {}
        worst: dict[str, float] = {}
        for i, results in samples:
            s = i % len(self.pool)
            if s not in wants:
                wants[s] = self.reference(s)
            if control:
                got = self.reference(s, *quant)
            else:
                got = [Routed(r.positions, r.is_good, r.gate_prob, r.probability_map)
                       for r in results]
            for k, v in self.compare(got, wants[s]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst


def build(spec: dict, seed: int, device) -> Cascade:
    return Cascade(spec, seed, device)
