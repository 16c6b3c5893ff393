"""Deployment export (``adipose_tpu/serving/export.py``): a hermetic program
with fixed input shapes, its parameters and a manifest, as ``torch.export``
programs.

The bundle is a directory::

    <out>/
      model.<device>.pt2   one torch.export.save'd ExportedProgram per device
      params/params.npz    the Flax-layout parameter tree, as every run holds it
      manifest.json        shapes, dtypes, normalization stats, model type

The U-Net program takes raw float32 (batch, tile, tile) gray in 0-255 and
returns (batch, tile, tile) float32 probabilities: kernel A's z-score with the
run's statistics (``adipose::zscore``), the bf16 U-Net, kernel B's head
(``adipose::sigmoid_head``), exactly what ``segment --weights`` computes. The
classifier program takes inception-preprocessed (batch, 299, 299, 3) float32
and returns (batch,) probabilities. The two kernels are custom ops, so the
program holds each as one node and loading it launches the same kernels; the
ops' modules are imported here, so they are registered before a load.

``torch.export`` writes the traced device into the graph, so a program runs
only on the device it was traced for: ``platforms`` names the devices, one
program each. ``tpu``, ``gpu`` and ``cuda`` mean the accelerator ``device``
names (default ``cuda``), ``cpu`` the CPU. Tracing for ``cuda`` needs a GPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.func import functional_call

from adipose_tpu_torch.models.convert import flax_inception_to_torch, flax_unet_to_torch
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.train import checkpoint as ckpt

# The statistics a U-Net bundle bakes in when its run has no
# normalization_stats.json (the JAX package's defaults).
DEFAULT_MEAN, DEFAULT_STD = 200.99, 25.26
ACCELERATOR_PLATFORMS = ("tpu", "gpu", "cuda")


class UNetServing(DilatedUNet):
    """The bf16 U-Net with the z-score in front: (B, T, T) float32 gray in
    0-255 -> (B, T, T) float32 probabilities of the main head."""

    def __init__(self, mean: float, std: float, **kwargs):
        super().__init__(**kwargs)
        self.mean, self.std = float(mean), float(std)

    def forward(self, tiles: torch.Tensor) -> torch.Tensor:
        x, _stats = fused_zscore_normalize(tiles, self.mean, self.std,
                                           out_dtype=self.compute_dtype)
        out = super().forward(x)
        return out["main_out"] if isinstance(out, dict) else out


def program_devices(platforms, device: str | torch.device = "cuda") -> list[torch.device]:
    """The distinct devices a bundle holds programs for, in the order named."""
    devices = []
    for name in platforms:
        if name in ACCELERATOR_PLATFORMS:
            dev = torch.device(device)
        elif name == "cpu":
            dev = torch.device("cpu")
        else:
            raise ValueError(f"unknown platform {name!r}: use cpu or one of "
                             f"{ACCELERATOR_PLATFORMS} (the accelerator --device names)")
        if dev not in devices:
            devices.append(dev)
    return devices


def program_file(device: str | torch.device) -> str:
    return f"model.{torch.device(device).type}.pt2"


def _unet(weights_path: Path, device) -> tuple[torch.nn.Module, dict, dict]:
    """(the serving U-Net on ``device``, its param tree, manifest extras)."""
    ckpt_dir = weights_path.parent
    try:
        mean, std = ckpt.load_normalization_stats(ckpt_dir)
    except FileNotFoundError:
        mean, std = DEFAULT_MEAN, DEFAULT_STD
    mcfg = ckpt.detect_model_config(ckpt_dir)
    model = UNetServing(mean, std, init_nb=mcfg.init_nb,
                        use_deep_supervision=mcfg.use_deep_supervision,
                        dilation_rates=tuple(mcfg.dilation_rates),
                        compute_dtype=torch.bfloat16, device=device)
    tree = ckpt.load_params(weights_path)
    model.load_state_dict(flax_unet_to_torch(tree))
    return model, tree, {"normalization": {"mean": mean, "std": std}}


def _classifier(weights_path: Path, device) -> tuple[torch.nn.Module, dict, dict]:
    model = InceptionV3Classifier(compute_dtype=torch.bfloat16, device=device)
    tree = ckpt.load_params(weights_path)
    model.load_state_dict(flax_inception_to_torch(tree))
    return model, tree, {}


def export_model(
    weights: str | Path,
    model_type: str,
    output: str | Path,
    batch_size: int = 1,
    tile_size: int = 1024,
    platforms: tuple[str, ...] = ("tpu", "cpu"),
    device: str | torch.device = "cuda",
) -> Path:
    """Write the bundle of a run's weights to ``output``; returns ``output``."""
    if model_type == "unet":
        build, shape = _unet, (batch_size, tile_size, tile_size)
        in_desc = {"input": f"float32[{batch_size},{tile_size},{tile_size}] gray 0-255"}
    elif model_type == "classifier":
        build, shape = _classifier, (batch_size, 299, 299, 3)
        in_desc = {"input": f"float32[{batch_size},299,299,3] inception-preprocessed"}
    else:
        raise ValueError(f"unknown model type: {model_type}")
    devices = program_devices(platforms, device)
    for dev in devices:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"export for {dev} needs a CUDA GPU; torch sees none")
    weights_path = ckpt.resolve_weights_path(weights)
    out = Path(output)
    out.mkdir(parents=True, exist_ok=True)
    programs = {}
    for dev in devices:
        model, tree, extra = build(weights_path, dev)
        model.eval()
        example = torch.zeros(shape, dtype=torch.float32, device=dev)
        with torch.no_grad():
            exported = torch.export.export(model, (example,), strict=False)
        exported.example_inputs = None  # else the program file holds a batch of zeros
        programs[dev.type] = program_file(dev)
        torch.export.save(exported, out / programs[dev.type])
        del model, exported
    ckpt.save_params(out, "params", tree)
    manifest = {
        "model_type": model_type,
        "inputs": in_desc,
        "batch_size": batch_size,
        "tile_size": tile_size,
        "format": "torch.export",
        "torch": torch.__version__,
        "platforms": list(platforms),
        "programs": programs,
        **extra,
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


def read_manifest(bundle: str | Path) -> dict:
    return json.loads((Path(bundle) / "manifest.json").read_text())


def load_exported(bundle: str | Path, device: str | torch.device = "cuda"):
    """Load a bundle's program for ``device`` -> ``(call, params, manifest)``:
    ``call(params, x)`` runs the program with ``params`` (a state dict on
    ``device``, the bundle's own as returned) in place of its own, under
    ``torch.inference_mode()``. Raises when the bundle holds no program for
    ``device``."""
    bundle, dev = Path(bundle), torch.device(device)
    manifest = read_manifest(bundle)
    path = bundle / program_file(dev)
    if not path.exists():
        raise FileNotFoundError(
            f"{bundle} holds no program for {dev.type}; it holds "
            f"{sorted(manifest.get('programs', {}))} (export with --platforms naming it)")
    module = torch.export.load(path).module()
    tree = ckpt.load_params(bundle / "params")
    to_torch = flax_unet_to_torch if manifest["model_type"] == "unet" else flax_inception_to_torch
    params = {k: v.to(dev) for k, v in to_torch(tree).items()}

    def call(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return functional_call(module, p, (x,), strict=True)

    return call, params, manifest
