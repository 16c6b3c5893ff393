"""Carry weights between Flax variable trees and torch state dicts.

The U-Net tree (``{"params": {"_ConvBlock_0": {"down1_conv1": {"kernel":
(3, 3, Cin, Cout), "bias": (Cout,)}}, ..., "output_softmax": {...}}}``) and
the InceptionV3 classifier's (``{"params": {"backbone": {"cbn_<i>":
{"conv": {"kernel"}, "bn": {"bias"}}}, "adipose_score": {...}},
"batch_stats": {"backbone": {"cbn_<i>": {"bn": {"mean", "var"}}}}}``) are
held as numpy arrays, so neither direction needs JAX. Conv kernels map
HWIO <-> OIHW, Dense kernels (in, out) <-> (out, in); names are kept. Both
directions are lossless.

On disk the tree is one ``.npz`` whose keys are the tree paths joined by
``/``; ``scripts/export_flax_params_npz.py`` writes it from an orbax
checkpoint of the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# Flax scopes of the encoder blocks (``_ConvBlock`` modules); every other
# layer sits at the top of the tree.
_BLOCK_SCOPES = {
    "down1_conv1": "_ConvBlock_0", "down1_conv2": "_ConvBlock_0",
    "down2_conv1": "_ConvBlock_1", "down2_conv2": "_ConvBlock_1",
    "down3_conv1": "_ConvBlock_2", "down3_conv2": "_ConvBlock_2",
}


def hwio_to_oihw(kernel: np.ndarray) -> np.ndarray:
    """A Flax/JAX conv kernel (H, W, in, out) as a torch conv weight
    (out, in, H, W); a view."""
    return kernel.transpose(3, 2, 0, 1)


def oihw_to_hwio(weight: np.ndarray) -> np.ndarray:
    """The inverse of :func:`hwio_to_oihw`; a view."""
    return weight.transpose(2, 3, 1, 0)


def flatten_tree(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_tree(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def unflatten_tree(flat: dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def flax_unet_to_torch(params: dict) -> dict[str, torch.Tensor]:
    """Flax U-Net params (with or without the top ``"params"`` level) ->
    a :class:`~adipose_tpu_torch.models.unet.DilatedUNet` state dict."""
    state = {}
    for path, arr in flatten_tree(params).items():
        layer, leaf = path[-2], path[-1]
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            state[f"{layer}.weight"] = torch.from_numpy(np.array(hwio_to_oihw(a), order="C"))
        elif leaf == "bias":
            state[f"{layer}.bias"] = torch.from_numpy(np.array(a))
        else:
            raise ValueError(f"unexpected U-Net param {'/'.join(path)}")
    return state


def torch_unet_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_unet_to_torch`: the JAX module's full
    variables tree ``{"params": ...}`` as numpy."""
    flat = {}
    for key, t in state_dict.items():
        layer, leaf = key.rsplit(".", 1)
        a = t.detach().to("cpu", torch.float32).numpy()
        scope = ("params",) + ((_BLOCK_SCOPES[layer],) if layer in _BLOCK_SCOPES else ())
        if leaf == "weight":
            flat[scope + (layer, "kernel")] = np.array(oihw_to_hwio(a), order="C")
        elif leaf == "bias":
            flat[scope + (layer, "bias")] = np.array(a)
        else:
            raise ValueError(f"unexpected U-Net state dict key {key}")
    return unflatten_tree(flat)


def flax_inception_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Flax classifier variables ``{"params", "batch_stats"}`` -> an
    :class:`~adipose_tpu_torch.models.inception.InceptionV3Classifier`
    state dict (``backbone.cbn_<i>.conv.weight``, ``...bn.{bias,mean,var}``,
    ``adipose_score.{weight,bias}``)."""
    state = {}
    for path, arr in flatten_tree(variables).items():
        if path[0] not in ("params", "batch_stats"):
            raise ValueError(f"unexpected classifier variable {'/'.join(path)}")
        a = np.asarray(arr, dtype=np.float32)
        *scope, leaf = path[1:]
        if leaf == "kernel":
            a = hwio_to_oihw(a) if a.ndim == 4 else a.T
            leaf = "weight"
        state[".".join([*scope, leaf])] = torch.from_numpy(np.array(a, order="C"))
    return state


def torch_inception_to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_inception_to_torch`: the JAX module's
    variables ``{"params", "batch_stats"}`` as numpy."""
    flat = {}
    for key, t in state_dict.items():
        *scope, leaf = key.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            a = oihw_to_hwio(a) if a.ndim == 4 else a.T
            leaf = "kernel"
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        flat[(collection, *scope, leaf)] = np.array(a, order="C")
    return unflatten_tree(flat)


def save_flax_npz(tree: dict, path: str | Path) -> Path:
    """Write a param tree as one ``.npz`` with ``/``-joined keys."""
    path = Path(path)
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in flatten_tree(tree).items()})
    return path


def load_flax_npz(path: str | Path) -> dict:
    """Read a param tree written by :func:`save_flax_npz`."""
    with np.load(path) as z:
        return unflatten_tree({tuple(k.split("/")): z[k] for k in z.files})
