"""TF/Keras ``.h5`` / ``.weights.h5`` -> Flax-layout parameter importers
(``adipose_tpu/models/tf_import.py``, function for function).

Parity bridge: load weights trained by the reference's TF scripts (the
U-Net's ``.weights.h5``, the Keras InceptionV3 ImageNet file the
classifier's transfer learning starts from) into the port's models.
Matches the reference loaders' semantics
(``train_adipose_unet_v3.py:881-916`` by-name with skip;
``train_adipose_classifier_v0.py:322-353`` ``by_name=True, skip_mismatch``),
but never silently: every import prints matched/missing counts, a zero-match
import raises, and any shape mismatch raises.

The trees are the Flax-layout numpy trees of
:mod:`adipose_tpu_torch.models.convert`: ``torch_unet_to_flax`` and
``torch_inception_to_flax`` make the init tree from a torch model, and the
inverse functions load the result into one. Nothing here needs JAX or Flax;
``h5py`` is imported only by the functions that read a file.

Two on-disk layouts are handled:

* **legacy HDF5** (``save_weights('x.h5')``, and the keras-applications
  ImageNet files): root attr ``layer_names``; groups keyed by the *custom*
  ``layer.name`` (``down1_conv1/down1_conv1/kernel:0``). Matching is by
  reference layer name; InceptionV3's auto-names (``conv2d_<i>`` /
  ``batch_normalization_<i>``) are creation-ordered, so ordinal position
  (robust to uid offsets) maps directly onto the ``cbn_<i>`` scopes.
* **generic** (``save_weights('x.weights.h5')`` under tf_keras >= 2.16 and
  Keras 3): ``layers/<snake_case_class>[_<k>]/vars/<j>``. Custom layer names
  are not in the file: Keras names groups ``to_snake_case(cls.__name__)``
  plus a counter, walking ``model.layers`` in **topological** order. The
  group -> layer manifests below map them back; they were derived from the
  real reference models (``scripts/gen_tf_manifests.py``).

Keras conv kernels are (kh, kw, cin, cout), the Flax layout of the tree, so
no transpose is needed here; ``convert`` makes the torch layout.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from adipose_tpu_torch.models.convert import flatten_tree, unflatten_tree

# --------------------------------------------------------------------------
# Manifests (derived from the real tf_keras models; see scripts/gen_tf_manifests.py),
# copied from the JAX package
# --------------------------------------------------------------------------

# Reference layer name for generic group ``layers/conv2d[_k]`` — the U-Net is
# a chain so topological == instantiation order (train_adipose_unet_v3.py:
# 660-758). The deep-supervision variant appends aux_out1/aux_out2 BEFORE
# output_softmax.
UNET_GENERIC_CONV_ORDER = (
    "down1_conv1", "down1_conv2", "down2_conv1", "down2_conv2",
    "down3_conv1", "down3_conv2",
    "dilate1", "dilate2", "dilate3", "dilate4", "dilate5", "dilate6",
    "up3_conv1", "up3_conv2", "up3_conv3",
    "up2_conv1", "up2_conv2", "up2_conv3",
    "up1_conv1", "up1_conv2", "up1_conv3",
    "output_softmax",
)
UNET_GENERIC_CONV_ORDER_DS = UNET_GENERIC_CONV_ORDER[:-1] + (
    "aux_out1", "aux_out2", "output_softmax",
)

# Flax ``cbn_<i>`` index for generic group ``layers/conv2d[_k]`` (and the
# identically-permuted ``batch_normalization[_k]``) of the InceptionV3
# classifier. Keras's model.layers order interleaves the inception branches
# by graph depth, so the k-th *saved* conv is NOT the k-th *instantiated*
# conv; this permutation was read off the real tf_keras.applications
# InceptionV3 graph (conv↔BN pairing verified via each BN's producing layer).
INCEPTION_TOPO_PERM = (
    0, 1, 2, 3, 4, 8, 6, 9, 5, 7, 10, 11, 15, 13, 16, 12, 14, 17, 18, 22,
    20, 23, 19, 21, 24, 25, 27, 28, 26, 29, 34, 35, 31, 36, 32, 37, 30, 33,
    38, 39, 44, 45, 41, 46, 42, 47, 40, 43, 48, 49, 54, 55, 51, 56, 52, 57,
    50, 53, 58, 59, 64, 65, 61, 66, 62, 67, 60, 63, 68, 69, 72, 73, 70, 74,
    71, 75, 80, 77, 81, 78, 79, 82, 83, 76, 84, 89, 86, 90, 87, 88, 91, 92,
    85, 93,
)

_UNET_LAYER_RE = re.compile(
    r"(down\d_conv\d|dilate\d|up\d_conv\d|output_softmax|aux_out\d)$"
)


# --------------------------------------------------------------------------
# H5 reading helpers
# --------------------------------------------------------------------------

def _walk_datasets(h5group, prefix=""):
    import h5py

    for key, item in h5group.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(item, h5py.Dataset):
            yield path, item
        else:
            yield from _walk_datasets(item, path)


def load_h5_weight_map(h5_path: str | Path) -> dict:
    """All datasets in the file keyed by full path."""
    import h5py

    out = {}
    with h5py.File(h5_path, "r") as f:
        for path, ds in _walk_datasets(f):
            out[path] = np.asarray(ds)
    return out


_GENERIC_RE = re.compile(r"(^|/)layers/([a-z0-9_]+)/vars/(\d+)$")


def detect_layout(weight_map: dict) -> str:
    """``"generic"`` (tf_keras≥2.16 / Keras-3 ``.weights.h5``) or ``"by_name"``."""
    return "generic" if any(_GENERIC_RE.search(p) for p in weight_map) else "by_name"


def _generic_groups(weight_map: dict, class_base: str) -> list:
    """Ordered ``vars`` arrays for every ``layers/<class_base>[_k]`` group.

    Returns ``groups[k] = [arr_0, arr_1, ...]`` (vars in save order), with k
    the numeric suffix — which encodes model.layers (topological) order.
    """
    groups: dict = {}
    pat = re.compile(rf"(^|/)layers/{re.escape(class_base)}(_(\d+))?/vars/(\d+)$")
    for path, arr in weight_map.items():
        m = pat.search(path)
        if m:
            k = int(m.group(3)) if m.group(3) else 0
            groups.setdefault(k, {})[int(m.group(4))] = arr
    out = []
    for k in sorted(groups):
        out.append([groups[k][j] for j in sorted(groups[k])])
    return out


def _find_layer_arrays(weight_map: dict, layer_name: str) -> list:
    """Datasets belonging to a named layer, in path order.

    Matches any path containing ``/<layer_name>/`` or starting with it —
    covers Keras-2 ``model_weights/<name>/<name>/kernel:0`` and nested
    ``.../<name>/vars/0`` layouts.
    """
    hits = []
    pattern = re.compile(rf"(^|/){re.escape(layer_name)}(/|$)")
    for path in sorted(weight_map):
        if pattern.search(path):
            hits.append((path, weight_map[path]))
    return hits


def _ordinal_named_layers(weight_map: dict, base: str) -> list:
    """Legacy layout: layers named ``<base>``/``<base>_<n>`` sorted by numeric
    suffix → list of array-lists. Robust to uid offsets (e.g. the ImageNet
    applications H5 starts at ``conv2d_1``)."""
    found: dict = {}
    pat = re.compile(rf"(^|/){re.escape(base)}(_(\d+))?(/|$)")
    for path in weight_map:
        m = pat.search(path)
        if m:
            n = int(m.group(3)) if m.group(3) else 0
            found.setdefault(n, []).append((path, weight_map[path]))
    return [sorted(found[n]) for n in sorted(found)]


def _kernel_and_bias(arrays: list):
    """Identify (kernel, bias) among a layer's datasets by rank."""
    kernel = bias = None
    for item in arrays:
        arr = item[1] if isinstance(item, tuple) else item
        if arr.ndim >= 2:
            kernel = arr
        elif arr.ndim == 1:
            bias = arr
    return kernel, bias


def _bn_stats(arrays: list):
    """(beta, moving_mean, moving_variance) from a BN layer's datasets.

    Named datasets (legacy layout) are matched by weight name; positional
    ``vars/<j>`` (generic layout) use Keras's save order for ``scale=False``
    BN: beta, moving_mean, moving_variance. A 4-vector (``scale=True``) file
    is rejected — the reference's ``conv2d_bn`` BNs are all scale-free.
    """
    named = {}
    vecs = []
    for item in arrays:
        if isinstance(item, tuple):
            path, arr = item
        else:
            path, arr = "", item
        if arr.ndim != 1:
            continue
        name = path.rsplit("/", 1)[-1].split(":")[0]
        named[name] = arr
        vecs.append(arr)
    if {"beta", "moving_mean", "moving_variance"} <= named.keys():
        if "gamma" in named:
            raise ValueError("BN with scale=True is not used by the reference models")
        return named["beta"], named["moving_mean"], named["moving_variance"]
    if len(vecs) == 3:
        return vecs[0], vecs[1], vecs[2]
    raise ValueError(f"cannot identify BN stats among {len(vecs)} vectors")


def _assign(new_flat: dict, flat: dict, key: tuple, arr: np.ndarray, what: str):
    cur = flat[key]
    if tuple(arr.shape) != tuple(np.shape(cur)):
        raise ValueError(f"{what}: file shape {tuple(arr.shape)} != flax {tuple(np.shape(cur))}")
    new_flat[key] = arr.astype(np.asarray(cur).dtype)


class ImportReport:
    """Loud accounting of an import: what mapped, what didn't."""

    def __init__(self, layout: str, kind: str):
        self.layout = layout
        self.kind = kind
        self.matched: list = []
        self.missing: list = []   # expected by the flax model, absent in file
        self.skipped: list = []   # present in file, absent in the flax model

    def summary(self) -> str:
        s = (f"[tf-import] {self.kind}: layout={self.layout} "
             f"matched={len(self.matched)} missing={len(self.missing)} "
             f"skipped={len(self.skipped)}")
        if self.missing:
            s += f"\n[tf-import]   missing (kept at init): {self.missing}"
        if self.skipped:
            s += f"\n[tf-import]   in file but not in model: {self.skipped}"
        return s

    def finalize(self, strict: bool, h5_path, verbose: bool):
        if verbose:
            print(self.summary())
        if not self.matched:
            raise ValueError(
                f"no weights matched importing {h5_path} (layout={self.layout}) — "
                f"wrong file/architecture? missing={self.missing[:8]}"
            )
        if strict and self.missing:
            raise KeyError(f"layers not found in {h5_path}: {self.missing}")


# --------------------------------------------------------------------------
# U-Net
# --------------------------------------------------------------------------

def import_unet_weights(h5_path: str | Path, flax_params: dict,
                        strict: bool = False, verbose: bool = True) -> dict:
    """Map a reference U-Net H5 onto a Flax-layout param tree.

    ``flax_params`` is the model's ``{'params': ...}`` numpy tree (or the
    inner dict), e.g. ``torch_unet_to_flax(model.state_dict())``; returns a
    new tree with matched leaves replaced. Unmatched layers
    keep their initialization (``load_pretrained_weights`` by-name-with-skip
    semantics, ``train_adipose_unet_v3.py:881-916``) unless ``strict`` — but
    the match/miss accounting is always printed and a zero-match import
    always raises.
    """
    weight_map = load_h5_weight_map(h5_path)
    layout = detect_layout(weight_map)
    inner = flax_params.get("params", flax_params)
    flat = flatten_tree(inner)

    # flax conv layers by their reference-visible name (scope segment)
    by_layer: dict = {}
    for path in flat:
        for seg in path:
            if _UNET_LAYER_RE.match(seg):
                by_layer.setdefault(seg, []).append(path)

    new_flat = dict(flat)
    report = ImportReport(layout, "unet")

    def assign_layer(layer: str, kernel, bias):
        for path in by_layer[layer]:
            leaf = path[-1]
            if leaf == "kernel" and kernel is not None:
                _assign(new_flat, flat, path, kernel, f"{layer}.kernel")
            elif leaf == "bias" and bias is not None:
                _assign(new_flat, flat, path, bias, f"{layer}.bias")
        report.matched.append(layer)

    if layout == "generic":
        groups = _generic_groups(weight_map, "conv2d")
        orders = {len(UNET_GENERIC_CONV_ORDER): UNET_GENERIC_CONV_ORDER,
                  len(UNET_GENERIC_CONV_ORDER_DS): UNET_GENERIC_CONV_ORDER_DS}
        if len(groups) not in orders:
            raise ValueError(
                f"{h5_path}: {len(groups)} conv layers in file — not a reference "
                f"U-Net (expected {sorted(orders)})"
            )
        order = orders[len(groups)]
        for h5_idx, layer in enumerate(order):
            kernel, bias = _kernel_and_bias(groups[h5_idx])
            if layer in by_layer:
                assign_layer(layer, kernel, bias)
            else:
                report.skipped.append(layer)
        report.missing = [l for l in by_layer if l not in order]
    else:
        for layer in sorted(by_layer):
            arrays = _find_layer_arrays(weight_map, layer)
            if not arrays:
                report.missing.append(layer)
                continue
            kernel, bias = _kernel_and_bias(arrays)
            assign_layer(layer, kernel, bias)

    report.finalize(strict, h5_path, verbose)
    new_inner = unflatten_tree(new_flat)
    if "params" in flax_params:
        out = dict(flax_params)
        out["params"] = new_inner
        return out
    return new_inner


# --------------------------------------------------------------------------
# InceptionV3 classifier
# --------------------------------------------------------------------------

def import_inception_weights(h5_path: str | Path, flax_variables: dict,
                             strict: bool = False, verbose: bool = True) -> dict:
    """Map Keras InceptionV3(-classifier) weights onto the Flax-layout
    variables (``torch_inception_to_flax(model.state_dict())``).

    Handles both the full classifier (backbone + ``adipose_score`` head,
    ``train_adipose_classifier_v0.py:312-353``) and a bare backbone file
    (e.g. the keras-applications ImageNet ``notop`` H5) — a missing head is
    reported and kept at init unless ``strict``. Conv kernels →
    ``backbone/cbn_<i>/conv``; BN beta → params, moving stats →
    ``batch_stats``.
    """
    weight_map = load_h5_weight_map(h5_path)
    layout = detect_layout(weight_map)
    params = flatten_tree(flax_variables["params"])
    stats = flatten_tree(flax_variables.get("batch_stats", {}))
    new_params, new_stats = dict(params), dict(stats)
    report = ImportReport(layout, "inception")

    n_convs = len({p[1] for p in params if p[0] == "backbone" and p[1].startswith("cbn_")})

    def assign_cbn(i: int, conv_arrays, bn_arrays):
        scope = ("backbone", f"cbn_{i}")
        kernel, _ = _kernel_and_bias(conv_arrays)
        if kernel is not None:
            _assign(new_params, params, scope + ("conv", "kernel"), kernel, f"cbn_{i}.kernel")
        beta, mean, var = _bn_stats(bn_arrays)
        _assign(new_params, params, scope + ("bn", "bias"), beta, f"cbn_{i}.bn.bias")
        mkey, vkey = scope + ("bn", "mean"), scope + ("bn", "var")
        if mkey in stats:
            _assign(new_stats, stats, mkey, mean, f"cbn_{i}.bn.mean")
        if vkey in stats:
            _assign(new_stats, stats, vkey, var, f"cbn_{i}.bn.var")
        report.matched.append(f"cbn_{i}")

    if layout == "generic":
        conv_groups = _generic_groups(weight_map, "conv2d")
        bn_groups = _generic_groups(weight_map, "batch_normalization")
        if len(conv_groups) != len(INCEPTION_TOPO_PERM) or len(bn_groups) != len(INCEPTION_TOPO_PERM):
            raise ValueError(
                f"{h5_path}: {len(conv_groups)} convs / {len(bn_groups)} BNs in "
                f"file — not an InceptionV3 (expected {len(INCEPTION_TOPO_PERM)})"
            )
        for k, cbn_idx in enumerate(INCEPTION_TOPO_PERM):
            assign_cbn(cbn_idx, conv_groups[k], bn_groups[k])
        dense_groups = _generic_groups(weight_map, "dense")
        head = dense_groups[0] if dense_groups else None
    else:
        conv_layers = _ordinal_named_layers(weight_map, "conv2d")
        bn_layers = _ordinal_named_layers(weight_map, "batch_normalization")
        if len(conv_layers) != n_convs or len(bn_layers) != n_convs:
            raise ValueError(
                f"{h5_path}: {len(conv_layers)} convs / {len(bn_layers)} BNs in "
                f"file — not an InceptionV3 (expected {n_convs})"
            )
        # legacy auto-names are creation-ordered == our cbn_<i> indices
        for i in range(n_convs):
            assign_cbn(i, conv_layers[i], bn_layers[i])
        head = _find_layer_arrays(weight_map, "adipose_score") or None
        if head is None:
            dense_layers = _ordinal_named_layers(weight_map, "dense")
            head = dense_layers[0] if dense_layers else None

    kkey, bkey = ("adipose_score", "kernel"), ("adipose_score", "bias")
    if head is not None:
        kernel, bias = _kernel_and_bias(head)
        if kernel is not None and kkey in params and tuple(kernel.shape) == tuple(np.shape(params[kkey])):
            _assign(new_params, params, kkey, kernel, "adipose_score.kernel")
            if bias is not None:
                _assign(new_params, params, bkey, bias, "adipose_score.bias")
            report.matched.append("adipose_score")
        else:
            # a Dense of the wrong shape (e.g. ImageNet 1000-way head) — skip
            report.skipped.append("dense(head shape mismatch)")
            if kkey in params:
                report.missing.append("adipose_score")
    elif kkey in params:
        report.missing.append("adipose_score")

    report.finalize(strict, h5_path, verbose)
    out = {"params": unflatten_tree(new_params)}
    if stats:
        out["batch_stats"] = unflatten_tree(new_stats)
    for k, v in flax_variables.items():
        if k not in out:
            out[k] = v
    return out
