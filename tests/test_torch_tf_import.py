"""The port's TF ``.h5`` importers against the JAX package's, on the CPU.

Each case writes one seeded H5 file with h5py and runs it through both
importers: the JAX one onto numpy zeros shaped by ``jax.eval_shape`` of the
Flax init, the port's onto the tree of a seeded torch model. Every matched
leaf is bit-equal on both sides (and to the file), every other leaf keeps
its side's init, the matched/missing/skipped lists and the printed summary
are equal, and a bad file raises the same error on both. Then the
``import-weights`` CLI and the two trainers' ``--pretrained-weights`` path.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adipose_tpu.models.tf_import as jax_tf
import adipose_tpu_torch.models.tf_import as port_tf
from adipose_tpu.models.inception import InceptionV3Classifier as JaxInception
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.train.trainer_classifier import ClassifierTrainer as JaxClassifierTrainer
from adipose_tpu.train.trainer_unet import UNetTrainer as JaxUNetTrainer
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.models.convert import (flatten_tree, flax_inception_to_torch,
                                              flax_unet_to_torch, torch_inception_to_flax,
                                              torch_unet_to_flax)
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.trainer_classifier import ClassifierTrainer
from adipose_tpu_torch.train.trainer_unet import UNetTrainer

INIT_NB = 4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _zeros(init, *example) -> dict:
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *example)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def unet_trees():
    """ds -> (JAX zeros tree, the port's seeded init tree), init_nb 4."""
    trees = {}
    for ds in (False, True):
        jax_tree = _zeros(JaxUNet(init_nb=INIT_NB, compute_dtype=jnp.float32,
                                  use_deep_supervision=ds).init, jnp.zeros((1, 32, 32)))
        model = DilatedUNet(init_nb=INIT_NB, use_deep_supervision=ds)
        model.init_params(torch.Generator().manual_seed(7))
        trees[ds] = jax_tree, torch_unet_to_flax(model.state_dict())
    return trees


@pytest.fixture(scope="module")
def inception_trees():
    """(JAX zeros tree, the port's seeded Flax-style init tree)."""
    jax_tree = _zeros(JaxInception(dtype=jnp.float32).init, jnp.zeros((1, 75, 75, 3)))
    model = InceptionV3Classifier(compute_dtype=torch.float32)
    model.init_flax(torch.Generator().manual_seed(8))
    return jax_tree, torch_inception_to_flax(model.state_dict())


def _unet_layers(tree: dict) -> dict:
    """reference layer name -> {"kernel": path, "bias": path} in the tree."""
    layers = {}
    for path in flatten_tree(tree):
        layer = next(s for s in path[1:] if not s.startswith("_"))
        layers.setdefault(layer, {})[path[-1]] = path
    return layers


def _draw_unet(tree: dict, seed: int) -> dict:
    """layer -> (kernel, bias) seeded arrays of the tree's shapes."""
    flat, rs = flatten_tree(tree), np.random.RandomState(seed)
    return {layer: tuple(rs.randn(*flat[parts[leaf]].shape).astype(np.float32)
                         for leaf in ("kernel", "bias"))
            for layer, parts in _unet_layers(tree).items()}


def write_unet_h5(path, arrays: dict, layout: str, order=None):
    """``legacy``: model_weights/<l>/<l>/{kernel,bias}:0; ``nested``: the
    Keras-3 container layout _layer_checkpoint_dependencies/<l>/vars/{0,1};
    ``generic``: layers/conv2d[_k]/vars/{0,1}, k the place in ``order``."""
    with h5py.File(path, "w") as f:
        if layout == "generic":
            for k, layer in enumerate(order):
                g = f.require_group(f"layers/{'conv2d' if k == 0 else f'conv2d_{k}'}/vars")
                for j, arr in enumerate(arrays[layer]):
                    g.create_dataset(str(j), data=arr)
            return path
        for layer, (kernel, bias) in arrays.items():
            if layout == "legacy":
                g = f.require_group(f"model_weights/{layer}/{layer}")
                g.create_dataset("kernel:0", data=kernel)
                g.create_dataset("bias:0", data=bias)
            else:
                g = f.require_group(f"_layer_checkpoint_dependencies/{layer}/vars")
                g.create_dataset("0", data=kernel)
                g.create_dataset("1", data=bias)
    return path


@pytest.fixture
def reports(monkeypatch):
    """Each side's ImportReport lists, recorded at finalize."""
    seen = {"jax": [], "port": []}
    for side, module in (("jax", jax_tf), ("port", port_tf)):
        def finalize(self, strict, h5_path, verbose, _orig=module.ImportReport.finalize,
                     _side=side):
            seen[_side].append((self.layout, self.kind, list(self.matched),
                                list(self.missing), list(self.skipped)))
            return _orig(self, strict, h5_path, verbose)
        monkeypatch.setattr(module.ImportReport, "finalize", finalize)
    return seen


def _both(fn_name: str, h5, jax_tree, port_tree, capsys, reports):
    want = getattr(jax_tf, fn_name)(h5, jax_tree)
    jax_out = capsys.readouterr().out
    got = getattr(port_tf, fn_name)(h5, port_tree)
    assert capsys.readouterr().out == jax_out and jax_out.startswith("[tf-import]")
    assert reports["port"] == reports["jax"] and len(reports["port"]) == 1
    return want, got, reports["port"][0]


def _assert_leaves(want, got, port_init, matched_paths):
    """Matched leaves bit-equal across the sides; the rest keep the port's
    init (and the JAX side's zeros)."""
    want, got, init = flatten_tree(want), flatten_tree(got), flatten_tree(port_init)
    assert set(got) == set(want) == set(init)
    assert matched_paths and matched_paths <= set(got)
    for path in got:
        assert got[path].dtype == np.float32, path
        if path in matched_paths:
            assert np.array_equal(got[path], np.asarray(want[path])), path
        else:
            assert np.array_equal(got[path], init[path]), path
            assert not np.asarray(want[path]).any(), path


UNET_CASES = {  # name: (file layout, file's DS order, model DS, skipped, missing)
    "legacy": ("legacy", None, False, [], []),
    "keras3_nested": ("nested", None, False, [], []),
    "generic": ("generic", False, False, [], []),
    "generic_ds": ("generic", True, True, [], []),
    "generic_into_ds_model": ("generic", False, True, [], ["aux_out1", "aux_out2"]),
    "generic_ds_into_plain_model": ("generic", True, False, ["aux_out1", "aux_out2"], []),
}


@pytest.mark.parametrize("name", sorted(UNET_CASES))
def test_unet_import_matches_jax(name, unet_trees, tmp_path, capsys, reports):
    layout, file_ds, model_ds, skipped, missing = UNET_CASES[name]
    jax_tree, port_tree = unet_trees[model_ds]
    order = None
    if layout == "generic":
        order = port_tf.UNET_GENERIC_CONV_ORDER_DS if file_ds else port_tf.UNET_GENERIC_CONV_ORDER
        assert order == (jax_tf.UNET_GENERIC_CONV_ORDER_DS if file_ds
                         else jax_tf.UNET_GENERIC_CONV_ORDER)
    arrays = _draw_unet(unet_trees[bool(file_ds)][1], 11)
    h5 = write_unet_h5(tmp_path / "unet.weights.h5", arrays, layout, order)
    want, got, report = _both("import_unet_weights", h5, jax_tree, port_tree, capsys, reports)
    assert report[0] == ("generic" if layout == "generic" else "by_name")
    assert (report[3], report[4]) == (missing, skipped)
    layers = _unet_layers(port_tree)
    assert sorted(report[2]) == sorted(set(layers) - set(missing))
    matched = {layers[layer][leaf] for layer in report[2] for leaf in ("kernel", "bias")}
    _assert_leaves(want, got, port_tree, matched)
    flat = flatten_tree(got)
    for layer in report[2]:
        for i, leaf in enumerate(("kernel", "bias")):
            assert np.array_equal(flat[layers[layer][leaf]], arrays[layer][i])


@pytest.fixture(scope="module")
def inception_arrays(inception_trees):
    """cbn index -> (kernel, beta, mean, var), and the head, seeded."""
    flat, rs = flatten_tree(inception_trees[1]), np.random.RandomState(1)
    convs = {}
    for i in range(len(port_tf.INCEPTION_TOPO_PERM)):
        shape = flat[("params", "backbone", f"cbn_{i}", "conv", "kernel")].shape
        c = shape[-1]
        convs[i] = (rs.randn(*shape).astype(np.float32), rs.randn(c).astype(np.float32),
                    rs.randn(c).astype(np.float32), (rs.rand(c) + 0.5).astype(np.float32))
    head = (rs.randn(2048, 1).astype(np.float32), rs.randn(1).astype(np.float32))
    return convs, head


def write_inception_h5(path, convs: dict, layout: str, head=None, gamma_at=None):
    """``keras2``: the legacy by-name layout, conv2d_<i> in creation order;
    ``generic``: layers/<class>_<k>/vars, group k holding creation index
    INCEPTION_TOPO_PERM[k]. ``head`` is (kernel, bias) of a Dense, written as
    ``adipose_score`` (keras2, when it is 1-way) or ``dense``."""
    def put(f, name, datasets):
        if layout == "keras2":
            g = f.require_group(f"model_weights/{name}/{name}")
            for key, arr in datasets:
                g.create_dataset(key, data=arr)
        else:
            g = f.require_group(f"layers/{name}/vars")
            for j, (_, arr) in enumerate(datasets):
                g.create_dataset(str(j), data=arr)

    with h5py.File(path, "w") as f:
        for slot in range(len(convs)):
            i = slot if layout == "keras2" else port_tf.INCEPTION_TOPO_PERM[slot]
            kernel, beta, mean, var = convs[i]
            suffix = "" if slot == 0 else f"_{slot}"
            put(f, f"conv2d{suffix}", [("kernel:0", kernel)])
            bn = [("beta:0", beta), ("moving_mean:0", mean), ("moving_variance:0", var)]
            if slot == gamma_at:
                bn.insert(0, ("gamma:0", np.ones_like(beta)))
            put(f, f"batch_normalization{suffix}", bn)
        if head is not None:
            name = "adipose_score" if layout == "keras2" and head[0].shape[1] == 1 else "dense"
            put(f, name, [("kernel:0", head[0]), ("bias:0", head[1])])
    return path


INCEPTION_CASES = {  # name: (layout, head, skipped, missing)
    "keras2_head": ("keras2", "adipose", [], []),
    "generic_head": ("generic", "adipose", [], []),
    "keras2_imagenet_head": ("keras2", "imagenet", ["dense(head shape mismatch)"],
                             ["adipose_score"]),
    "generic_no_head": ("generic", None, [], ["adipose_score"]),
}


@pytest.mark.parametrize("name", sorted(INCEPTION_CASES))
def test_inception_import_matches_jax(name, inception_trees, inception_arrays, tmp_path,
                                      capsys, reports):
    layout, head_kind, skipped, missing = INCEPTION_CASES[name]
    convs, head = inception_arrays
    if head_kind == "imagenet":
        rs = np.random.RandomState(2)
        head = (rs.randn(2048, 1000).astype(np.float32), rs.randn(1000).astype(np.float32))
    h5 = write_inception_h5(tmp_path / "inception.h5", convs, layout,
                            head if head_kind else None)
    jax_tree, port_tree = inception_trees
    want, got, report = _both("import_inception_weights", h5, jax_tree, port_tree, capsys,
                              reports)
    n = len(convs)
    assert report[0] == ("generic" if layout == "generic" else "by_name")
    assert (report[3], report[4]) == (missing, skipped)
    has_head = head_kind == "adipose"
    assert sorted(report[2]) == sorted([f"cbn_{i}" for i in range(n)]
                                       + ["adipose_score"] * has_head)
    matched = set()
    for i, (kernel, beta, mean, var) in convs.items():
        scope = ("backbone", f"cbn_{i}")
        for coll, leaf, arr in (("params", ("conv", "kernel"), kernel),
                                ("params", ("bn", "bias"), beta),
                                ("batch_stats", ("bn", "mean"), mean),
                                ("batch_stats", ("bn", "var"), var)):
            path = (coll, *scope, *leaf)
            matched.add(path)
            assert np.array_equal(flatten_tree(got)[path], arr), path
    if has_head:
        matched |= {("params", "adipose_score", "kernel"), ("params", "adipose_score", "bias")}
    _assert_leaves(want, got, port_tree, matched)


def _raises_alike(fn_name: str, h5, jax_tree, port_tree, error, **kw):
    with pytest.raises(error) as want:
        getattr(jax_tf, fn_name)(h5, jax_tree, **kw)
    with pytest.raises(error) as got:
        getattr(port_tf, fn_name)(h5, port_tree, **kw)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_unet_errors_match_jax(unet_trees, tmp_path):
    """Shape mismatch, zero match and a wrong conv count raise ValueError;
    a missing layer under ``strict`` raises KeyError; the same messages."""
    jax_tree, port_tree = unet_trees[False]
    bad = tmp_path / "bad.h5"
    with h5py.File(bad, "w") as f:
        f.create_group("model_weights/dilate1/dilate1").create_dataset(
            "kernel:0", data=np.zeros((3, 3, 7, 7), np.float32))
    assert "dilate1.kernel: file shape (3, 3, 7, 7)" in _raises_alike(
        "import_unet_weights", bad, jax_tree, port_tree, ValueError)
    none = tmp_path / "none.h5"
    with h5py.File(none, "w") as f:
        f.create_group("model_weights/other/other").create_dataset(
            "kernel:0", data=np.zeros((3, 3, 1, 1), np.float32))
    assert "no weights matched" in _raises_alike(
        "import_unet_weights", none, jax_tree, port_tree, ValueError, verbose=False)
    arrays = _draw_unet(port_tree, 12)
    five = write_unet_h5(tmp_path / "five.weights.h5", arrays, "generic",
                         port_tf.UNET_GENERIC_CONV_ORDER[:5])
    assert "5 conv layers in file" in _raises_alike(
        "import_unet_weights", five, jax_tree, port_tree, ValueError)
    plain = write_unet_h5(tmp_path / "plain.weights.h5", arrays, "generic",
                          port_tf.UNET_GENERIC_CONV_ORDER)
    jax_ds, port_ds = unet_trees[True]
    assert "aux_out1" in _raises_alike("import_unet_weights", plain, jax_ds, port_ds, KeyError,
                                       strict=True, verbose=False)


def test_inception_errors_match_jax(inception_trees, inception_arrays, tmp_path):
    """A BN with gamma and a wrong conv count raise ValueError alike."""
    jax_tree, port_tree = inception_trees
    convs, head = inception_arrays
    gamma = write_inception_h5(tmp_path / "gamma.h5", convs, "keras2", head, gamma_at=3)
    assert "scale=True" in _raises_alike("import_inception_weights", gamma, jax_tree,
                                         port_tree, ValueError)
    few = write_inception_h5(tmp_path / "few.weights.h5", dict(list(convs.items())[:93]),
                             "generic")
    assert "93 convs / 93 BNs in file" in _raises_alike(
        "import_inception_weights", few, jax_tree, port_tree, ValueError)


def test_import_weights_cli_feeds_segment(tmp_path, capsys):
    """``import-weights`` of a full-width legacy U-Net file writes
    ``<output>/params.npz`` holding the file's arrays, and ``segment
    --weights`` serves the run it lands in."""
    import cv2

    model = DilatedUNet()  # the CLI's full-width architecture
    tree = torch_unet_to_flax({k: torch.zeros(v.shape) for k, v in model.state_dict().items()})
    arrays = _draw_unet(tree, 13)
    h5 = write_unet_h5(tmp_path / "unet.h5", arrays, "legacy")
    run = tmp_path / "run"
    out = run / "weights_best_overall"
    torch_main(["import-weights", "--h5", str(h5), "--output", str(out)])
    printed = capsys.readouterr().out
    assert f"imported {h5} → {out}" in printed and "matched=22 missing=0" in printed
    flat, layers = flatten_tree(ckpt.load_params(out)), _unet_layers(tree)
    for layer, (kernel, bias) in arrays.items():
        assert np.array_equal(flat[layers[layer]["kernel"]], kernel)
        assert np.array_equal(flat[layers[layer]["bias"]], bias)
    ckpt.save_normalization_stats(run, 127.0, 60.0)
    (run / "training_settings.log").write_text("init_nb: 44\n")
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    cv2.imwrite(str(tiles / "t0.png"), np.full((32, 32), 120, np.uint8))
    torch_main(["segment", "--weights", str(run), "--input-dir", str(tiles), "--output-dir",
                str(tmp_path / "seg"), "--batch-size", "1", "--device", "cpu"])
    assert (tmp_path / "seg" / "masks" / "t0_mask.tif").exists()


def test_unet_trainer_pretrained_h5(unet_trees, tmp_path, capsys):
    """The U-Net trainer's ``.h5`` path: the file's arrays by name, the rest
    kept; a file the importer cannot map prints JAX's line and keeps the
    init."""
    _, port_tree = unet_trees[False]
    params = flax_unet_to_torch(port_tree)
    arrays = _draw_unet(port_tree, 14)
    h5 = write_unet_h5(tmp_path / "unet.weights.h5", arrays, "generic",
                       port_tf.UNET_GENERIC_CONV_ORDER)
    out = UNetTrainer.load_pretrained(None, params, h5)
    assert set(out) == set(params)
    for layer, (kernel, bias) in arrays.items():
        assert torch.equal(out[f"{layer}.weight"], torch.from_numpy(kernel).permute(3, 2, 0, 1))
        assert torch.equal(out[f"{layer}.bias"], torch.from_numpy(bias))
    capsys.readouterr()
    bad = write_unet_h5(tmp_path / "five.weights.h5", arrays, "generic",
                        port_tf.UNET_GENERIC_CONV_ORDER[:5])
    assert UNetTrainer.load_pretrained(None, params, bad) is params
    got = capsys.readouterr().out
    assert JaxUNetTrainer.load_pretrained(None, unet_trees[False][0], bad) is unet_trees[False][0]
    want = capsys.readouterr().out
    assert got == want and got.startswith("[pretrained] TF import fell back to by-name merge:")


def test_classifier_trainer_pretrained_h5(inception_trees, inception_arrays, tmp_path, capsys):
    """The classifier trainer's ``.h5`` path: backbone, statistics and head
    from the file; a file the importer cannot map prints JAX's "TF import
    skipped" line and keeps the init."""
    jax_tree, port_tree = inception_trees
    convs, head = inception_arrays
    variables = flax_inception_to_torch(port_tree)
    h5 = write_inception_h5(tmp_path / "inception.weights.h5", convs, "generic", head)
    out = ClassifierTrainer._load_pretrained(variables, h5)
    assert set(out) == set(variables)
    kernel, beta, mean, var = convs[5]
    assert torch.equal(out["backbone.cbn_5.conv.weight"],
                       torch.from_numpy(kernel).permute(3, 2, 0, 1))
    for key, arr in (("bias", beta), ("mean", mean), ("var", var)):
        assert torch.equal(out[f"backbone.cbn_5.bn.{key}"], torch.from_numpy(arr))
    assert torch.equal(out["adipose_score.weight"], torch.from_numpy(head[0]).T)
    capsys.readouterr()
    few = write_inception_h5(tmp_path / "few.weights.h5", dict(list(convs.items())[:93]),
                             "generic")
    assert ClassifierTrainer._load_pretrained(variables, few) is variables
    got = capsys.readouterr().out
    assert JaxClassifierTrainer._load_pretrained(jax_tree, few) is jax_tree
    assert got == capsys.readouterr().out
    assert got.startswith("[pretrained] TF import skipped:")
