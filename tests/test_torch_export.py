"""Serving export on the CPU: ``adipose-torch export`` bundles, their U-Net
program against the JAX package's baked-in predict and against the eager
port, and ``segment --bundle`` / ``classify --bundle`` against ``--weights``.

Kernels A and B are custom ops, so the exported program holds each as a
node; on the CPU their kernels are the plain versions."""

import csv
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.train.state import make_unet_predict as jax_make_unet_predict
from adipose_tpu_torch.serving.predict import load_segmenter
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.models.convert import torch_inception_to_flax, torch_unet_to_flax
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.serving.export import load_exported, program_devices
from adipose_tpu_torch.train import checkpoint as ckpt

from test_torch_segment import MASK_FLIP_BAND

MEAN, STD = 127.0, 60.0
TILE, BATCH = 64, 4
# Both sides bf16: the two sum their convs in other orders, measured by
# tests/test_torch_unet.py::test_bf16_forward_matches_live_jax.
BF16_MAX_ATOL, BF16_MEAN_ATOL = 2e-3, 1e-4
CSV_ATOL = 1e-6
# torch.library.opcheck's checks but the slow AOT-dispatch one (the export
# tests trace the ops)
OPCHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_tiles(folder, n: int, size: int, seed: int):
    folder.mkdir(parents=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        img = rs.rand(size, size) * 200 + 30 + 20 * np.sin(np.arange(size) / (3.0 + i))
        cv2.imwrite(str(folder / f"tile{i}.png"), img.astype(np.uint8))
    return folder


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """A port run (init_nb 4, seeded, params.npz), a folder of five 64^2
    tiles and the run's CPU bundle at batch 4."""
    root = tmp_path_factory.mktemp("export")
    run = root / "run"
    model = DilatedUNet(init_nb=4).init_params(torch.Generator().manual_seed(3))
    ckpt.save_params(run, "weights_best_overall", torch_unet_to_flax(model.state_dict()))
    ckpt.save_normalization_stats(run, MEAN, STD)
    (run / "training_settings.log").write_text(f"init_nb: 4\ntile_size: {TILE}\n")
    bundle = root / "bundle"
    torch_main(["export", "--weights", str(run), "--output", str(bundle), "--batch-size",
                str(BATCH), "--tile-size", str(TILE), "--device", "cpu", "--platforms", "cpu"])
    return run, _write_tiles(root / "tiles", 5, TILE, 5), bundle


def _tiles(n: int = BATCH, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, TILE, TILE)).astype(np.float32)


def test_unet_bundle_matches_jax_baked_in_predict(unet):
    """The program against the JAX package's ``(tiles - mean) / (std +
    1e-10)`` -> ``make_unet_predict``, both bf16, on the bundle's params."""
    _, _, bundle = unet
    call, params, manifest = load_exported(bundle, "cpu")
    assert manifest["normalization"] == {"mean": MEAN, "std": STD}
    tree = ckpt.load_params(bundle / "params")
    x = _tiles()
    got = call(params, torch.from_numpy(x)).numpy()
    predict = jax_make_unet_predict(JaxUNet(init_nb=4))
    want = np.asarray(predict(jax.tree.map(jnp.asarray, tree),
                              (jnp.asarray(x) - MEAN) / (STD + 1e-10)))
    assert got.shape == want.shape == (BATCH, TILE, TILE) and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.max() <= BF16_MAX_ATOL and diff.mean() <= BF16_MEAN_ATOL
    flips = (got > 0.5) != (want > 0.5)
    assert np.all(np.abs(got[flips] - 0.5) <= MASK_FLIP_BAND)


def test_unet_program_holds_the_kernel_ops(unet):
    _, _, bundle = unet
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert (manifest["format"], manifest["platforms"], manifest["programs"]) == (
        "torch.export", ["cpu"], {"cpu": "model.cpu.pt2"})
    assert (manifest["model_type"], manifest["batch_size"], manifest["tile_size"]) == (
        "unet", BATCH, TILE)
    assert manifest["torch"] == torch.__version__
    assert sorted(p.name for p in bundle.rglob("*") if p.is_file()) == [
        "manifest.json", "model.cpu.pt2", "params.npz"]
    graph = torch.export.load(bundle / "model.cpu.pt2").graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("adipose.zscore.default") == 1
    assert targets.count("adipose.sigmoid_head.default") == 1


def test_call_with_other_params_equals_eager(unet):
    """``call(params, x)`` runs the program with the params it is given:
    bit-equal to the eager predict of ``segment --weights`` with them."""
    run, _, bundle = unet
    call, _, _ = load_exported(bundle, "cpu")
    other = DilatedUNet(init_nb=4).init_params(torch.Generator().manual_seed(11)).state_dict()
    other = {k: v.detach() for k, v in other.items()}
    predict, own, _, _ = load_segmenter(run, device="cpu")
    x = torch.from_numpy(_tiles(seed=1))
    got = call(other, x)
    assert torch.equal(got, predict(other, x))
    assert not torch.equal(got, predict(own, x))


def test_bundle_without_the_device_program_raises(unet):
    _, _, bundle = unet
    with pytest.raises(FileNotFoundError, match="no program for cuda"):
        load_exported(bundle, "cuda")


@pytest.mark.parametrize("platforms,device,want", [
    (("tpu", "cpu"), "cuda", ["cuda", "cpu"]),
    (("tpu", "cpu"), "cpu", ["cpu"]),
    (("cpu", "gpu", "cuda", "tpu"), "cuda:0", ["cpu", "cuda:0"]),
])
def test_platforms_map_to_program_devices(platforms, device, want):
    assert program_devices(platforms, device) == [torch.device(d) for d in want]


def test_unknown_platform_raises(unet, tmp_path):
    run, _, _ = unet
    with pytest.raises(ValueError, match="unknown platform 'foo'"):
        torch_main(["export", "--weights", str(run), "--output", str(tmp_path / "b"),
                    "--device", "cpu", "--platforms", "foo"])


def test_export_for_cuda_raises_without_a_gpu(unet, tmp_path):
    """The default --device cuda with the default platforms traces a CUDA
    program; with no GPU that raises and writes nothing."""
    run, _, _ = unet
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        torch_main(["export", "--weights", str(run), "--output", str(tmp_path / "b")])
    assert not (tmp_path / "b").exists()


@pytest.mark.parametrize("dtypes", [(torch.uint8, torch.bfloat16), (torch.float32, torch.float32)],
                         ids=["u8_bf16", "f32_f32"])
def test_zscore_op_passes_opcheck(dtypes):
    """``adipose::zscore``: schema, fake implementation against the CPU
    kernel, autograd registration (none: not differentiable)."""
    tiles = torch.from_numpy(_tiles(2)).to(dtypes[0])
    torch.library.opcheck(torch.ops.adipose.zscore.default, (tiles, MEAN, STD, 235.0, dtypes[1]),
                          test_utils=OPCHECKS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sigmoid_head_op_passes_opcheck(dtype):
    """``adipose::sigmoid_head``: schema, fake implementation, autograd
    registration; its gradients (the backward wrapper, B' on the card)
    against autograd through the plain version."""
    from adipose_tpu_torch.ops.cuda.unet_kernels import diff_sigmoid_head_plain

    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, 8, 8, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn(6, generator=g).to(dtype)
    bias = torch.tensor(0.3)
    args = [t.clone().requires_grad_() for t in (x, w, bias)]
    torch.library.opcheck(torch.ops.adipose.sigmoid_head.default, args, test_utils=OPCHECKS)
    cot = torch.rand(2, 8, 8, generator=g)
    got = torch.autograd.grad(torch.ops.adipose.sigmoid_head(*args), args, cot)
    ref = [t.clone().requires_grad_() for t in (x, w, bias)]
    want = torch.autograd.grad(diff_sigmoid_head_plain(*ref), ref, cot)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2 if dtype == torch.bfloat16
                                   else 1e-5, atol=1e-6)


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


@pytest.mark.parametrize("tta", [[], ["--use-tta", "--tta-mode", "basic"]],
                         ids=["plain", "tta_basic"])
def test_segment_bundle_equals_segment_weights(unet, tmp_path, tta):
    """The output contract (masks, probability maps, overlays) of
    ``segment --bundle`` is byte-equal to ``segment --weights``'; with
    basic TTA the chunk is one tile, whose four views fill the batch."""
    run, tiles, bundle = unet
    flags = ["--input-dir", str(tiles), "--batch-size", str(BATCH), "--save-probability",
             "--save-overlays", "--device", "cpu", *tta]
    torch_main(["segment", "--bundle", str(bundle), "--output-dir", str(tmp_path / "b"), *flags])
    torch_main(["segment", "--weights", str(run), "--output-dir", str(tmp_path / "w"), *flags])
    files = _files(tmp_path / "w")
    assert _files(tmp_path / "b") == files and len(files) == 15
    for rel in files:
        assert (tmp_path / "b" / rel).read_bytes() == (tmp_path / "w" / rel).read_bytes(), rel


def test_segment_requires_weights_or_bundle(unet, tmp_path):
    _, tiles, _ = unet
    with pytest.raises(SystemExit, match="segment requires --weights or --bundle"):
        torch_main(["segment", "--input-dir", str(tiles), "--output-dir", str(tmp_path),
                    "--device", "cpu"])


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """A seeded full-width InceptionV3 run, its CPU bundle at batch 2 and
    three 75^2 tiles."""
    root = tmp_path_factory.mktemp("export_cls")
    run = root / "run"
    model = InceptionV3Classifier().init_params(torch.Generator().manual_seed(0))
    ckpt.save_params(run, "weights_best", torch_inception_to_flax(model.state_dict()))
    bundle = root / "bundle"
    torch_main(["export", "--weights", str(run), "--model", "classifier", "--output",
                str(bundle), "--batch-size", "2", "--device", "cpu", "--platforms", "cpu"])
    return run, bundle, _write_tiles(root / "tiles", 3, 75, 9)


def _rows(path):
    with path.open(newline="") as f:
        return list(csv.DictReader(f))


def test_classify_bundle_equals_classify_weights(classifier, tmp_path, capsys):
    """``classify --bundle --percentile-norm`` (the stretch and resize before
    the program) against ``classify --weights``: the same rows, the
    probabilities within 1e-6; the bundle's batch overrides --batch-size."""
    run, bundle, tiles = classifier
    flags = ["--input-dir", str(tiles), "--pattern", "*.png", "--percentile-norm",
             "--device", "cpu"]
    torch_main(["classify", "--bundle", str(bundle), "--batch-size", "3",
                "--output-dir", str(tmp_path / "b"), *flags])
    assert "bundle exported at batch 2; overriding --batch-size" in capsys.readouterr().out
    torch_main(["classify", "--weights", str(run), "--batch-size", "2",
                "--output-dir", str(tmp_path / "w"), *flags])
    got, want = (_rows(tmp_path / s / "predictions_grayscale.csv") for s in ("b", "w"))
    assert len(got) == 3
    assert [(r["image_path"], r["binary_prediction"]) for r in got] == \
        [(r["image_path"], r["binary_prediction"]) for r in want]
    np.testing.assert_allclose([float(r["adipose_probability"]) for r in got],
                               [float(r["adipose_probability"]) for r in want],
                               rtol=0, atol=CSV_ATOL)


def test_classify_bundle_tta_needs_a_divisible_batch(classifier, tmp_path):
    _, bundle, tiles = classifier
    with pytest.raises(SystemExit, match=r"exported batch \(2\) divisible by 4 TTA views"):
        torch_main(["classify", "--bundle", str(bundle), "--input-dir", str(tiles),
                    "--output-dir", str(tmp_path), "--use-tta", "--tta-mode", "basic",
                    "--device", "cpu"])
