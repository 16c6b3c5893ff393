"""The slice end to end on the CPU: ``adipose segment`` (JAX) and
``adipose-torch segment`` (the port) on one checkpoint and one tile folder."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.train import checkpoint as jax_ckpt
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.cli.main import segment_batch
from adipose_tpu_torch.serving.predict import load_segmenter
from adipose_tpu_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
# The two sides' bf16 forwards differ by at most 2e-3 (tests/test_torch_unet.py);
# a mask pixel may flip only where the probability is that close to 0.5.
MASK_FLIP_BAND = 2e-3


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_flax_params_npz", ROOT / "scripts" / "export_flax_params_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_and_tiles(tmp_path_factory):
    """A JAX checkpoint dir (init_nb 4, orbax) and a folder of three 64^2 PNGs."""
    root = tmp_path_factory.mktemp("segment")
    run = root / "run"
    run.mkdir()
    model = JaxUNet(init_nb=4, compute_dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64)))
    jax_ckpt.save_params(run, "weights_best_overall", variables)
    jax_ckpt.save_normalization_stats(run, 127.0, 60.0)
    (run / "training_settings.log").write_text("init_nb: 4\ntile_size: 64\n")
    tiles = root / "tiles"
    tiles.mkdir()
    rs = np.random.RandomState(5)
    for i in range(3):
        cv2.imwrite(str(tiles / f"tile{i}.png"), (rs.rand(64, 64) * 255).astype(np.uint8))
    return run, tiles


def test_load_params_names_the_export_script_for_orbax(run_and_tiles, tmp_path):
    run, _ = run_and_tiles
    orbax_only = tmp_path / "weights"
    orbax_only.mkdir()
    (orbax_only / "_CHECKPOINT_METADATA").write_text("{}")
    assert ckpt.resolve_weights_path(orbax_only) == orbax_only
    with pytest.raises(FileNotFoundError, match="export_flax_params_npz.py"):
        ckpt.load_params(orbax_only)
    assert ckpt.resolve_weights_path(run) == run / "weights_best_overall"


def test_segment_matches_jax_cli(run_and_tiles, tmp_path):
    run, tiles = run_and_tiles
    _export_script().main([str(run)])
    assert (run / "weights_best_overall" / ckpt.PARAMS_NPZ).exists()
    flags = ["--input-dir", str(tiles), "--batch-size", "2", "--save-probability",
             "--save-overlays", "--weights", str(run)]
    jax_main(["segment", "--output-dir", str(tmp_path / "jax"), *flags])
    torch_main(["segment", "--output-dir", str(tmp_path / "torch"), "--device", "cpu", *flags])

    rel = lambda d: sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())
    assert rel(tmp_path / "jax") == rel(tmp_path / "torch")
    assert len(rel(tmp_path / "torch")) == 9

    predict, params, _, _ = load_segmenter(run, device="cpu")
    names = sorted(tiles.iterdir())
    batch = np.stack([cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(np.float32)
                      for p in names])
    probs = segment_batch(predict, params, batch, 4, "cpu")
    assert probs.shape == (3, 64, 64) and np.isfinite(probs).all()
    for p, prob in zip(names, probs):
        read = lambda side, sub, suffix: cv2.imread(
            str(tmp_path / side / sub / f"{p.stem}_{suffix}.tif"), cv2.IMREAD_UNCHANGED)
        mj, mt = read("jax", "masks", "mask"), read("torch", "masks", "mask")
        assert np.array_equal(mt, (prob > 0.5).astype(np.uint8))
        flips = mj != mt
        assert np.all(np.abs(prob[flips] - 0.5) <= MASK_FLIP_BAND)
        pj = read("jax", "probability_maps", "prob").astype(int)
        pt = read("torch", "probability_maps", "prob").astype(int)
        assert np.abs(pj - pt).max() <= 1


def test_model_config_reads_what_the_jax_package_writes(tmp_path):
    from adipose_tpu.core.config import UNetConfig as JaxUNetConfig
    from adipose_tpu_torch.core.config import UNetConfig

    jcfg = JaxUNetConfig(init_nb=8, use_deep_supervision=True, dilation_rates=(1, 2, 4))
    jcfg.to_json(tmp_path / "unet.json")
    cfg = UNetConfig.from_json(tmp_path / "unet.json")
    jax_ckpt.write_training_settings(tmp_path, vars(jcfg))
    detected = ckpt.detect_model_config(tmp_path)
    want = jax_ckpt.detect_model_config(tmp_path)
    for c in (cfg, detected):
        assert (c.init_nb, c.use_deep_supervision, tuple(c.dilation_rates)) == (8, True, (1, 2, 4))
        assert (c.tile_size, c.dropout_rate) == (want.tile_size, want.dropout_rate)


def test_segment_tta_matches_jax_cli(run_and_tiles, tmp_path, monkeypatch):
    """``segment --use-tta --tta-mode basic`` on both CLIs: masks and
    probability maps within the bands of test_segment_matches_jax_cli; the
    tile chunk is --batch-size divided by the 4 views, so each forward
    batch is --batch-size images."""
    import adipose_tpu_torch.cli.main as cli
    import adipose_tpu_torch.serving.predict as serving_predict

    run, tiles = run_and_tiles
    _export_script().main([str(run)])
    chunks, forwards = [], []
    segment = cli.segment_batch
    zscore = serving_predict.fused_zscore_normalize
    monkeypatch.setattr(cli, "segment_batch", lambda predict, params, batch, size, device: (
        chunks.append((batch.shape[0], size)) or segment(predict, params, batch, size, device)))
    monkeypatch.setattr(serving_predict, "fused_zscore_normalize", lambda tiles, *a, **k: (
        forwards.append(tuple(tiles.shape)) or zscore(tiles, *a, **k)))
    flags = ["--input-dir", str(tiles), "--batch-size", "8", "--save-probability",
             "--use-tta", "--tta-mode", "basic", "--weights", str(run)]
    jax_main(["segment", "--output-dir", str(tmp_path / "jax"), *flags])
    torch_main(["segment", "--output-dir", str(tmp_path / "torch"), "--device", "cpu", *flags])
    assert chunks == [(2, 2), (1, 2)]
    assert forwards == [(8, 64, 64)] * 2

    rel = lambda d: sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())
    assert rel(tmp_path / "jax") == rel(tmp_path / "torch")
    assert len(rel(tmp_path / "torch")) == 6
    monkeypatch.undo()
    from adipose_tpu_torch.eval.tta import make_tta_predict

    predict, params, _, _ = load_segmenter(run, device="cpu")
    names = sorted(tiles.iterdir())
    batch = np.stack([cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(np.float32)
                      for p in names])
    tta = make_tta_predict(predict, "basic")
    probs = np.concatenate([segment_batch(tta, params, batch[i:i + 2], 2, "cpu")
                            for i in (0, 2)])  # the CLI's chunks
    for p, prob in zip(names, probs):
        read = lambda side, sub, suffix: cv2.imread(
            str(tmp_path / side / sub / f"{p.stem}_{suffix}.tif"), cv2.IMREAD_UNCHANGED)
        mj, mt = read("jax", "masks", "mask"), read("torch", "masks", "mask")
        assert np.array_equal(mt, (prob > 0.5).astype(np.uint8))
        assert np.all(np.abs(prob[mj != mt] - 0.5) <= MASK_FLIP_BAND)
        pj = read("jax", "probability_maps", "prob").astype(int)
        pt = read("torch", "probability_maps", "prob").astype(int)
        assert np.abs(pj - pt).max() <= 1


def test_cli_imports_without_jax():
    """The command line, the trainer, the augmentation and every other
    module of the port import without JAX or the JAX package."""
    code = ("import sys, pkgutil, importlib, adipose_tpu_torch\n"
            "import adipose_tpu_torch.cli.main, adipose_tpu_torch.train.trainer_unet\n"
            "import adipose_tpu_torch.data.augment\n"
            "for m in pkgutil.walk_packages(adipose_tpu_torch.__path__, 'adipose_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'adipose_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
