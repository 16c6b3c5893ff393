"""Segmentation evaluation on the CPU: the port's metrics, threshold search,
bootstrap, boundary metrics, visualizations, ``PublicationEvaluator`` and
``adipose-torch evaluate`` against the JAX package's, on the same inputs
made from a seed with numpy.

The JAX package draws the bootstrap's resamples from ``jax.random``, whose
stream the port does not reproduce; where intervals are compared, JAX's
index matrix is fed to the port through ``_draw_indices``.
"""

import json
import shutil
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.core.config import EvalConfig as JaxEvalConfig
from adipose_tpu.core.config import UNetConfig as JaxUNetConfig
from adipose_tpu.eval import bootstrap as jax_bootstrap
from adipose_tpu.eval import boundary as jax_boundary
from adipose_tpu.eval import threshold as jax_threshold
from adipose_tpu.eval import visualize as jax_visualize
from adipose_tpu.eval.evaluator import PublicationEvaluator as JaxEvaluator
from adipose_tpu.eval.evaluator import build_output_dir as jax_build_output_dir
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.ops import metrics as jax_metrics
from adipose_tpu.train import checkpoint as jax_ckpt
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import EvalConfig, UNetConfig
from adipose_tpu_torch.eval import bootstrap, boundary, threshold, visualize
from adipose_tpu_torch.eval.evaluator import (METRIC_KEYS, PublicationEvaluator,
                                              build_output_dir)
from adipose_tpu_torch.models.convert import save_flax_npz
from adipose_tpu_torch.ops import metrics
from adipose_tpu_torch.train.checkpoint import PARAMS_NPZ

N = 64
# Metric values from the same counts and ranks: float32 arithmetic that
# differs only in the order of a few sums.
METRIC_ATOL = 1e-6
# The evaluator end to end: the two float32 U-Nets' maps differ by ~1e-6,
# which can move a pixel across the threshold and a mean by ~1 / 4096; the
# bootstrap reads the same resamples of those means.
EVAL_ATOL = 1e-3
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_indices(monkeypatch):
    """The port's bootstrap fed JAX's resample indices."""
    def draw(n, n_bootstrap, seed=42):
        idx = jax.random.randint(jax.random.PRNGKey(seed), (n_bootstrap, n), 0, n)
        return torch.from_numpy(np.asarray(idx, np.int64))

    monkeypatch.setattr(bootstrap, "_draw_indices", draw)


def _maps():
    """(preds, trues) float32 (6, 32, 32): random maps, one quantized to
    1/8 steps (ties), one sitting on the threshold grid's values, an empty
    tile both sides call empty, a one-class tile (all positive) and an
    all-negative tile with false positives."""
    rs = np.random.RandomState(11)
    preds = rs.rand(6, 32, 32).astype(np.float32)
    trues = (rs.rand(6, 32, 32) > 0.6).astype(np.float32)
    preds[1] = np.round(preds[1] * 8) / 8
    grid = np.arange(0.1, 0.95, 0.05).astype(np.float32)
    preds[2] = grid[rs.randint(0, len(grid), (32, 32))]
    preds[3] *= 0.2
    trues[3] = 0.0
    trues[4] = 1.0
    trues[5] = 0.0
    return preds, trues


@pytest.mark.parametrize("thr", [0.5, 0.45, 0.3])
def test_pixel_metrics_match_jax(thr):
    """Counts exact; the derived metrics within METRIC_ATOL (the same
    float32 formulas on equal counts)."""
    preds, trues = _maps()
    got = metrics.batched_pixel_metrics(torch.from_numpy(preds), torch.from_numpy(trues), thr)
    want = jax_metrics.batched_pixel_metrics(preds, trues, thr)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=METRIC_ATOL, err_msg=k)
    for i in range(len(preds)):
        counts = metrics.confusion_counts(torch.from_numpy(preds[i]), torch.from_numpy(trues[i]),
                                          thr)
        assert [int(c) for c in counts] == \
            [int(c) for c in jax_metrics.confusion_counts(preds[i], trues[i], thr)]
        one = metrics.pixel_metrics(torch.from_numpy(preds[i]), torch.from_numpy(trues[i]), thr)
        assert all(abs(float(one[k]) - float(want[k][i])) <= METRIC_ATOL for k in want)
    assert float(got["dice_score"][3]) == 1.0  # both empty: perfect


@pytest.mark.parametrize("thresholds", [None, np.arange(0.1, 0.95, 0.05),
                                        np.arange(0.3, 0.41, 0.01)])
def test_f1_threshold_sweep_matches_jax(thresholds):
    """Map values on the float64 grid's float32 values compare as JAX's do."""
    preds, trues = _maps()
    got = metrics.f1_threshold_sweep(torch.from_numpy(preds), torch.from_numpy(trues),
                                     thresholds).numpy()
    thr = None if thresholds is None else jnp.asarray(thresholds, jnp.float32)
    want = np.stack([np.asarray(jax_metrics.f1_threshold_sweep(p, t, thr))
                     for p, t in zip(preds, trues)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL)


def test_auc_metrics_match_jax():
    """Ties, a one-class tile (NaN) and an all-negative tile (NaN)."""
    preds, trues = _maps()
    got = metrics.batched_auc_metrics(torch.from_numpy(preds), torch.from_numpy(trues))
    want = jax_metrics.batched_auc_metrics(jnp.asarray(preds), jnp.asarray(trues))
    for k in ("roc_auc", "pr_auc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_ATOL, equal_nan=True)
        assert np.isnan(got[k][[3, 4, 5]]).all() and np.isfinite(got[k][:3]).all()
    one = metrics.auc_metrics(torch.from_numpy(preds[1]), torch.from_numpy(trues[1]))
    ref = jax_metrics.auc_metrics(preds[1], trues[1])
    assert all(abs(float(one[k]) - float(ref[k])) <= METRIC_ATOL for k in ref)


def test_extract_slide_id_matches_jax():
    """String handling: equal."""
    for name in ("6 BEEF Shoulder -1_grid_5x5_r1_c2_r0_c1.jpg", "plain_name.jpg",
                 "s1_r3_c0.png", "slide_c4.tif", "a_b_r2.jpg", "x/y/s0_r1_c1.jpg"):
        assert threshold.extract_slide_id(name) == jax_threshold.extract_slide_id(name)


@pytest.fixture(scope="module")
def threshold_inputs():
    """Mixed-shape maps around two levels, four tiles over two slides."""
    rs = np.random.RandomState(12)
    preds, trues, paths = [], [], []
    for i, shape in enumerate([(32, 32), (48, 64), (32, 32), (48, 64), (32, 32)]):
        t = (rs.rand(*shape) > 0.5).astype(np.float32)
        p = np.where(t > 0, 0.55, 0.35) + rs.randn(*shape) * 0.08
        preds.append(p.astype(np.float32))
        trues.append(t)
        paths.append(f"slide{i % 2}_r{i}_c0.jpg")
    return preds, trues, paths


@pytest.mark.parametrize("fn", ["optimize_threshold_f1_slide_level", "optimize_threshold_f1",
                                "optimize_threshold_adaptive"])
def test_threshold_search_matches_jax(threshold_inputs, fn):
    """The same threshold; the F1 curves to METRIC_ATOL."""
    preds, trues, paths = threshold_inputs
    args = (preds, trues) if fn == "optimize_threshold_f1" else (preds, trues, paths)
    t, scores = getattr(threshold, fn)(*args, device="cpu")
    jt, jscores = getattr(jax_threshold, fn)(*args)
    assert t == jt
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("statistic,n", [("mean", 7), ("median", 7), ("median", 8)])
def test_bootstrap_matches_jax_on_its_indices(jax_indices, statistic, n):
    """Bound 1e-6: the same resamples reduced in float32; the median of an
    even count is the midpoint of the middle pair, as jnp.median's."""
    data = np.random.RandomState(13).rand(n) * 3
    got = bootstrap.bootstrap_confidence_interval(data, statistic, n_bootstrap=1000,
                                                  device="cpu")
    want = jax_bootstrap.bootstrap_confidence_interval(data, statistic, n_bootstrap=1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("data", [[1.0, np.nan, 2.0, np.inf, 3.0, 0.5], [np.nan, np.inf]])
def test_safe_bootstrap_matches_jax(jax_indices, data):
    """Non-finite values dropped, all-NaN gives NaN: bound 1e-6, as the
    plain bootstrap."""
    point, (lo, hi) = bootstrap.safe_bootstrap_ci(np.asarray(data), n_bootstrap=500,
                                                  device="cpu")
    jpoint, (jlo, jhi) = jax_bootstrap.safe_bootstrap_ci(np.asarray(data), n_bootstrap=500)
    np.testing.assert_allclose([point, lo, hi], [jpoint, jlo, jhi], rtol=0, atol=1e-6,
                               equal_nan=True)


def test_bootstrap_draws_on_the_host():
    """The indices come from a seeded CPU generator: the same on any device."""
    a, b = bootstrap._draw_indices(5, 100), bootstrap._draw_indices(5, 100)
    assert a.device.type == "cpu" and a.shape == (100, 5) and torch.equal(a, b)
    assert int(a.min()) == 0 and int(a.max()) == 4


def _masks():
    a = np.zeros((64, 64), np.float32)
    a[10:30, 10:30] = 1.0
    b = np.zeros((64, 64), np.float32)
    b[15:35, 12:30] = 0.9
    rs = np.random.RandomState(14)
    blobs = cv2.GaussianBlur(rs.rand(64, 64).astype(np.float32), (0, 0), 3)
    return [(a, a), (a, b), (np.zeros_like(a), np.zeros_like(a)), (a, np.zeros_like(a)),
            (blobs, (blobs > blobs.mean()).astype(np.float32))]


def test_boundary_metrics_equal_jax():
    """The same host code on the same masks: equal."""
    for pred, true in _masks():
        for thr in (0.5, 0.3):
            assert boundary.calculate_boundary_metrics(pred, true, thr) == \
                jax_boundary.calculate_boundary_metrics(pred, true, thr)


@pytest.mark.parametrize("kernel", [5, 3])
def test_boundary_refiner_equal_jax(kernel):
    """The same cv2 calls: equal."""
    for pred, _ in _masks():
        got = boundary.BoundaryRefiner(kernel_size=kernel).refine(pred)
        assert np.array_equal(got, jax_boundary.BoundaryRefiner(kernel_size=kernel).refine(pred))


def test_bucketed_visualizations_equal_jax(tmp_path):
    """The same buckets, file names and pixels."""
    rs = np.random.RandomState(15)
    images = [rs.rand(32, 32).astype(np.float32) * 255 for _ in range(5)]
    preds = [rs.rand(32, 32).astype(np.float32) for _ in range(5)]
    trues = [(rs.rand(32, 32) > 0.5).astype(np.float32) for _ in range(5)]
    dices = [0.2, 0.55, 0.7, 0.9, 0.95]
    names = [f"s0_r{i}_c0.jpg" for i in range(5)]
    counts = visualize.save_bucketed_visualizations(images, preds, trues, dices, names,
                                                    tmp_path / "t", 0.4, max_per_bucket=1)
    jcounts = jax_visualize.save_bucketed_visualizations(images, preds, trues, dices, names,
                                                         tmp_path / "j", 0.4, max_per_bucket=1)
    assert counts == jcounts == {"poor": 1, "fair": 1, "good": 1, "excellent": 1}
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.png"))
    for f in files:
        assert np.array_equal(cv2.imread(str(tmp_path / "t" / f)), cv2.imread(str(tmp_path / "j" / f)))


@pytest.mark.parametrize("kw", [
    {}, {"use_tta": True, "tta_mode": "full"}, {"use_ema_weights": True, "use_tta": True},
    {"use_sliding_window": True, "blend_mode": "linear", "sliding_overlap": 0.75},
    {"use_tta": True, "tta_mode": "minimal", "use_sliding_window": True,
     "use_boundary_refinement": True},
    {"use_boundary_refinement": True, "refine_kernel": 7, "adaptive_threshold": True},
])
@pytest.mark.parametrize("parent", ["original", "stain_normalized"])
def test_build_output_dir_matches_jax(kw, parent):
    """The artifact directory's name: equal."""
    got = build_output_dir(Path("ck"), Path(parent) / "test", EvalConfig(**kw))
    assert got == jax_build_output_dir(Path("ck"), Path(parent) / "test", JaxEvalConfig(**kw))
    assert build_output_dir(Path("ck"), Path("test"), EvalConfig(**kw), "out") == Path("out")


def test_eval_config_matches_jax():
    """The same fields and defaults."""
    assert EvalConfig().__dict__ == JaxEvalConfig().__dict__


@pytest.fixture(scope="module")
def eval_fixture(tmp_path_factory):
    """tests/test_eval.py's fixture: a random-init DilatedUNet(init_nb=4) run
    dir (orbax and params.npz) and four 64^2 tiles over two slides; plus a
    set of two larger images (one smaller than a tile in width) for the
    sliding window."""
    root = tmp_path_factory.mktemp("evaluate")
    ckpt_dir = root / "ckpt"
    model = JaxUNet(init_nb=4, compute_dtype=jnp.float32)
    params = jax.jit(model.init).lower(jax.random.PRNGKey(0), jnp.zeros((1, N, N))).compile(
        compiler_options=FAST)(jax.random.PRNGKey(0), jnp.zeros((1, N, N)))
    jax_ckpt.save_params(ckpt_dir, "weights_best_overall", params)
    save_flax_npz(jax.tree.map(np.asarray, params),
                  ckpt_dir / "weights_best_overall" / PARAMS_NPZ)
    jax_ckpt.save_normalization_stats(ckpt_dir, 127.0, 50.0)
    jax_ckpt.write_training_settings(ckpt_dir, {"use_deep_supervision": False, "init_nb": 4,
                                                "tile_size": N})
    rs = np.random.RandomState(865)
    sets = {"test": [(N, N)] * 4, "large": [(80, 120), (70, 50)]}
    for name, shapes in sets.items():
        data = root / "original" / name
        (data / "images").mkdir(parents=True)
        (data / "masks").mkdir()
        for i, (h, w) in enumerate(shapes):
            img = (rs.rand(h, w) * 255).astype(np.uint8)
            mask = np.zeros((h, w), np.uint8)
            mask[10:30, 10:30] = 255
            img[mask > 0] //= 2
            cv2.imwrite(str(data / "images" / f"s{i % 2}_r{i}_c0.jpg"), img)
            cv2.imwrite(str(data / "masks" / f"s{i % 2}_r{i}_c0.tif"), mask)
    return ckpt_dir, root / "original"


@pytest.mark.parametrize("dataset,kw", [
    ("test", {}),
    ("test", {"use_tta": True, "tta_mode": "minimal", "use_sliding_window": True,
              "use_boundary_refinement": True}),
    ("large", {"use_tta": True, "tta_mode": "basic", "use_sliding_window": True,
               "sliding_overlap": 0.75, "adaptive_threshold": True, "save_overlays": True}),
])
def test_evaluator_matches_jax(eval_fixture, jax_indices, tmp_path, dataset, kw):
    """The same threshold and artifact tree; metric means and CIs within
    EVAL_ATOL, with JAX's resample indices."""
    ckpt_dir, data_root = eval_fixture
    mcfg = dict(tile_size=N, init_nb=4, compute_dtype="float32")
    cfg = dict(n_bootstrap=1000, batch_size=4, **kw)
    want = JaxEvaluator(ckpt_dir, JaxEvalConfig(**cfg), JaxUNetConfig(**mcfg)).evaluate(
        data_root / dataset, dataset, output_dir=tmp_path / "jax", save_visualizations=True)
    ev = PublicationEvaluator(ckpt_dir, EvalConfig(**cfg), UNetConfig(**mcfg), device="cpu")
    got = ev.evaluate(data_root / dataset, dataset, output_dir=tmp_path / "torch",
                      save_visualizations=True)
    assert got["optimal_threshold"] == want["optimal_threshold"]
    assert (got["n_tiles"], got["n_slides"]) == (want["n_tiles"], want["n_slides"])
    assert got["config"] == want["config"]
    assert set(got["metrics"]) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        for stat in ("mean", "ci_lower", "ci_upper"):
            np.testing.assert_allclose(got["metrics"][k][stat], want["metrics"][k][stat],
                                       rtol=0, atol=EVAL_ATOL, err_msg=f"{k} {stat}")
    rel = lambda d: sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())  # noqa: E731
    assert rel(tmp_path / "torch") == rel(tmp_path / "jax")
    assert set(ev.timings) == {"predict_s", "threshold_s", "device_metrics_s", "boundary_s",
                               "bootstrap_s", "artifacts_s"}
    on_disk = json.loads((tmp_path / "torch" / "metrics.json").read_text())
    assert on_disk["optimal_threshold"] == got["optimal_threshold"]


def test_tta_divides_the_tile_batch(eval_fixture):
    """batch_size is the forward batch: the views fold into it."""
    ckpt_dir, _ = eval_fixture
    mcfg = UNetConfig(tile_size=N, init_nb=4, compute_dtype="float32")
    for mode, views in (("minimal", 2), ("basic", 4), ("full", 8)):
        ev = PublicationEvaluator(ckpt_dir, EvalConfig(use_tta=True, tta_mode=mode,
                                                       batch_size=16), mcfg, device="cpu")
        assert (ev.n_views, ev.tile_batch) == (views, 16 // views)
    assert PublicationEvaluator(ckpt_dir, EvalConfig(batch_size=16), mcfg,
                                device="cpu").tile_batch == 16


def test_evaluate_cli_matches_jax_cli(eval_fixture, tmp_path):
    """``adipose-torch evaluate --device cpu`` against ``adipose evaluate``
    at the CLI's bfloat16 compute: the same output directory name and file
    tree, the same threshold; the means within 1e-2 (bf16 maps differ by up
    to 2e-3, tests/test_torch_unet.py)."""
    ckpt_dir, data_root = eval_fixture
    flags = ["evaluate", "--weights", str(ckpt_dir), "--test-dataset", str(data_root / "test"),
             "--use-tta", "--tta-mode", "minimal", "--n-bootstrap", "200", "--batch-size", "4",
             "--optimize-threshold"]
    out = ckpt_dir / "evaluation"
    jax_main(flags)
    shutil.move(out, tmp_path / "jax")
    torch_main(flags + ["--device", "cpu"])
    shutil.move(out, tmp_path / "torch")
    rel = lambda d: sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())  # noqa: E731
    tree = rel(tmp_path / "torch")
    assert tree == rel(tmp_path / "jax")
    assert Path("test_original_tta_minimal/metrics.json") in tree
    got, want = (json.loads((tmp_path / s / "test_original_tta_minimal" / "metrics.json")
                            .read_text()) for s in ("torch", "jax"))
    assert got["optimal_threshold"] == want["optimal_threshold"]
    for k in METRIC_KEYS:
        assert abs(got["metrics"][k]["mean"] - want["metrics"][k]["mean"]) <= 1e-2, k
