"""The rest of segmentation evaluation on the CPU: the port's tile
classification, batch checkpoint evaluation, metrics collection and the
``tile-classification-eval``, ``evaluate-checkpoints`` and
``visualize-metrics`` subcommands against the JAX package's; the remaining
losses against the TF-oracle goldens and the JAX functions; and
``classifier_metrics``. The CLI runs use ``tests/test_torch_evaluate.py``'s
init_nb 4 run and 64^2 tiles. Every bound is stated beside its test.
"""

import json
import math
import shutil
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adipose_tpu.eval.batch_eval as jax_batch_eval
import adipose_tpu_torch.eval.batch_eval as batch_eval
from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.core.config import EvalConfig as JaxEvalConfig
from adipose_tpu.eval import tile_classification as jax_tc
from adipose_tpu.ops import losses as jax_losses
from adipose_tpu.ops import metrics as jax_metrics
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import EvalConfig
from adipose_tpu_torch.eval import tile_classification as tc
from adipose_tpu_torch.ops import losses, metrics
from test_torch_evaluate import eval_fixture  # noqa: F401  (a module-scoped fixture)

ROOT = Path(__file__).resolve().parents[1]
# The CLIs run their U-Nets in bf16: maps differ by up to 2e-3
# (tests/test_torch_unet.py), so a slide mean moves by ~1 / 4096 per
# flipped pixel; tests/test_torch_evaluate.py compares `evaluate` means to 1e-2.
CLI_MEAN_ATOL = 1e-2
# TF-oracle goldens: tests/test_golden.py's bounds for the JAX losses.
GOLDEN_RTOL, GOLDEN_ATOL = 2e-5, 2e-6
# The same float32 formulas on the same inputs, summed in other orders.
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- tile classification -------------------------------------------------------


def _tile_maps():
    """Eight 32^2 maps and masks with fat coverage from 0 to ~50%, some on
    the coverage ladder's values."""
    rs = np.random.RandomState(21)
    preds, trues = [], []
    for i, cover in enumerate((0.0, 0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5)):
        t = np.zeros((32, 32), np.float32)
        t.flat[:int(round(cover * 1024))] = 1.0
        p = np.clip(t * 0.6 + rs.rand(32, 32) * 0.45 * (i % 3), 0, 1).astype(np.float32)
        p[0, 0] = 0.5  # exactly at the pixel threshold: not fat ('>')
        preds.append(p)
        trues.append(t)
    return preds, trues


@pytest.mark.parametrize("coverage,pixel", [(0.025, 0.5), (0.1, 0.3), (0.0, 0.5)])
def test_tile_classification_equals_jax(coverage, pixel):
    """Host numpy copied from the JAX package: equal."""
    preds, trues = _tile_maps()
    for p in preds:
        assert tc.calculate_fat_percentage(p, pixel) == jax_tc.calculate_fat_percentage(p, pixel)
    got = tc.classify_tiles(preds, trues, coverage, pixel)
    want = jax_tc.classify_tiles(preds, trues, coverage, pixel)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert tc.evaluate_tiles(preds, trues, coverage, pixel) == \
        jax_tc.evaluate_tiles(preds, trues, coverage, pixel)
    assert tc.multi_threshold_sweep(preds, trues, pixel_threshold=pixel) == \
        jax_tc.multi_threshold_sweep(preds, trues, pixel_threshold=pixel)


@pytest.mark.parametrize("multi", [False, True, [0.01, 0.05, 0.1]])
def test_tile_classification_json_equals_jax(tmp_path, multi):
    preds, trues = _tile_maps()
    got = tc.run_tile_classification_evaluation(preds, trues, tmp_path / "t", 0.05, multi)
    want = jax_tc.run_tile_classification_evaluation(preds, trues, tmp_path / "j", 0.05, multi)
    assert got == want
    name = "tile_classification_metrics.json"
    assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


@pytest.mark.parametrize("flags", [["--use-tta", "--multi-threshold", "--coverage-threshold",
                                    "0.02", "--mask-threshold", "0.4"],
                                   ["--multi-threshold", "1,5,10", "--threshold", "5",
                                    "--boundary-refine", "--transfer-dtype", "float32"]])
def test_tile_classification_cli_matches_jax_cli(eval_fixture, tmp_path, flags):  # noqa: F811
    """``adipose-torch tile-classification-eval --device cpu`` against
    ``adipose tile-classification-eval`` (both bf16): the same JSON keys
    and thresholds; the confusion counts equal unless a tile's fat fraction
    sits within one pixel's share per 2e-3 of bf16 noise of its coverage
    threshold (none does on these tiles); then the whole JSON equal."""
    ckpt_dir, data_root = eval_fixture
    base = ["tile-classification-eval", "--weights", str(ckpt_dir), "--test-dataset",
            str(data_root / "test"), *flags]
    jax_main(base + ["--output", str(tmp_path / "jax")])
    torch_main(base + ["--output", str(tmp_path / "torch"), "--device", "cpu"])
    name = "tile_classification_metrics.json"
    got, want = (json.loads((tmp_path / s / name).read_text()) for s in ("torch", "jax"))
    assert got == want
    assert ("threshold_sweep" in got) == ("--multi-threshold" in flags)


def test_tile_classification_cli_default_output(eval_fixture):  # noqa: F811
    """Without --output the JSON lands in <run>/evaluation/tile_classification."""
    ckpt_dir, data_root = eval_fixture
    out = ckpt_dir / "evaluation" / "tile_classification"
    torch_main(["tile-classification-eval", "--weights", str(ckpt_dir), "--data-root",
                str(data_root / "test"), "--device", "cpu"])
    got = json.loads((out / "tile_classification_metrics.json").read_text())
    assert got["coverage_threshold"] == 0.1 and got["n_tiles"] == 4
    shutil.rmtree(out)


# ---- batch checkpoint evaluation -----------------------------------------------------


def _checkpoints_root(eval_fixture, root: Path) -> Path:  # noqa: F811
    """Two copies of the init_nb 4 run under *adipose* names, a dir without
    normalization statistics (not a run) and one whose weights are missing
    (a failed evaluation)."""
    ckpt_dir, _ = eval_fixture
    for name in ("20240101_000000_adipose_a", "nested/20240102_000000_adipose_b"):
        shutil.copytree(ckpt_dir, root / name, ignore=shutil.ignore_patterns("evaluation"))
    (root / "adipose_not_a_run").mkdir()
    broken = root / "20231231_000000_adipose_broken"
    broken.mkdir()
    (broken / "normalization_stats.json").write_text('{"mean": 1.0, "std": 1.0}')
    return root


def test_discover_checkpoints_equals_jax(eval_fixture, tmp_path):  # noqa: F811
    root = _checkpoints_root(eval_fixture, tmp_path / "ck")
    got = batch_eval.discover_checkpoints(root)
    assert got == jax_batch_eval.discover_checkpoints(root)
    assert [d.name for d in got] == ["20240102_000000_adipose_b", "20240101_000000_adipose_a",
                                     "20231231_000000_adipose_broken"]
    assert batch_eval.discover_checkpoints(tmp_path / "missing") == []


def test_evaluate_checkpoints_cli_matches_jax_cli(eval_fixture, tmp_path, capsys):  # noqa: F811
    """``adipose-torch evaluate-checkpoints --device cpu`` against ``adipose
    evaluate-checkpoints`` on the same root: the same records in the same
    order (checkpoint, status, keys), the broken run ``failed`` with an
    error on both sides, the two copies of one run ``success`` with equal
    Dice and threshold on the port's side, within CLI_MEAN_ATOL of JAX's;
    the same evaluation dirs and files; ``batch_evaluation_summary.json``.
    With ``--parallel`` the port's records are the serial run's."""
    ckpt_dir, data_root = eval_fixture
    flags = ["evaluate-checkpoints", "--test-dataset", str(data_root / "test"), "--no-images",
             "--n-bootstrap", "100", "--use-tta", "--tta-mode", "minimal"]
    summaries = {}
    for side, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"]),
                              ("parallel", torch_main, ["--device", "cpu", "--parallel",
                                                        "--max-workers", "2"])):
        root = _checkpoints_root(eval_fixture, tmp_path / side)
        main(flags + ["--checkpoints-root", str(root)] + extra)
        summaries[side] = json.loads((root / "batch_evaluation_summary.json").read_text())
    out = capsys.readouterr().out
    assert out.count("success") == 6 and out.count("failed") == 3
    got, want = summaries["torch"], summaries["jax"]
    names = lambda rs: [(Path(r["checkpoint"]).name, r["status"], sorted(r))  # noqa: E731
                        for r in rs]
    assert names(got) == names(want) == names(summaries["parallel"])
    ok = [r for r in got if r["status"] == "success"]
    assert len(ok) == 2 and ok[0]["dice"] == ok[1]["dice"] and \
        ok[0]["threshold"] == ok[1]["threshold"]
    for g, w, p in zip(got, want, summaries["parallel"]):
        if w["status"] == "success":
            assert abs(g["dice"] - w["dice"]) <= CLI_MEAN_ATOL
            assert g["threshold"] == w["threshold"]
            assert (p["dice"], p["threshold"]) == (g["dice"], g["threshold"])
        else:
            assert g["error"] and "Traceback" in g["traceback"]
            assert p["error"] == g["error"].replace(str(tmp_path / "torch"),
                                                    str(tmp_path / "parallel"))
    tree = lambda d: sorted(p.relative_to(d) for p in d.rglob("*")  # noqa: E731
                            if "evaluation" in p.parts)
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax") == tree(tmp_path / "parallel")
    assert any(p.name == "test_comprehensive_results.csv" for p in tree(tmp_path / "torch"))


def test_evaluate_checkpoints_needs_a_dataset(tmp_path):
    with pytest.raises(SystemExit, match="needs --test-dataset"):
        torch_main(["evaluate-checkpoints", "--checkpoints-root", str(tmp_path),
                    "--device", "cpu"])


@pytest.fixture(scope="module")
def evaluated_root(eval_fixture, tmp_path_factory):  # noqa: F811
    """A checkpoints root whose two runs hold the port's evaluations under
    four configurations and two sources."""
    from adipose_tpu_torch.eval.evaluator import PublicationEvaluator

    root = _checkpoints_root(eval_fixture, tmp_path_factory.mktemp("evaluated"))
    _, data_root = eval_fixture
    stain = data_root.parent / "stain_normalized" / "test"
    if not stain.exists():
        shutil.copytree(data_root / "test", stain)
    for run in batch_eval.discover_checkpoints(root)[:2]:
        for kw in ({}, {"use_tta": True, "tta_mode": "minimal"},
                   {"use_boundary_refinement": True}):
            ev = PublicationEvaluator(run, EvalConfig(n_bootstrap=50, **kw), device="cpu")
            ev.evaluate(data_root / "test", "test")
        ev = PublicationEvaluator(run, EvalConfig(n_bootstrap=50), device="cpu")
        ev.evaluate(stain, "test")
    return root


def _records(df) -> list[dict]:
    return df.to_dict("records") if len(df) else []


def _same_rows(got: list[dict], want: list[dict]) -> None:
    """pandas' records against the port's rows: the same order, keys, types
    and values, NaN equal to NaN; floats within 1e-14 relative, because
    pandas' default CSV float parser is not correctly rounded (measured up
    to 5 ulps from Python's ``float`` on these files)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                assert isinstance(g[k], float), k
                assert (math.isnan(w[k]) and math.isnan(g[k])) or \
                    math.isclose(g[k], w[k], rel_tol=1e-14, abs_tol=0.0), (k, g[k], w[k])
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), k


@pytest.mark.parametrize("kw", [{}, {"use_tta": True, "tta_mode": "minimal"},
                                {"use_boundary_refinement": True}, {"use_ema_weights": True}])
def test_collect_checkpoint_metrics_equals_jax(evaluated_root, kw):
    """The CSV rows with the JAX (pandas) types and values, the suffix rule
    included (no suffix: no enhanced dir)."""
    got = batch_eval.collect_checkpoint_metrics(evaluated_root, EvalConfig(**kw))
    want = _records(jax_batch_eval.collect_checkpoint_metrics(evaluated_root,
                                                              JaxEvalConfig(**kw)))
    _same_rows(got, want)
    assert bool(got) == (not kw.get("use_ema_weights"))


@pytest.mark.parametrize("flags", [[], ["--use-tta", "--tta-mode", "minimal"], ["--test"],
                                   ["--val"], ["--stain"], ["--original", "--test"],
                                   ["--checkpoints", "20240101_000000_adipose_a"],
                                   ["--boundary-refine", "--metric", "Specificity"]])
def test_visualize_metrics_cli_selects_as_jax_cli(evaluated_root, monkeypatch, flags):
    """The rows each CLI hands to its chart, captured: the same, and both
    CLIs write nothing when none is left."""
    seen = {}

    def capture(side):
        def plot(rows, output, metric="Dice Score"):
            seen[side] = (_records(rows) if side == "jax" else rows, str(output), metric)
            return output
        return plot

    monkeypatch.setattr(jax_batch_eval, "plot_checkpoint_comparison", capture("jax"))
    monkeypatch.setattr(batch_eval, "plot_checkpoint_comparison", capture("torch"))
    argv = ["visualize-metrics", "--checkpoints-root", str(evaluated_root), *flags]
    jax_main(argv)
    torch_main(argv)
    if seen:
        assert set(seen) == {"jax", "torch"}
        _same_rows(seen["torch"][0], seen["jax"][0])
        assert seen["torch"][1:] == seen["jax"][1:]
    assert bool(seen) == (flags != ["--val"])


def test_visualize_metrics_writes_the_chart(evaluated_root, tmp_path):
    """--name gives <name>.png, else --output; the chart is a PNG; a metric
    that no row has draws nothing."""
    torch_main(["visualize-metrics", "--checkpoints-root", str(evaluated_root),
                "--output", str(tmp_path / "cmp.png")])
    img = cv2.imread(str(tmp_path / "cmp.png"))
    assert img is not None and img.shape[0] == 480 and img.std() > 0
    torch_main(["visualize-metrics", "--checkpoints-root", str(evaluated_root),
                "--name", str(tmp_path / "named")])
    assert (tmp_path / "named.png").exists()
    rows = batch_eval.collect_checkpoint_metrics(evaluated_root)
    assert batch_eval.plot_checkpoint_comparison(rows, tmp_path / "x.png", "Nope") is None
    assert not (tmp_path / "x.png").exists()


# ---- the remaining losses and classifier_metrics -------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(ROOT / "tests" / "golden_tf_oracle.npz")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["dice_coef_loss", "jaccard_coef", "jaccard_coef_int",
                                  "weighted_bce_dice_loss", "weighted_dice_loss",
                                  "precision_onehot", "recall_onehot", "fmeasure_onehot"])
def test_losses_match_tf_oracle_and_jax(golden, name):
    """The TF oracle's value within tests/test_golden.py's bounds (the
    border-weighted losses on the first sample, the one-hot metrics on the
    two-class stack, as there); the JAX function within LOSS_RTOL."""
    yt, yp = golden["losses/y_true"], golden["losses/y_pred"]
    if name.startswith("weighted"):
        yt, yp = yt[:1], yp[:1]
    if name.endswith("onehot"):
        yt, yp = np.stack([1 - yt, yt], -1), np.stack([1 - yp, yp], -1)
    got = float(getattr(losses, name)(_t(yt), _t(yp)))
    np.testing.assert_allclose(got, float(golden[f"losses/{name}"]), rtol=GOLDEN_RTOL,
                               atol=0 if name.startswith("weighted") else GOLDEN_ATOL)
    np.testing.assert_allclose(got, float(getattr(jax_losses, name)(jnp.asarray(yt),
                                                                    jnp.asarray(yp))),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", [(2, 48, 40), (48, 40)])
def test_border_weight_and_weighted_terms_match_jax(shape):
    """Border map (the valid-pixel window mean, mean preserved) equal to
    JAX's within LOSS_RTOL on a soft mask; weighted BCE and Dice with a
    given weight too; the label-smoothed BCE."""
    rs = np.random.RandomState(22)
    mask = (cv2.GaussianBlur(rs.rand(*shape[-2:]).astype(np.float32), (0, 0), 3) > 0.5)
    yt = np.broadcast_to(mask, shape).astype(np.float32) * 0.9
    yp = rs.rand(*shape).astype(np.float32)
    w = losses._border_weight(_t(yt))
    jw = np.asarray(jax_losses._border_weight(jnp.asarray(yt)))
    assert w.shape == jw.shape
    np.testing.assert_allclose(w.numpy(), jw, rtol=LOSS_RTOL)
    assert 0 < (w.numpy() > 1).mean() < 1
    for name in ("weighted_bce", "weighted_dice_coeff"):
        np.testing.assert_allclose(
            float(getattr(losses, name)(_t(yt), _t(yp), _t(jw))),
            float(getattr(jax_losses, name)(jnp.asarray(yt), jnp.asarray(yp), jnp.asarray(jw))),
            rtol=LOSS_RTOL, err_msg=name)
    for s in (0.1, 0.0):
        np.testing.assert_allclose(float(losses.bce_with_label_smoothing(_t(yt), _t(yp), s)),
                                   float(jax_losses.bce_with_label_smoothing(
                                       jnp.asarray(yt), jnp.asarray(yp), s)), rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", ["random", "on_threshold", "one_class", "empty_predicted"])
def test_classifier_metrics_match_jax(case):
    """acc, precision, recall from equal counts, the AUC by the same rank
    statistic: within 1e-6 (NaN for one class)."""
    rs = np.random.RandomState(23)
    labels = (rs.rand(64) > 0.5).astype(np.float32)
    probs = rs.rand(64).astype(np.float32)
    if case == "on_threshold":
        probs[::4] = 0.5
    elif case == "one_class":
        labels[:] = 1.0
    elif case == "empty_predicted":
        probs *= 0.4
    got = metrics.classifier_metrics(_t(labels), _t(probs))
    want = jax_metrics.classifier_metrics(jnp.asarray(labels), jnp.asarray(probs))
    assert list(got) == list(want) == ["acc", "auc", "precision", "recall"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    assert math.isnan(float(got["auc"])) == (case == "one_class")
