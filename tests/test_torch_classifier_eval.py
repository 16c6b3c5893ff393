"""Classifier evaluation on the CPU: the port's ``run_classifier_evaluation``,
calibrators, curves and ``adipose-torch eval-classifier`` / ``classify``
against the JAX package's and sklearn's, on inputs made from a seed with
numpy.

The evaluation flows share one deterministic stub predict (the quadrant
contrast of each view, so TTA changes the answer) written once in jnp and
once in torch: bit-equal without TTA, ~1e-7 apart through TTA's log and
sigmoid, which moves no rank. Every bound is stated beside its test.
"""

import csv
import json
import math
import shutil
import warnings
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as skm
from sklearn.isotonic import IsotonicRegression
from sklearn.linear_model import LogisticRegression

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.data.loader import ClassificationDataset as JaxClassificationDataset
from adipose_tpu.eval import classifier_eval as jce
from adipose_tpu.train import checkpoint as jax_ckpt
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.data.loader import ClassificationDataset
from adipose_tpu_torch.eval import classifier_eval as ce
from adipose_tpu_torch.models import inception as inc
from adipose_tpu_torch.models.convert import save_flax_npz, torch_inception_to_flax
from adipose_tpu_torch.train.checkpoint import PARAMS_NPZ

# Probabilities of the two stubs: float32 sums, log and sigmoid in two
# libraries, ~1e-7 apart; everything derived from them likewise.
STUB_ATOL = 1e-6
# Ranks are equal, so the areas are the same sums of the same fractions.
AUC_ATOL = 1e-9
# The JAX package fits the sigmoid calibrators with sklearn's default
# LogisticRegression (lbfgs, tol 1e-4, float32 features kept float32); the
# port solves the same problem to its optimum in float64. sklearn's default
# fit stops up to ~5e-4 away from the optimum on these sizes (measured over
# 10..2000 samples: 1.4e-4 .. 4.8e-4), so calibrated values are compared to
# 1e-3 and the fitted parameters to 1e-2 relative.
LOGISTIC_ATOL = 1e-3
LOGISTIC_PARAM_RTOL = 1e-2
# The fitted optimum against sklearn refit at tol 1e-10 on float64 features.
LOGISTIC_TIGHT_ATOL = 1e-8
ISOTONIC_ATOL = 1e-12
# bf16 InceptionV3 probabilities, JAX against the port: tests/test_torch_inception.py
# measured 6.2e-4 on its inputs; these unstretched tiles, 2.3e-3 (in float32,
# 3.9e-7: test_classifier_predicts_match_jax_in_float32).
BF16_ATOL = 5e-3
# The same InceptionV3 in float32: XLA's and torch's convolutions sum in
# other orders.
F32_ATOL = 1e-5
N_TILE = 16


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the stub predict and its data ----------------------------------------------


def _squash(z):
    """A sigmoid-like map onto (0, 1) from exactly rounded operations only."""
    return 0.5 + z / (2.0 + 2.0 * abs(z))


def _jax_stub(v, images):
    """(N, H, W) tiles -> squash(scale * (top-left quadrant mean - tile mean)
    + (mean of the top row's left half - 90) / 50 + bias): not D4-invariant,
    and its mean over the D4 views still depends on the tile (the views' top
    rows are the tile's eight edge halves). Sums of uint8 values and
    divisions by powers of two are exact, so the two stubs agree bit for
    bit; TTA's log and sigmoid then differ by float32 rounding."""
    x = images.astype(jnp.float32)
    h = x.shape[1] // 2
    d = x[:, :h, :h].mean((1, 2)) - x.mean((1, 2))
    e = (x[:, 0, :h].mean(1) - 90.0) / 50.0
    return _squash(d * v["scale"] + e + v["bias"])


def _torch_stub(v, images):
    x = images.to(torch.float32)
    h = x.shape[1] // 2
    d = x[:, :h, :h].mean((1, 2)) - x.mean((1, 2))
    e = (x[:, 0, :h].mean(1) - 90.0) / 50.0
    return _squash(d * v["scale"] + e + v["bias"])


SNAPSHOTS = ({"scale": 0.05, "bias": 0.1}, {"scale": 0.03, "bias": -0.2})


def _write_split(root: Path, n_per_class: int, seed: int) -> Path:
    """``{adipose,not_adipose}/*.jpg``: noisy 16^2 tiles with a bright
    quadrant (adipose: mostly the top-left) and a bright top row (adipose:
    brighter), so the classes overlap; four slides."""
    rs = np.random.RandomState(seed)
    for cls, p_tl in (("adipose", 0.7), ("not_adipose", 0.35)):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n_per_class):
            img = rs.randint(40, 140, (N_TILE, N_TILE)).astype(np.float32)
            k = 0 if rs.rand() < p_tl else rs.randint(1, 4)
            img = np.rot90(img, k).copy()
            img[:N_TILE // 2, :N_TILE // 2] += 60 + 40 * rs.rand()
            img = np.rot90(img, -k)
            img[0] += (30 if cls == "adipose" else 10) + 40 * rs.rand()
            cv2.imwrite(str(d / f"s{i % 4}_r{i}_c0.jpg"), np.clip(img, 0, 255).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls_eval")
    return _write_split(root / "test", 24, 0), _write_split(root / "val", 16, 1)


def _walk(got, want, atol, path="", counts=True) -> None:
    """Equal structure and keys; strings equal, ints equal unless not
    ``counts``; floats within ``atol`` (NaN equal to NaN)."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _walk(got[k], want[k], atol, f"{path}/{k}", counts)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _walk(g, w, atol, f"{path}[{i}]", counts)
    elif isinstance(want, int) and not counts:
        pass
    elif isinstance(want, float):
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= atol, \
            f"{path}: {got} vs {want}"
    else:
        assert got == want, path


def _read_csv(path: Path) -> list[dict]:
    with path.open(newline="") as f:
        return list(csv.DictReader(f))


FLOWS = {  # name: (kwargs, calibration set, snapshots, tolerance)
    "full_tta": ({}, False, 1, STUB_ATOL),
    "basic_tta_two_snapshots": ({"tta_mode": "basic"}, False, 2, STUB_ATOL),
    # isotonic interpolation can scale a 1e-7 input gap by its steepest
    # segment, so its flows take the bit-equal inputs of the plain stubs
    "isotonic_split_two_snapshots": ({"use_tta": False, "calibration": "isotonic"}, False,
                                     2, STUB_ATOL),
    "isotonic_external": ({"use_tta": False, "calibration": "isotonic"}, True, 1,
                          STUB_ATOL),
    "temperature_split": ({"calibration": "temperature"}, False, 1, LOGISTIC_ATOL),
    "platt_split": ({"calibration": "platt", "calibration_split": 0.4}, False, 1,
                    LOGISTIC_ATOL),
    "platt_external_two_snapshots": ({"calibration": "platt"}, True, 2, LOGISTIC_ATOL),
    "temperature_external": ({"calibration": "temperature", "plots": False}, True, 1,
                             LOGISTIC_ATOL),
    "slide_map_examples": ({"use_tta": False, "slide_map": "map", "num_examples": 3,
                            "percentile_norm_examples": True}, False, 1, STUB_ATOL),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_run_classifier_evaluation_matches_jax(splits, tmp_path, flow):
    """The same artifact tree; predictions.csv with the same files and
    labels in the same order and probabilities within the flow's bound
    (STUB_ATOL, or LOGISTIC_ATOL for the sigmoid calibrators); the port's
    metrics equal to the JAX package's ``evaluate_predictions`` of those
    probabilities (AUCs to AUC_ATOL); against JAX's metrics.json the same
    keys, the AUCs within AUC_ATOL (the calibrators are monotone), every
    other value within the bound, and, in the STUB_ATOL flows, the same
    counts, best threshold and example counts."""
    test_dir, val_dir = splits
    kw, external, n_snap, atol = FLOWS[flow]
    kw = dict(kw)
    if kw.get("slide_map") == "map":
        stems = sorted(p.stem for p in test_dir.rglob("*.jpg"))
        kw["slide_map"] = {s: f"slide{i % 3}" for i, s in enumerate(stems) if i % 5}
    for side, ds_cls, stub, run in (("jax", JaxClassificationDataset, _jax_stub,
                                     jce.run_classifier_evaluation),
                                    ("torch", ClassificationDataset, _torch_stub,
                                     ce.run_classifier_evaluation)):
        extra = {"device": "cpu"} if side == "torch" else {}
        cal = ds_cls(val_dir, 8) if external else None
        run(stub, list(SNAPSHOTS[:n_snap]), ds_cls(test_dir, 8), tmp_path / side,
            calibration_dataset=cal, **kw, **extra)
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    got = json.loads((tmp_path / "torch" / "metrics.json").read_text())
    rows_g, rows_w = (_read_csv(tmp_path / s / "predictions.csv") for s in ("torch", "jax"))
    assert [(r["file"], r["label"]) for r in rows_g] == [(r["file"], r["label"]) for r in rows_w]
    pg = np.array([float(r["probability"]) for r in rows_g])
    np.testing.assert_allclose(pg, [float(r["probability"]) for r in rows_w], rtol=0, atol=atol)
    # the port's metrics are the JAX package's functions of its own written
    # probabilities (the CSV keeps each one exactly)
    labels = np.array([float(r["label"]) for r in rows_g])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        recomputed = jce.evaluate_predictions(labels, pg)
    _walk({k: got[k] for k in recomputed}, recomputed, AUC_ATOL)
    for k in ("roc_auc", "pr_auc"):
        assert abs(got[k] - want[k]) <= AUC_ATOL, k
        assert math.isfinite(got[k])
    # the sigmoid calibrators' gap can move a probability across a threshold
    exact = atol == STUB_ATOL
    if exact:
        assert got["best_threshold"] == want["best_threshold"]
        assert got.get("example_counts") == want.get("example_counts")
    cal_got, cal_want = got.pop("calibration"), want.pop("calibration")
    _walk(got, want, atol, counts=exact)
    if cal_want is not None:
        assert cal_got["method"] == cal_want["method"]
        for k in ("val_calibrated_auc", "val_calibrated_pr_auc"):
            if k in cal_want:
                assert abs(cal_got[k] - cal_want[k]) <= AUC_ATOL, k
        info_g, info_w = cal_got["info"], cal_want["info"]
        assert list(info_g) == list(info_w)
        if "coef" in info_w:
            np.testing.assert_allclose(info_g["coef"] + [info_g["intercept"]],
                                       info_w["coef"] + [info_w["intercept"]],
                                       rtol=LOGISTIC_PARAM_RTOL)
        else:
            _walk(info_g, info_w, atol)
    tree = lambda d: sorted(p.relative_to(d) for p in d.rglob("*"))  # noqa: E731
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")


def test_predict_with_tta_matches_jax(splits):
    """Trimmed to the dataset's length (the last batch padded); within STUB_ATOL."""
    test_dir, _ = splits
    for mode in ("basic", "full"):
        p, lab = ce.predict_with_tta(_torch_stub, SNAPSHOTS[0], ClassificationDataset(test_dir, 5),
                                     mode, device="cpu")
        jp, jlab = jce.predict_with_tta(_jax_stub, SNAPSHOTS[0],
                                        JaxClassificationDataset(test_dir, 5), mode)
        assert p.shape == jp.shape == (48,) and p.dtype == np.float32
        assert np.array_equal(lab, jlab)
        np.testing.assert_allclose(p, jp, rtol=0, atol=STUB_ATOL)


def test_ensemble_and_logit_match_jax():
    rs = np.random.RandomState(3)
    ps = [rs.rand(20).astype(np.float32) for _ in range(3)]
    ps[0][:2] = (0.0, 1.0)
    assert np.array_equal(ce.ensemble_snapshots(ps), jce.ensemble_snapshots(ps))
    assert np.array_equal(ce._to_logit(ps[1]), jce._to_logit(ps[1]))


# ---- calibrators against sklearn ------------------------------------------------


def _cal_inputs(n: int, seed: int, dtype, ties: bool):
    rs = np.random.RandomState(seed)
    labels = (rs.rand(n) > 0.45).astype(np.float32)
    labels[:2] = (0.0, 1.0)
    probs = labels * 0.3 + rs.rand(n) * 0.7
    if ties:
        probs = np.round(probs * 20) / 20
    return np.clip(probs, 0.001, 0.999).astype(dtype), labels


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,ties", [(7, False), (60, True), (300, False), (300, True)])
def test_isotonic_matches_sklearn(dtype, n, ties):
    """Ties pooled by mean, interior points trimmed, linear interpolation
    clipped to the fitted range, in the input's dtype: within ISOTONIC_ATOL
    at the fitted points, between them and outside the range."""
    probs, labels = _cal_inputs(n, n, dtype, ties)
    query = np.concatenate([probs, np.linspace(-0.5, 1.5, 41), [0.0, 1.0]]).astype(dtype)
    want = IsotonicRegression(out_of_bounds="clip").fit(probs, labels)
    cal = ce.Calibrator("isotonic", probs, labels)
    got = cal(query)
    assert got.dtype == want.transform(query).dtype == dtype
    np.testing.assert_allclose(got, want.transform(query), rtol=0, atol=ISOTONIC_ATOL)
    fitted = want.transform(probs)
    assert cal.info == {"y_min": float(fitted.min()), "y_max": float(fitted.max())}


@pytest.mark.parametrize("method", ["temperature", "platt"])
@pytest.mark.parametrize("n", [20, 200])
def test_logistic_matches_sklearn(method, n):
    """sklearn's problem (L2, C = 1, the intercept free) at its optimum:
    within LOGISTIC_TIGHT_ATOL of sklearn refit at tol 1e-10 on float64
    features; within LOGISTIC_ATOL of the default fit the JAX package makes
    on float32 features; ``info`` in sklearn's shape."""
    feat = ce.Calibrator._FEATURES[method]
    for dtype, tol, atol in ((np.float64, 1e-10, LOGISTIC_TIGHT_ATOL),
                             (np.float32, 1e-4, LOGISTIC_ATOL)):
        probs, labels = _cal_inputs(n, n + 1, dtype, False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = LogisticRegression(tol=tol, max_iter=10000).fit(feat(probs)[:, None], labels)
        cal = ce.Calibrator(method, probs, labels)
        query = np.linspace(0.01, 0.99, 50).astype(dtype)
        np.testing.assert_allclose(cal(query), want.predict_proba(feat(query)[:, None])[:, 1],
                                   rtol=0, atol=atol)
        assert np.shape(cal.info["coef"]) == (1, 1) and np.shape(cal.info["intercept"]) == (1,)
    jax_cal = jce.fit_calibrator(probs, labels, method)
    np.testing.assert_allclose(ce.apply_calibrator(probs, cal),
                               jce.apply_calibrator(probs, jax_cal), rtol=0, atol=LOGISTIC_ATOL)
    assert ce.apply_calibrator(probs, None) is probs
    with pytest.raises(ValueError):
        ce.Calibrator(method, probs, np.ones_like(labels))
    with pytest.raises(ValueError):
        ce.Calibrator("beta", probs, labels)


def test_temperature_calibration_on_a_zero_probability_raises_as_jax(splits, tmp_path):
    """A probability of exactly 0 has the logit -inf: the port's fit raises
    the ValueError that sklearn's input check raises in the JAX package,
    on its own and through one-snapshot ``eval-classifier`` flows (no
    ensemble clip there), instead of returning NaN probabilities."""
    probs, labels = _cal_inputs(200, 5, np.float32, False)
    probs[7] = 0.0
    with pytest.raises(ValueError):
        jce.fit_calibrator(probs, labels, "temperature")
    with pytest.raises(ValueError):
        ce.Calibrator("temperature", probs, labels)
    cal = ce.Calibrator("platt", probs, labels)  # the feature is p itself: finite
    assert np.isfinite(cal(probs)).all()
    test_dir, val_dir = splits
    floor = lambda p: p * (p > 0.45)  # noqa: E731  (exact zeros, both libraries)
    for side, ds_cls, stub, run in (("jax", JaxClassificationDataset, _jax_stub,
                                     jce.run_classifier_evaluation),
                                    ("torch", ClassificationDataset, _torch_stub,
                                     ce.run_classifier_evaluation)):
        extra = {"device": "cpu"} if side == "torch" else {}
        for external in (False, True):
            cal_ds = ds_cls(val_dir, 8) if external else None
            with pytest.raises(ValueError):
                run(lambda v, x, stub=stub: floor(stub(v, x)), [SNAPSHOTS[0]],
                    ds_cls(test_dir, 8), tmp_path / side, use_tta=False,
                    calibration="temperature", calibration_dataset=cal_ds, plots=False,
                    save_examples=False, **extra)


# ---- curves, scores, sweeps -------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "float64", "two_points"])
def test_curves_and_scores_match_sklearn(case):
    """``roc_curve`` (drop_intermediate) and ``precision_recall_curve``
    points equal to sklearn's; the AUCs within AUC_ATOL (NaN with one class)."""
    rs = np.random.RandomState(4)
    labels = (rs.rand(120) > 0.5).astype(np.float32)
    probs = rs.rand(120).astype(np.float32)
    if case == "ties":
        probs = np.round(probs * 6) / 6
    elif case == "one_class":
        labels[:] = 0.0
    elif case == "float64":
        probs = probs.astype(np.float64) + labels * 0.2
    elif case == "two_points":
        labels, probs = labels[:2], probs[:2]
        labels[:] = (0.0, 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for got, want in ((ce.roc_curve(labels, probs), skm.roc_curve(labels, probs)),
                          (ce.precision_recall_curve(labels, probs),
                           skm.precision_recall_curve(labels, probs))):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        want_auc = skm.roc_auc_score(labels, probs)
        got_auc = ce.roc_auc_score(labels, probs)
        want_ap = skm.average_precision_score(labels, probs)
        got_ap = ce.average_precision_score(labels, probs)
    if case == "one_class":
        assert math.isnan(got_auc) and math.isnan(want_auc)
    else:
        assert abs(got_auc - want_auc) <= AUC_ATOL
    assert abs(got_ap - want_ap) <= AUC_ATOL


def test_predictions_statistics_and_slides_equal_jax(tmp_path):
    """Host numpy copied from the JAX package: equal."""
    rs = np.random.RandomState(5)
    labels = (rs.rand(80) > 0.5).astype(np.float32)
    probs = np.clip(labels * 0.4 + rs.rand(80) * 0.6, 0, 1).astype(np.float32)
    probs[:3] = (0.5, 0.25, 0.95)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jce.evaluate_predictions(labels, probs)
    got = ce.evaluate_predictions(labels, probs)
    _walk(got, want, AUC_ATOL)
    assert ce.compute_class_statistics(labels, probs) == \
        jce.compute_class_statistics(labels, probs)
    files = [f"d/s{i % 3}_r{i}_c0.jpg" for i in range(80)]
    assert ce.aggregate_by_slide(files, labels, probs) == \
        jce.aggregate_by_slide(files, labels, probs)
    smap = {f"s{i % 3}_r{i}_c0": f"m{i % 2}" for i in range(0, 80, 3)}
    assert ce.aggregate_by_slide(files, labels, probs, smap) == \
        jce.aggregate_by_slide(files, labels, probs, smap)


def test_plots_are_written(tmp_path):
    """The JAX package's four file names, readable PNGs; also with one class."""
    rs = np.random.RandomState(6)
    labels = (rs.rand(50) > 0.5).astype(np.float32)
    probs = rs.rand(50).astype(np.float32)
    for d, lab in ((tmp_path / "a", labels), (tmp_path / "b", np.zeros_like(labels))):
        d.mkdir()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ce.save_plots(lab, probs, d)
        for name in ("roc_curve.png", "pr_curve.png", "calibration.png",
                     "probability_histogram.png"):
            img = cv2.imread(str(d / name))
            assert img is not None and img.shape == (576, 768, 3) and img.std() > 0, name


# ---- the CLIs against the JAX CLIs --------------------------------------------------


@pytest.fixture(scope="module")
def classifier_run(tmp_path_factory):
    """The port's seeded full-width InceptionV3 as a JAX run dir (orbax) with
    params.npz, and a 3 + 3 tile test split of 40^2 tiles."""
    root = tmp_path_factory.mktemp("cls_cli")
    tree = torch_inception_to_flax(inc.InceptionV3Classifier().init_params(
        torch.Generator().manual_seed(0)).state_dict())
    run = root / "run"
    jax_ckpt.save_params(run, "weights_best", tree)
    save_flax_npz(tree, run / "weights_best" / PARAMS_NPZ)
    rs = np.random.RandomState(0)
    for cls, base in (("adipose", 170), ("not_adipose", 90)):
        d = root / "data" / "test" / cls
        d.mkdir(parents=True)
        for i in range(3):
            img = base + rs.randint(-60, 60, (40, 40)) + np.arange(40)[None] * i
            cv2.imwrite(str(d / f"s{i % 2}_r{i}_c0.jpg"), np.clip(img, 0, 255).astype(np.uint8))
    return run, root / "data"


def _auc_band(labels: np.ndarray, probs: np.ndarray, band: float) -> float:
    """The most the ROC AUC can move when each probability moves by at most
    ``band`` / 2: the share of (positive, negative) pairs within ``band``."""
    pos, neg = probs[labels == 1], probs[labels == 0]
    return float((np.abs(pos[:, None] - neg[None, :]) <= band).mean())


def test_eval_classifier_cli_matches_jax_cli(classifier_run, tmp_path):
    """``adipose-torch eval-classifier --device cpu`` against ``adipose
    eval-classifier`` (both bf16, basic TTA at batch 2, plots and examples):
    the same file tree and printed keys, predictions.csv with the same files
    and labels and probabilities within BF16_ATOL; the ROC AUC within the
    share of pairs whose probabilities sit within 2 * BF16_ATOL."""
    run, data = classifier_run
    flags = ["eval-classifier", "--weights", str(run), "--dataset-root", str(data),
             "--batch-size", "2", "--tta", "basic", "--num-examples", "2"]
    jax_main(flags)
    out = run / "evaluation" / "test_tta_basic"
    shutil.move(out, tmp_path / "jax")
    torch_main(flags + ["--device", "cpu"])
    shutil.move(out, tmp_path / "torch")
    tree = lambda d: sorted(p.relative_to(d) for p in d.rglob("*"))  # noqa: E731
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    assert len(tree(tmp_path / "torch")) >= 9
    rows_g, rows_w = (_read_csv(tmp_path / s / "predictions.csv") for s in ("torch", "jax"))
    assert [(r["file"], r["label"]) for r in rows_g] == [(r["file"], r["label"]) for r in rows_w]
    pg = np.array([float(r["probability"]) for r in rows_g])
    pw = np.array([float(r["probability"]) for r in rows_w])
    np.testing.assert_allclose(pg, pw, rtol=0, atol=BF16_ATOL)
    got, want = (json.loads((tmp_path / s / "metrics.json").read_text())
                 for s in ("torch", "jax"))
    assert list(got) == list(want)
    labels = np.array([int(r["label"]) for r in rows_w])
    assert abs(got["roc_auc"] - want["roc_auc"]) <= _auc_band(labels, pw, 2 * BF16_ATOL)


def test_classify_cli_matches_jax_cli(classifier_run, tmp_path):
    """``adipose-torch classify --device cpu`` against ``adipose classify``
    at its defaults (grayscale, no stretch, no TTA) and batch 4, so the
    last chunk is padded: the same CSV name, columns and rows in order,
    probabilities within BF16_ATOL, a binary call that differs only within
    BF16_ATOL of the threshold; with --use-tta --tta-mode basic
    --percentile-norm the CSV name gains _tta."""
    run, data = classifier_run
    flags = ["classify", "--weights", str(run), "--input-dir", str(data / "test"),
             "--batch-size", "4", "--save-visualizations", "--threshold", "0.33"]
    jax_main(flags + ["--output-dir", str(tmp_path / "jax")])
    torch_main(flags + ["--output-dir", str(tmp_path / "torch"), "--device", "cpu"])
    names = lambda d: sorted(p.name for p in d.iterdir())  # noqa: E731
    assert names(tmp_path / "torch") == names(tmp_path / "jax") == \
        ["predictions_grayscale.csv", "visualizations"]
    rows_g, rows_w = (_read_csv(tmp_path / s / "predictions_grayscale.csv")
                      for s in ("torch", "jax"))
    assert list(rows_g[0]) == list(rows_w[0]) == ["image_path", "adipose_probability",
                                                  "binary_prediction", "is_adipose"]
    assert [r["image_path"] for r in rows_g] == [r["image_path"] for r in rows_w]
    pg = np.array([float(r["adipose_probability"]) for r in rows_g])
    pw = np.array([float(r["adipose_probability"]) for r in rows_w])
    np.testing.assert_allclose(pg, pw, rtol=0, atol=BF16_ATOL)
    differ = np.array([g["binary_prediction"] != w["binary_prediction"]
                       for g, w in zip(rows_g, rows_w)])
    assert np.all(np.abs(pw[differ] - 0.33) <= BF16_ATOL)
    assert all(r["is_adipose"] == ("adipose" if r["binary_prediction"] == "1" else "not_adipose")
               for r in rows_g)
    torch_main(["classify", "--weights", str(run), "--input-dir", str(data / "test"),
                "--batch-size", "4", "--use-tta", "--tta-mode", "basic", "--percentile-norm",
                "--output-dir", str(tmp_path / "tta"), "--device", "cpu", "--gpu", "0"])
    rows_t = _read_csv(tmp_path / "tta" / "predictions_grayscale_tta.csv")
    assert len(rows_t) == 6 and all(0 <= float(r["adipose_probability"]) <= 1 for r in rows_t)


def test_classifier_predicts_match_jax_in_float32(classifier_run):
    """The gap of the CLI tests (BF16_ATOL, measured 2.3e-3) is bf16 noise:
    the predicts behind ``classify`` (no stretch, no TTA) and
    ``eval-classifier`` (basic TTA) agree with the JAX package's within
    F32_ATOL in float32 on the same decoded tiles (measured 3.9e-7 and
    1.2e-7)."""
    import jax

    from adipose_tpu.eval.tta import make_classifier_tta_predict as jax_tta
    from adipose_tpu.models.inception import InceptionV3Classifier as JaxInception
    from adipose_tpu.train.trainer_classifier import _make_val_step as jax_val_step
    from adipose_tpu_torch.eval.evaluator import read_image_gray
    from adipose_tpu_torch.eval.tta import make_classifier_tta_predict
    from adipose_tpu_torch.models.convert import flax_inception_to_torch
    from adipose_tpu_torch.train.trainer_classifier import _make_val_step

    run, data = classifier_run
    tree = jax_ckpt.load_params(run / "weights_best")
    x = np.stack([read_image_gray(str(p)) for p in sorted((data / "test").rglob("*.jpg"))])
    jstep = jax_val_step(JaxInception(dtype=jnp.float32), False, 1.0, 99.0)

    def jax_predict(v, images):
        return jstep(v["params"], v["batch_stats"], images)

    step = _make_val_step(inc.InceptionV3Classifier(compute_dtype=torch.float32, device="meta"),
                          False, 1.0, 99.0)
    state = flax_inception_to_torch(jax.tree.map(np.asarray, tree))
    for jp, tp in ((jax_predict, step), (jax_tta(jax_predict, "basic"),
                                        make_classifier_tta_predict(step, "basic"))):
        np.testing.assert_allclose(tp(state, torch.from_numpy(x)).numpy(),
                                   np.asarray(jp(tree, jnp.asarray(x))), rtol=0, atol=F32_ATOL)


def test_classify_refuses_what_is_not_ported(classifier_run):
    """classify without a model, with the JAX CLI's message (``--bundle`` is
    served: tests/test_torch_export.py)."""
    run, data = classifier_run
    with pytest.raises(SystemExit, match="classify requires --weights or --bundle"):
        torch_main(["classify", "--input-dir", str(data), "--device", "cpu"])
