"""The dataset analyses on the CPU: the port's ``data/analysis.py`` and
``adipose-torch analyze-tiles`` (every mode) / ``visualize-preprocessing``
against the JAX package's, on a seeded ``dataset/{train,val,test}/images``
tree of RGB JPEG tiles of 96 x 128 (and one 64 x 80 tile), seeded ellipse
masks of 128^2 and seeded adipocyte reference tiles. One JAX CLI run of
each mode is shared by the tests; its matplotlib figures are built but not
laid out or saved (``Figure.tight_layout`` and ``savefig`` are no-ops there),
since only its tables and reports are compared and matplotlib's text layout
is most of its time. Every bound is stated beside its test.
"""

import contextlib
import csv
import importlib.util
import io
import json
import math
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.data import analysis as jax_an
from adipose_tpu.ops.clahe import adaptive_clahe_normalize as jax_adaptive
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.data import analysis as an

# Device scalars: float32 means, variances and the Laplacian variance summed
# in other orders than XLA's: measured over 20 seeded tiles up to 1.4e-6
# relative (the port's moments are float64, rounded once).
IQM_RTOL = 1e-5
# The 15 x 15 local-contrast field: the JAX package's float32 cumulative sums
# of x^2 round (they reach ~2^22 on these tiles, ~6.7e7 on a 1024^2 one);
# the port's float64 sums are exact. Measured up to 2.9e-5 relative on
# avg_local_contrast and 9.7e-5 on local_contrast_variation (its
# denominator), 6.2e-5 on local_contrast_consistency (1 / the spread of the
# field); on a 1024^2 tile 1.6e-6 and 2.3e-6.
LOCAL_RTOL = 5e-4
# A uint8 result truncates a float one: a 1e-5 gap at a level boundary moves
# a pixel by one level. Measured: CLAHE 1 level in 8.1e-5 of the pixels over
# 20 seeded tiles, the FFT deband 1 level in a few pixels of a tile.
VARIANT_LEVELS, VARIANT_SHARE = 1, 1e-3
# Metrics of a uint8 variant or comparison panel: the sharpness is a
# Laplacian variance of the pixels, so one moved pixel moves it by ~1e-4
# relative on these tiles; the CLAHE stages themselves are ~3 ulps from
# JAX's (tests/test_torch_ecm.py) and the percentile stretch divides them.
PANEL_RTOL, PANEL_ATOL = 2e-3, 1e-6
TILE = (96, 128)
SPLITS = {"train": 4, "val": 3, "test": 3}
N_ADIPO, N_MASKS = 3, 4
VIS_SAMPLES = 2


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rgb_tile(rs: np.random.RandomState, h: int = TILE[0], w: int = TILE[1]) -> np.ndarray:
    """A seeded RGB uint8 tile: a tinted smooth texture, noise and bright
    round blobs."""
    coarse = cv2.resize(rs.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    base = np.array([150, 170, 200], np.float32) * rs.uniform(0.4, 1.1)
    img = base * (0.5 + 0.7 * coarse * rs.uniform(0.3, 1.0)) + rs.normal(0, 6, (h, w, 3))
    for _ in range(rs.randint(2, 6)):
        cy, cx = rs.randint(0, h), rs.randint(0, w)
        cv2.circle(img, (int(cx), int(cy)), int(rs.randint(5, 15)), (235, 230, 240), -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def gray_tile(seed: int) -> np.ndarray:
    return cv2.cvtColor(rgb_tile(np.random.RandomState(seed)), cv2.COLOR_RGB2GRAY)


@contextlib.contextmanager
def unsaved_matplotlib():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.figure as mf

    saved = mf.Figure.savefig, mf.Figure.tight_layout
    mf.Figure.savefig = mf.Figure.tight_layout = lambda self, *a, **k: None
    try:
        yield
    finally:
        mf.Figure.savefig, mf.Figure.tight_layout = saved


MODES = {"census": ["--census"], "compare_preprocessing": ["--compare-preprocessing"],
         "contrast_groups": ["--contrast-groups"],
         # a flat tile folder: one sample per mode, named by its file stem
         "compare_normalization": ["--compare-normalization", "all", "--n-per-split", "1"],
         "comprehensive": ["--comprehensive-normalization", "--adipocyte-dir", "{adipo}"],
         "morphology": ["--morphology"], "visualize": []}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The seeded trees and both CLIs' run of each mode: {mode: (JAX out
    dir, its stdout, port out dir, its stdout)}."""
    root = tmp_path_factory.mktemp("analysis")
    rs = np.random.RandomState(865)
    for split, n in SPLITS.items():
        d = root / "dataset" / split / "images"
        d.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(d / f"{split}_t{i}.jpg"), rgb_tile(rs))
    cv2.imwrite(str(root / "dataset" / "train" / "images" / "odd.jpg"), rgb_tile(rs, 64, 80))
    (root / "flat").mkdir()
    for i in range(2):
        cv2.imwrite(str(root / "flat" / f"flat_t{i}.jpg"), rgb_tile(rs))
    (root / "adipo").mkdir()
    for i in range(N_ADIPO):
        cv2.imwrite(str(root / "adipo" / f"a{i}.png"), rgb_tile(rs))
    (root / "masks").mkdir()
    for i in range(N_MASKS):
        m = np.zeros((128, 128), np.uint8)
        for _ in range(rs.randint(3, 8)):
            cv2.ellipse(m, (int(rs.randint(10, 118)), int(rs.randint(10, 118))),
                        (int(rs.randint(4, 14)), int(rs.randint(3, 10))),
                        float(rs.randint(0, 180)), 0, 360, 255, -1)
        cv2.imwrite(str(root / "masks" / f"m{i}.png"), m)
    out = {}
    for mode, flags in MODES.items():
        flags = [f.format(adipo=root / "adipo") for f in flags]
        res = []
        for name, main, extra in (("jax", jax_main, []),
                                  ("torch", torch_main, ["--device", "cpu"])):
            dst = root / name / mode
            if mode == "visualize":
                argv = ["visualize-preprocessing", "--tiles-dir",
                        str(root / "dataset" / "train" / "images"), "--output-dir", str(dst),
                        "--n-samples", str(VIS_SAMPLES)]
            else:
                tiles = root / {"morphology": "masks", "compare_normalization": "flat"}.get(
                    mode, "dataset")
                argv = ["analyze-tiles", "--tiles-dir", str(tiles), "--output-dir", str(dst),
                        *flags]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    (unsaved_matplotlib() if name == "jax" else contextlib.nullcontext()):
                main(argv + extra)
            res += [dst, buf.getvalue()]
        out[mode] = tuple(res)
    return root, out


def read_rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _num(v: str):
    try:
        return float(v)
    except ValueError:
        return v


def assert_tables_close(got_path, want_path, exact=(), rtol=IQM_RTOL, atol=0.0, rtols=None):
    """Same header and rows; text cells equal; the ``exact`` columns equal as
    text; every other number within rtol (``rtols`` per column)."""
    got, want = read_rows(got_path), read_rows(want_path)
    assert len(got) == len(want) and got and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k, wv in w.items():
            gv, wn = _num(g[k]), _num(wv)
            if k in exact or isinstance(wn, str) or isinstance(gv, str):
                assert g[k] == wv, (k, g, w)
            elif math.isnan(wn):
                assert math.isnan(gv), (k, g, w)
            else:
                tol = (rtols or {}).get(k, rtol)
                assert gv == pytest.approx(wn, rel=tol, abs=atol), (k, g, w)


def md_numbers(path) -> tuple[list[str], list[float]]:
    """A markdown report split into its text and its numbers."""
    text = path.read_text()
    pattern = r"-?\d+\.\d+(?:e[-+]?\d+)?"
    return re.split(pattern, text), [float(x) for x in re.findall(pattern, text)]


def assert_md_close(got_path, want_path, rtol: float, atol: float):
    (gt, gn), (wt, wn) = md_numbers(got_path), md_numbers(want_path)
    assert gt == wt
    assert gn == pytest.approx(wn, rel=rtol, abs=atol)


# ---- the census --------------------------------------------------------------------


def test_census_matches_jax(runs):
    """Verdicts, white ratios and the host moments equal; the Laplacian
    variance within IQM_RTOL; the summary and what the CLI prints likewise."""
    _, out = runs
    jdir, jout, tdir, tout = out["census"]
    assert_tables_close(tdir / "census.csv", jdir / "census.csv",
                        exact=("tile", "white_ratio", "is_empty", "is_blurry", "is_good",
                               "mean", "std"))
    want = json.loads((jdir / "census_summary.json").read_text())
    got = json.loads((tdir / "census_summary.json").read_text())
    assert json.loads(tout) == got and json.loads(jout) == want
    assert got == pytest.approx(want, rel=IQM_RTOL)
    assert {k: got[k] for k in got if k.startswith("n_") or "intensity" in k} == \
        {k: want[k] for k in want if k.startswith("n_") or "intensity" in k}
    assert got["n_tiles"] == sum(SPLITS.values()) + 1


def test_census_without_a_mode_and_max_tiles(runs, tmp_path):
    root, _ = runs
    torch_main(["analyze-tiles", "--tiles-dir", str(root / "dataset"), "--output-dir",
                str(tmp_path), "--max-tiles", "3", "--device", "cpu"])
    assert len(read_rows(tmp_path / "census.csv")) == 3
    assert json.loads((tmp_path / "census_summary.json").read_text())["n_tiles"] == 3


# ---- preprocessing variants --------------------------------------------------------


@pytest.mark.parametrize("variant", an.VARIANTS)
def test_variant_matches_jax(variant):
    for seed in (0, 1, 2):
        img = gray_tile(seed)
        d = np.abs(an._apply_variant(img, variant, "cpu").astype(int)
                   - jax_an._apply_variant(img, variant).astype(int))
        assert d.max() <= VARIANT_LEVELS and (d > 0).mean() <= VARIANT_SHARE, (seed, d.max())


def test_preprocessing_comparison_matches_jax(runs):
    _, out = runs
    jdir, jout, tdir, tout = out["compare_preprocessing"]
    assert tout == jout.replace("/jax/", "/torch/")
    assert_tables_close(tdir / "preprocessing_comparison.csv",
                        jdir / "preprocessing_comparison.csv", exact=("tile", "variant"),
                        rtol=PANEL_RTOL, atol=PANEL_ATOL)
    assert_tables_close(tdir / "preprocessing_summary.csv", jdir / "preprocessing_summary.csv",
                        exact=("variant",), rtol=PANEL_RTOL, atol=PANEL_ATOL)
    assert sorted(p.name for p in tdir.glob("*_variants.jpg")) == \
        sorted(p.name for p in jdir.glob("*_variants.jpg"))


def test_pandas_semantics():
    """The row helpers against pandas itself: the groupby mean bit for bit
    (Kahan-compensated), Series mean and std, value_counts order with ties."""
    rs = np.random.RandomState(3)
    vals = list(rs.standard_normal(200) * 10 ** rs.uniform(-3, 6, 200))
    keys = list(rs.choice(["b", "a", "c"], 200))
    df = pd.DataFrame({"k": keys, "v": vals})
    want = df.groupby("k")["v"].mean()
    rows = [{"k": k, "v": v} for k, v in zip(keys, vals)]
    groups = an._groups(rows, "k")
    assert {k: an._kahan_mean(r["v"] for r in groups[k]) for k in groups} == want.to_dict()
    assert list(groups) == list(df.groupby("k", sort=False).groups)
    assert an._series_mean(vals) == df["v"].mean() and an._series_std(vals) == df["v"].std()
    labels = ["x", "y", "z", "y", "x", "w"]
    assert list(an._value_counts(labels).items()) == list(pd.Series(labels).value_counts().items())


# ---- morphology (host cv2) ---------------------------------------------------------


def test_morphology_report_equals_jax(runs):
    _, out = runs
    jdir, jout, tdir, tout = out["morphology"]
    assert (tdir / "morphology_analysis.json").read_bytes() == \
        (jdir / "morphology_analysis.json").read_bytes()
    assert tout == jout
    assert json.loads(tout)["morphological"]["morph_kernel_size"] == 3


# ---- image quality metrics and the contrast grouping -------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_quality_metrics_match_jax(seed):
    img = gray_tile(seed).astype(np.float32)
    want, got = jax_an.image_quality_metrics(img), an.image_quality_metrics(img, "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        tol = LOCAL_RTOL if k in ("avg_local_contrast", "local_contrast_variation") else IQM_RTOL
        assert got[k] == pytest.approx(v, rel=tol), k
    for k in ("dynamic_range", "entropy", "peak_prominence"):  # the histogram is jnp's
        assert got[k] == want[k], k


def test_box_mean_is_exact_and_near_jax():
    """The port's 15 x 15 box mean of x and x^2 equals the exact float64 box
    sums (cv2's unnormalized box filter, reflect-101) over 225; JAX's float32
    sums are within LOCAL_RTOL of them."""
    x = gray_tile(4).astype(np.float32)
    for a in (x, x * x):
        exact = cv2.boxFilter(a.astype(np.float64), -1, (15, 15), normalize=False,
                              borderType=cv2.BORDER_REFLECT_101) / 225.0
        got = an._box_mean(torch.from_numpy(a), 15).numpy()
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_allclose(np.asarray(jax_an._box_mean(jnp.asarray(a), 15)), exact,
                                   rtol=LOCAL_RTOL)


def test_histogram_follows_jnp():
    """jnp.histogram's rule: float32 edges, a value on an inner edge in the
    bin above it, the top edge in the last bin, out-of-range values dropped;
    on integers, unit floats and the edges themselves."""
    rs = np.random.RandomState(0)
    for hi in (255.0, 1.0):
        edges = np.linspace(0.0, hi, 257).astype(np.float32)
        # (no subnormals: XLA's CPU code flushes them to zero)
        x = np.concatenate([rs.uniform(-0.1 * hi, 1.1 * hi, 5000), edges,
                            np.nextafter(edges[1:], np.float32(-np.inf)),
                            np.arange(256.0) * hi / 255.0]).astype(np.float32)
        want = np.asarray(jnp.histogram(jnp.asarray(x), bins=256, range=(0.0, hi))[0])
        np.testing.assert_array_equal(an._histogram(torch.from_numpy(x), hi), want)


def test_contrast_groups_match_jax(runs):
    """The cutoffs within IQM_RTOL; the labels equal for every image whose
    metrics lie farther than the bound from each cutoff it is held to (none
    lies within it here: asserted); the CSV, JSON and report likewise."""
    _, out = runs
    jdir, jout, tdir, tout = out["contrast_groups"]
    want = json.loads((jdir / "adaptive_clahe_cutoffs.json").read_text())
    got = json.loads((tdir / "adaptive_clahe_cutoffs.json").read_text())
    assert dict(pd.json_normalize(got).iloc[0]) == pytest.approx(
        dict(pd.json_normalize(want).iloc[0]), rel=LOCAL_RTOL)
    rows = read_rows(jdir / "image_quality_analysis.csv")
    for r in rows:
        for metric in ("contrast_ratio", "laplacian_variance"):
            for cut in want[metric].values():
                assert abs(float(r[metric]) - cut) > 2 * IQM_RTOL * abs(cut), (r, metric)
    assert_tables_close(tdir / "image_quality_analysis.csv", jdir / "image_quality_analysis.csv",
                        exact=("split", "sample_id", "filename", "quality_group",
                               "dynamic_range", "entropy", "peak_prominence"),
                        rtols={"avg_local_contrast": LOCAL_RTOL,
                               "local_contrast_variation": LOCAL_RTOL})
    jp, tp = json.loads(jout), json.loads(tout)
    assert list(tp["groups"].items()) == list(jp["groups"].items())
    assert tp["n_images"] == jp["n_images"] == 2 * len(SPLITS)
    assert_md_close(tdir / "CONTRAST_GROUPING_ANALYSIS.md", jdir / "CONTRAST_GROUPING_ANALYSIS.md",
                    rtol=0, atol=0)
    png = cv2.imread(str(tdir / "contrast_analysis_grouping.png"))
    assert png.shape == (12 * 150, 16 * 150, 3)


def test_generated_adaptive_module_runs_like_jax(runs):
    """The generated ``adaptive_clahe_function.py`` imports the port's
    adaptive CLAHE, carries the census's cutoffs, and returns JAX's
    ``adaptive_clahe_normalize`` with those cutoffs (the same strategy;
    values within the CLAHE and percentile bounds of test_torch_ecm.py)."""
    _, out = runs
    _, _, tdir, _ = out["contrast_groups"]
    text = (tdir / "adaptive_clahe_function.py").read_text()
    assert "from adipose_tpu_torch.ops.clahe import adaptive_clahe_normalize" in text
    assert "adipose_tpu." not in text
    spec = importlib.util.spec_from_file_location("generated", tdir / "adaptive_clahe_function.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.CUTOFFS == json.loads((tdir / "adaptive_clahe_cutoffs.json").read_text())
    strategies = set()
    for seed in range(6):
        img = gray_tile(seed).astype(np.float32)
        want, strategy = jax_adaptive(img, mod.CUTOFFS)
        got = mod.adaptive_clahe_normalization(img, device="cpu")
        strategies.add(strategy)
        assert isinstance(got, np.ndarray) and got.shape == img.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)
    assert len(strategies) >= 2


# ---- the preprocessing-pipeline visualizer -----------------------------------------


def test_visualize_preprocessing_matches_jax(runs):
    """The z-score statistics equal (the same host moments over the same
    samples); both figures written, 20 x (4 n + 3) inches at 150 dpi."""
    _, out = runs
    _, jout, tdir, tout = out["visualize"]
    jp, tp = json.loads(jout), json.loads(tout)
    assert tp["stats"] == jp["stats"]
    n = VIS_SAMPLES
    for version in ("color", "grayscale"):
        png = cv2.imread(tp[version])
        assert tp[version] == str(tdir / f"preprocessing_pipeline_{version}.png")
        assert png.shape == ((4 * n + 3) * 150, 20 * 150, 3)


def test_pipeline_stage_stats_match_jax_text():
    """A stage's histogram values and its mu / sigma / range box: the JAX
    package's formulas on the stage's array."""
    rgb = rgb_tile(np.random.RandomState(9))
    flat, text = an.stage_stats(rgb.astype(np.float32))
    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32).ravel()
    np.testing.assert_array_equal(flat, gray)
    assert text == (f"μ={gray.mean():.2f}\nσ={gray.std():.2f}\n"
                    f"Range=[{gray.min():.2f}, {gray.max():.2f}]")


# ---- normalization comparisons and the comprehensive analysis ----------------------


@pytest.mark.parametrize("mode", sorted(an.NORM_COMPARISON_MODES))
def test_normalization_mode_matches_jax(runs, mode):
    """Each mode's metrics CSV within PANEL_RTOL (names and methods equal),
    its summary markdown within the same bound, its panels written under
    the JAX names, and the JSON the CLI prints."""
    _, out = runs
    jdir, jout, tdir, tout = out["compare_normalization"]
    csv_name = f"{mode.replace('-', '_')}_metrics.csv"
    assert_tables_close(tdir / csv_name, jdir / csv_name, exact=("sample", "method"),
                        rtol=PANEL_RTOL, atol=PANEL_ATOL)
    md = f"{mode.upper().replace('-', '_')}_COMPARISON_SUMMARY.md"
    assert_md_close(tdir / md, jdir / md, rtol=PANEL_RTOL, atol=0.11)  # .1f rounds by 0.1
    suffix = an._MODE_SUFFIX[mode]
    assert (tdir / f"flat_t0_{suffix}.png").exists()
    jres = json.loads("[" + jout.replace("}\n{", "},\n{") + "]")
    tres = json.loads("[" + tout.replace("}\n{", "},\n{") + "]")
    assert [r["mode"] for r in tres] == [r["mode"] for r in jres] == \
        sorted(an.NORM_COMPARISON_MODES)
    assert all(t["n_samples"] == j["n_samples"] == 1 for t, j in zip(tres, jres))


@pytest.mark.parametrize("method", list(an._COMPREHENSIVE_METHODS))
def test_comprehensive_metrics_match_jax(method):
    cl, pc = an._COMPREHENSIVE_METHODS[method]
    for seed in (0, 1):
        img = gray_tile(seed).astype(np.float32)
        arr = jax_an.apply_norm_method(img, cl, pc)
        np.testing.assert_allclose(an.apply_norm_method(img, cl, pc, "cpu"), arr, atol=2e-6)
        want, got = jax_an.comprehensive_metrics(arr, method), an.comprehensive_metrics(
            arr, method, "cpu")
        assert list(got) == list(want) and got["method"] == method
        for k, v in list(want.items())[1:]:
            tol = LOCAL_RTOL if k == "local_contrast_consistency" else IQM_RTOL
            assert got[k] == pytest.approx(v, rel=tol), (seed, k)


def test_comprehensive_analysis_matches_jax(runs):
    """The dataset metrics, the adipocyte references' metrics and the
    similarity table within the metric bounds; the report's numbers (4
    significant digits) likewise; the dashboard written; the printed JSON."""
    _, out = runs
    jdir, jout, tdir, tout = out["comprehensive"]
    local = {"local_contrast_consistency": LOCAL_RTOL}
    for name in ("dataset_normalization_metrics.csv", "adipocyte_reference_metrics.csv"):
        assert_tables_close(tdir / name, jdir / name, exact=("method", "filename", "split"),
                            rtols=local | dict.fromkeys(
                                ("laplacian_variance", "entropy", "edge_density"), PANEL_RTOL))
    assert len(read_rows(tdir / "dataset_normalization_metrics.csv")) == \
        4 * (sum(SPLITS.values()) + 1)
    # exp(-|z| / 2) of each metric's z against the references: the metric
    # gaps above, over the references' spread
    assert_tables_close(tdir / "similarity_to_adipocytes.csv",
                        jdir / "similarity_to_adipocytes.csv",
                        exact=("filename", "split", "method"), rtol=LOCAL_RTOL, atol=1e-9)
    assert_md_close(tdir / "COMPREHENSIVE_NORMALIZATION_REPORT.md",
                    jdir / "COMPREHENSIVE_NORMALIZATION_REPORT.md", rtol=1e-3, atol=0)
    png = cv2.imread(str(tdir / "comprehensive_normalization_analysis.png"))
    assert png.shape == (10 * 120, 18 * 120, 3)
    jp, tp = json.loads(jout), json.loads(tout)
    assert {k: v.replace("/torch/", "/jax/") if isinstance(v, str) else v
            for k, v in tp.items()} == jp
    assert "similarity_csv" in tp and tp["n_rows"] == 4 * (sum(SPLITS.values()) + 1)
