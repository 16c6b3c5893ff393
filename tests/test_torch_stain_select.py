"""Stain-reference selection and validation on the CPU: the port's
``data/stain_select.py`` and ``adipose-torch select-stain-reference`` /
``validate-stain`` against the JAX package's, on seeded RGB candidate tiles
of 128^2 (uint8, with pink and golden hues and bright round blobs). One
JAX CLI run of each subcommand is shared by the tests. Every bound is
stated beside its test.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.data import stain_select as jax_ss
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.data import stain_select as ss

# The device metrics (LAB moments, the Laplacian variance) are float32
# reductions in another order than XLA's: measured over 44 seeded tiles up
# to 3.2e-6 relative (the Laplacian variance), 3.8e-7 for the LAB statistics
# and the separation score. The host metrics are the same numpy and cv2 calls on the same
# pixels: equal.
METRIC_RTOL = 1e-5
# The composite is a weighted sum of capped ratios of those metrics:
# measured up to 3e-8 apart.
COMPOSITE_ATOL = 1e-6
# Reinhard rounds its float result to uint8 by truncation, so a ~1e-6 gap
# moves a pixel on a level boundary by one level; the validation ratios of
# the normalized tile then move by the sharpness or entropy of those pixels:
# measured over 30 seeded samples up to 1.3e-4 relative (the sharpness
# ratio), and no verdict changed.
VALIDATION_RTOL = 1e-3
N_CANDIDATES, N_SAMPLES = 10, 4
HOST_KEYS = ("entropy", "local_contrast_consistency", "edge_density", "color_balance",
             "adipocyte_coverage", "structure_variety", "background_quality")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def candidate(seed: int, size: int = 128) -> np.ndarray:
    """A seeded RGB uint8 tile: a tinted smooth texture, noise and bright
    round blobs (adipocyte-like)."""
    rs = np.random.RandomState(seed)
    coarse = cv2.resize(rs.rand(size // 16 + 2, size // 16 + 2, 3).astype(np.float32),
                        (size, size), interpolation=cv2.INTER_CUBIC)
    base = np.array([200, 150, 120], np.float32) * (0.5 + rs.rand(3))
    img = base * (0.4 + 0.8 * coarse) + rs.normal(0, 4 + 12 * rs.rand(), (size, size, 3))
    for _ in range(rs.randint(2, 9)):
        cy, cx = rs.randint(0, size, 2)
        cv2.circle(img, (int(cx), int(cy)), int(rs.randint(6, 20)), (240, 235, 230), -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _flat(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Candidates and samples on disk; both CLIs' select and validate runs."""
    root = tmp_path_factory.mktemp("stain")
    cands, samples = root / "candidates", root / "samples"
    (cands / "sub").mkdir(parents=True)
    samples.mkdir()
    for i in range(N_CANDIDATES):
        where = cands / "sub" if i % 3 == 0 else cands  # rglob reaches subfolders
        cv2.imwrite(str(where / f"cand_{i:02d}.png"), cv2.cvtColor(candidate(i), cv2.COLOR_RGB2BGR))
    for i in range(N_SAMPLES):
        cv2.imwrite(str(samples / f"s{i}.jpg"),
                    cv2.cvtColor(candidate(100 + i, 96), cv2.COLOR_RGB2BGR))
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        d = root / name
        main(["select-stain-reference", "--candidate-dir", str(cands), "--output-dir", str(d),
              *extra])
        main(["validate-stain", "--metadata", str(d / "stain_reference_metadata.json"),
              "--sample-dir", str(samples), "--output-dir", str(d / "val"), *extra])
        out[name] = d
    return root, out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_analyze_candidate_matches_jax(seed):
    rgb = candidate(seed)
    want = dict(_flat(jax_ss.analyze_candidate(rgb)))
    got = dict(_flat(ss.analyze_candidate(rgb, "cpu")))
    assert want.keys() == got.keys()
    for k, v in want.items():
        if k.split(".")[0] in HOST_KEYS:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-12), k
    sj, st = jax_ss.composite_score(jax_ss.analyze_candidate(rgb)), ss.composite_score(
        ss.analyze_candidate(rgb, "cpu"))
    for k in sj:
        assert abs(st[k] - sj[k]) <= COMPOSITE_ATOL, k


def test_host_metric_functions_equal_jax():
    """The metric functions that run on the host are the same code on the
    same pixels: equal, on a tile and a constant one."""
    gray = cv2.cvtColor(candidate(7), cv2.COLOR_RGB2GRAY)
    flat = np.full((80, 80), 128, np.uint8)
    for img in (gray, flat):
        for fn in ("shannon_entropy", "local_contrast_consistency", "edge_density",
                   "adipocyte_coverage", "structure_variety", "background_quality"):
            assert getattr(ss, fn)(img) == getattr(jax_ss, fn)(img), fn
    assert ss.QUALITY_THRESHOLDS == jax_ss.QUALITY_THRESHOLDS
    m = jax_ss.analyze_candidate(candidate(3))
    assert ss.composite_score(m) == jax_ss.composite_score(m)


def test_validate_normalization_equals_jax():
    src, norm = candidate(11), candidate(12)
    assert ss.validate_normalization(src, norm) == jax_ss.validate_normalization(src, norm)


def test_selection_matches_jax(runs):
    """The same ranking wherever two candidates' JAX scores differ by more
    than twice the composite bound, the same selected reference and
    metadata (the timestamp aside), the same report."""
    root, out = runs
    port = {r["name"]: r["scores"]["composite_score"]
            for r in ss.rank_candidates(root / "candidates", device="cpu")}
    want = json.loads((out["jax"] / "stain_reference_metadata.json").read_text())
    got = json.loads((out["torch"] / "stain_reference_metadata.json").read_text())
    assert want.pop("selection_timestamp") and got.pop("selection_timestamp")
    assert got["n_candidates"] == want["n_candidates"] == N_CANDIDATES
    assert {k: v for k, v in got["selected_reference"].items() if k != "path"} == pytest.approx(
        {k: v for k, v in want["selected_reference"].items() if k != "path"},
        abs=COMPOSITE_ATOL)
    assert Path(got["selected_reference"]["path"]).relative_to(root / "candidates") == \
        Path(want["selected_reference"]["path"]).relative_to(root / "candidates")
    assert dict(_flat(got["lab_statistics"])) == pytest.approx(
        dict(_flat(want["lab_statistics"])), rel=METRIC_RTOL)

    def table(path):
        rows = [line.split(" | ") for line in path.read_text().splitlines() if line[:2] == "| "]
        return [(r[1], [float(x.strip(" |")) for x in r[2:]]) for r in rows[1:]]

    jt = table(out["jax"] / "stain_reference_selection_report.md")
    tt = table(out["torch"] / "stain_reference_selection_report.md")
    assert len(jt) == len(tt) == N_CANDIDATES
    assert [n for n, _ in tt] == list(port)  # the report lists the port's ranking
    # rounded to three places, the scores are the same
    assert dict(tt) == dict(jt)


def test_ranking_matches_jax(runs):
    """Every candidate's composite within the bound of JAX's, and the same
    order for every pair whose JAX scores differ by more than twice the
    bound (the data has no pair inside that margin: asserted, and the
    closest gap printed)."""
    root, _ = runs
    files = sorted((root / "candidates").rglob("*.png"))
    want = {f.name: jax_ss.composite_score(jax_ss.analyze_candidate(
        cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)))["composite_score"] for f in files}
    got = {r["name"]: r["scores"]["composite_score"]
           for r in ss.rank_candidates(root / "candidates", device="cpu")}
    assert max(abs(got[k] - v) for k, v in want.items()) <= COMPOSITE_ATOL
    order = sorted(want, key=lambda k: -want[k])
    gaps = [want[a] - want[b] for a, b in zip(order, order[1:])]
    print(f"closest JAX composite gap between neighbours: {min(gaps):.3e}")
    assert min(gaps) > 2 * COMPOSITE_ATOL
    assert list(got) == order


def test_validation_matches_jax(runs):
    _, out = runs
    want = json.loads((out["jax"] / "val" / "stain_validation_report.json").read_text())
    got = json.loads((out["torch"] / "val" / "stain_validation_report.json").read_text())
    assert (got["n_samples"], got["n_valid"]) == (want["n_samples"], want["n_valid"]) == \
        (N_SAMPLES, want["n_valid"])
    for g, w in zip(got["samples"], want["samples"], strict=True):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, (bool, str)):
                assert g[k] == v, (w["file"], k)
            else:
                assert g[k] == pytest.approx(v, rel=VALIDATION_RTOL, abs=1e-6), (w["file"], k)


def test_validate_stain_reference_library_call(runs, tmp_path):
    """The library call at n_samples 2 reads the selected metadata and
    normalizes on the given device."""
    root, out = runs
    summary = ss.validate_stain_reference(out["torch"] / "stain_reference_metadata.json",
                                          root / "samples", tmp_path, n_samples=2, device="cpu")
    assert summary["n_samples"] == 2 and (tmp_path / "stain_validation_report.json").exists()


def test_cli_prints_what_jax_prints(runs, capsys):
    root, out = runs
    printed = {}
    for name, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main(["validate-stain", "--metadata", str(out[name] / "stain_reference_metadata.json"),
              "--sample-dir", str(root / "samples"), "--output-dir", str(root / f"v_{name}"),
              "--n-samples", "3", *extra])
        main(["select-stain-reference", "--candidate-dir", str(root / "candidates"),
              "--output-dir", str(root / f"s_{name}"), "--max-candidates", "4", *extra])
        printed[name] = capsys.readouterr().out
    j_valid, j_sel = printed["jax"].split("\n", 1)
    t_valid, t_sel = printed["torch"].split("\n", 1)
    assert t_valid == j_valid and t_valid.endswith("/3")
    jsel, tsel = json.loads(j_sel), json.loads(t_sel)
    assert tsel["name"] == jsel["name"] and tsel["stain_type"] == jsel["stain_type"]
    assert tsel["composite_score"] == pytest.approx(jsel["composite_score"], abs=COMPOSITE_ATOL)


def test_no_candidates_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        ss.select_stain_reference(tmp_path, tmp_path / "out", device="cpu")
