"""The WSI tools on the CPU: the port's ``reconstruct_all_slides``,
``SlideReconstructor``, ``classification-overlay`` and ``run-pipeline``
against the JAX package's, on seeded tiles and tests/test_torch_evaluate.py's
init_nb 4 run at 64^2. Every bound is stated beside its test.
"""

import csv
import filecmp
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.core.config import DataBuildConfig as JaxDataBuildConfig
from adipose_tpu.core.config import EvalConfig as JaxEvalConfig
from adipose_tpu.core.config import UNetConfig as JaxUNetConfig
from adipose_tpu.data.tiling import SegmentationDatasetBuilder as JaxBuilder
from adipose_tpu.eval.evaluator import PublicationEvaluator as JaxEvaluator
from adipose_tpu.wsi import overlay as jax_overlay
from adipose_tpu.wsi import reconstruct as jax_reconstruct
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import EvalConfig, UNetConfig
from adipose_tpu_torch.eval.evaluator import PublicationEvaluator
from adipose_tpu_torch.parallel.mesh import pad_batch_to
from adipose_tpu_torch.wsi import overlay, reconstruct
from test_torch_build import write_slides
from test_torch_evaluate import eval_fixture  # noqa: F401  (a module-scoped fixture)

N = 64
# The two float32 init_nb 4 U-Nets' maps differ by ~1e-6 (tests/test_torch_unet.py);
# the blends divide the same weighted sums. The grey image's blend is held in
# unit space (divided by 255), as the prediction and ground truth are.
MAP_ATOL = 1e-5
SCALES = (1.0, 1.0, 255.0)  # prediction, ground truth, image
# A written PNG truncates p * 255: a 1e-6 gap moves a pixel on a level
# boundary by one level.
PNG_LEVELS = 1
# metrics.json at a threshold that no map value lies within 1e-4 of: the same
# confusion counts, so float32 ratios of equal integers.
METRICS_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_tiles(root: Path, rs, grids: dict, stride: int) -> Path:
    """``{slide}_r{i}_c{j}.jpg`` tiles cut from one seeded image per slide,
    and masks; ``grids``: slide -> (rows, cols, missing (r, c) or None)."""
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    for slide, (rows, cols, missing) in grids.items():
        h, w = (rows - 1) * stride + N, (cols - 1) * stride + N
        img = cv2.GaussianBlur((rs.rand(h, w) * 255).astype(np.uint8), (5, 5), 0)
        mask = np.zeros((h, w), np.uint8)
        cv2.circle(mask, (w // 2, h // 2), min(h, w) // 3, 255, -1)
        img[mask > 0] = img[mask > 0] // 2 + 100
        for r in range(rows):
            for c in range(cols):
                if (r, c) == missing:
                    continue
                y, x = r * stride, c * stride
                stem = f"{slide}_r{r}_c{c}"
                cv2.imwrite(str(root / "images" / f"{stem}.jpg"), img[y:y + N, x:x + N],
                            [cv2.IMWRITE_JPEG_QUALITY, 100])
                cv2.imwrite(str(root / "masks" / f"{stem}.tif"), mask[y:y + N, x:x + N])
    return root


@pytest.fixture(scope="module")
def recon(eval_fixture, tmp_path_factory):  # noqa: F811
    """Both packages' float32 predicts of the init_nb 4 run; a tile set of
    three slides (two full 3x3 grids and a 2x3 grid with a tile missing:
    coverage 5/6, below the 0.9 gate) at stride 64 and an
    overlapping one at stride 48; a threshold in a gap of the JAX maps."""
    ckpt_dir, _ = eval_fixture
    root = tmp_path_factory.mktemp("recon")
    rs = np.random.RandomState(7)
    # wsiA and wsiB share a canvas shape, so each JAX blend compiles once
    tiles = _write_tiles(root / "s64", rs, {"wsiA": (3, 3, None), "wsiB": (3, 3, None),
                                            "wsiC": (2, 3, (1, 2))}, N)
    overlap = _write_tiles(root / "s48", rs, {"wsiD": (3, 2, None)}, 48)
    mcfg = dict(tile_size=N, init_nb=4, compute_dtype="float32")
    jev = JaxEvaluator(ckpt_dir, JaxEvalConfig(), JaxUNetConfig(**mcfg))
    tev = PublicationEvaluator(ckpt_dir, EvalConfig(), UNetConfig(**mcfg), device="cpu")
    imgs = np.stack([cv2.imread(str(p), 0) for p in sorted((tiles / "images").glob("*.jpg"))])
    vals = np.sort(np.concatenate([
        np.asarray(jev.predict(jev.params, imgs[i:i + 4].astype(np.float32))).ravel()
        for i in range(0, len(imgs) - 3, 4)]))
    gaps = np.diff(vals)
    mid = len(vals) // 2
    i = mid + int(np.argmax(gaps[mid:mid + 2000] > 1e-4 * 2))
    return {"ckpt": ckpt_dir, "tiles": tiles, "overlap": overlap,
            "jax": (jev.predict, jev.params), "torch": (tev.predict, tev.params),
            "threshold": float((vals[i] + vals[i + 1]) / 2)}


def _png(path: Path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.int32)


RECON = {
    "gaussian": {},
    "refine_linear": {"use_refinement": True, "blend_mode": "linear"},
    "max_tiles_overlays_comparisons": {"max_tiles": 2, "save_overlays": True,
                                       "save_comparisons": True, "save_masks": False},
}


@pytest.mark.parametrize("case", list(RECON))
def test_reconstruct_all_slides_matches_jax(recon, tmp_path, case):
    """The same output tree and log (coverage, shapes, the skipped slide);
    written PNGs within PNG_LEVELS (the binary masks equal: the blended
    image and ground truth divide weighted sums too); each slide's
    metrics.json and summary.csv within METRICS_ATOL."""
    kw = dict(tile_size=N, stride=N, batch_size=4, threshold=recon["threshold"], **RECON[case])
    tiles = recon["tiles"]
    want = jax_reconstruct.reconstruct_all_slides(
        tiles / "images", tiles / "masks", tmp_path / "jax" / "out", *recon["jax"], **kw)
    got = reconstruct.reconstruct_all_slides(
        tiles / "images", tiles / "masks", tmp_path / "torch" / "out", *recon["torch"],
        device="cpu", **kw)
    assert (got["n_slides"], got["skipped"]) == (want["n_slides"], want["skipped"])
    assert list(got["slides"]) == list(want["slides"])
    for slide, w in want["slides"].items():
        g = got["slides"][slide]
        assert (g["coverage"], g["shape"]) == (w["coverage"], w["shape"])
        assert list(g["metrics"]) == list(w["metrics"])
        np.testing.assert_allclose(list(g["metrics"].values()), list(w["metrics"].values()),
                                   rtol=0, atol=METRICS_ATOL)
    assert "wsiC" in want["skipped"] or RECON[case].get("max_tiles")
    out_j, out_t = (next((tmp_path / s).iterdir()) for s in ("jax", "torch"))
    files = sorted(str(p.relative_to(out_j)) for p in out_j.rglob("*") if p.is_file())
    assert sorted(str(p.relative_to(out_t)) for p in out_t.rglob("*") if p.is_file()) == files
    for f in files:
        a, b = out_t / f, out_j / f
        if f.endswith(".png"):
            d = np.abs(_png(a) - _png(b))
            limit = 0 if Path(f).name == "binary_mask.png" else PNG_LEVELS
            assert d.max() <= limit, (f, d.max())
        elif f.endswith("metrics.json"):
            mg, mw = json.loads(a.read_text()), json.loads(b.read_text())
            assert list(mg) == list(mw)
            np.testing.assert_allclose([mg[k] for k in mw], list(mw.values()), rtol=0,
                                       atol=METRICS_ATOL, err_msg=f)
        elif f == "summary.csv":
            rg, rw = (list(csv.reader(p.open())) for p in (a, b))
            assert rg[0] == rw[0] and [r[0] for r in rg] == [r[0] for r in rw]
            np.testing.assert_allclose(np.array([r[1:] for r in rg[1:]], float),
                                       np.array([r[1:] for r in rw[1:]], float),
                                       rtol=0, atol=METRICS_ATOL)
        elif f == "reconstruction_log.json":
            lg, lw = (json.loads(p.read_text()) for p in (a, b))
            lg.pop("timestamp"), lw.pop("timestamp")
            assert {k: v for k, v in lg.items() if k != "slides"} == \
                {k: v for k, v in lw.items() if k != "slides"}
            assert list(lg["slides"]) == list(lw["slides"])
    # the maps themselves, within MAP_ATOL, through the slide reconstructor
    rec_j = jax_reconstruct.SlideReconstructor(*recon["jax"], N, N, batch_size=4,
                                               use_refinement=kw.get("use_refinement", False),
                                               blend_mode=kw.get("blend_mode", "gaussian"))
    rec_t = reconstruct.SlideReconstructor(*recon["torch"], N, N, batch_size=4,
                                           use_refinement=kw.get("use_refinement", False),
                                           blend_mode=kw.get("blend_mode", "gaussian"),
                                           device="cpu")
    info = jax_reconstruct.group_tiles_by_slide(tiles / "images", tiles / "masks")["wsiA"]
    for g, w, scale in zip(rec_t.reconstruct_slide(info["tiles"], (3 * N, 3 * N)),
                           rec_j.reconstruct_slide(info["tiles"], (3 * N, 3 * N)), SCALES):
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("stripe_tiles", [0, 1, 2])
def test_slide_reconstructor_overlap_and_stripes_match_jax(recon, stripe_tiles):
    """Overlapping tiles (stride 48) blended on one canvas and in bands of
    1 and 2 tile rows: the prediction, ground truth and image maps within
    MAP_ATOL; the fused predict-and-blend bit-equal to predict then blend."""
    tiles = recon["overlap"]
    info = reconstruct.group_tiles_by_slide(tiles / "images", tiles / "masks")["wsiD"]
    shape = reconstruct.infer_full_image_dimensions(info["positions"], N, 48)
    assert shape == jax_reconstruct.infer_full_image_dimensions(info["positions"], N, 48)
    rec_j = jax_reconstruct.SlideReconstructor(*recon["jax"], N, 48, batch_size=4,
                                               stripe_tiles=stripe_tiles)
    rec_t = reconstruct.SlideReconstructor(*recon["torch"], N, 48, batch_size=4,
                                           stripe_tiles=stripe_tiles, device="cpu")
    got = rec_t.reconstruct_slide(info["tiles"], shape)
    for g, w, scale in zip(got, rec_j.reconstruct_slide(info["tiles"], shape), SCALES):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=MAP_ATOL)
    if not stripe_tiles:
        imgs = np.stack([cv2.imread(str(t[2]), 0).astype(np.float32) for t in info["tiles"]])
        pos = np.array([(r * 48, c * 48) for r, c, _, _ in info["tiles"]], np.int32)
        assert np.array_equal(rec_t._predict_and_blend(imgs, pos, shape),
                              rec_t._blend(rec_t._predict_batch(imgs), pos, shape))


def test_tile_name_helpers_match_jax(recon, tmp_path):
    for name in ("a_r0_c0.jpg", "S1_10_x1024_y0_r2_c13.jpg", "plain.jpg", "a_rx_c1.jpg"):
        try:
            want = jax_reconstruct.parse_tile_filename(name)
        except ValueError:
            with pytest.raises(ValueError):
                reconstruct.parse_tile_filename(name)
            continue
        assert reconstruct.parse_tile_filename(name) == want
    got = reconstruct.group_tiles_by_slide(recon["tiles"] / "images", recon["tiles"] / "masks")
    want = jax_reconstruct.group_tiles_by_slide(recon["tiles"] / "images",
                                                recon["tiles"] / "masks")
    assert got == want
    (tmp_path / "deep").mkdir()
    cv2.imwrite(str(tmp_path / "deep" / "wsiA.png"), np.zeros((4, 4), np.uint8))
    assert reconstruct.find_source_image("wsiA", tmp_path) == \
        jax_reconstruct.find_source_image("wsiA", tmp_path)
    a = np.arange(12).reshape(4, 3)
    (pa,), n = pad_batch_to(6, a)
    assert n == 4 and pa.shape == (6, 3) and (pa[4:] == a[-1]).all()


def test_reconstruct_cli_runs_the_library_call(recon, tmp_path):
    """``adipose-torch reconstruct --use-tta --tta-mode basic --batch-size 8
    --boundary-refine --device cpu`` writes what ``reconstruct_all_slides``
    writes for ``adipose reconstruct``'s arguments (the segmenter of
    ``load_segmenter`` in bf16, its TTA predict, the tile chunk divided by
    the 4 views): the same files, the PNGs and JSON equal. The library call
    is held to the JAX package above."""
    from adipose_tpu_torch.serving.predict import load_segmenter
    from adipose_tpu_torch.eval.tta import make_tta_predict

    tiles = recon["tiles"]
    torch_main(["reconstruct", "--weights", str(recon["ckpt"]), "--images-dir",
                str(tiles / "images"), "--masks-dir", str(tiles / "masks"), "--tile-size",
                str(N), "--stride", str(N), "--use-tta", "--tta-mode", "basic", "--batch-size",
                "8", "--boundary-refine", "--output-dir", str(tmp_path / "cli"),
                "--device", "cpu"])
    predict, params, _, _ = load_segmenter(recon["ckpt"], device="cpu")
    reconstruct.reconstruct_all_slides(
        tiles / "images", tiles / "masks", tmp_path / "lib", make_tta_predict(predict, "basic"),
        params, tile_size=N, stride=N, batch_size=2, use_refinement=True, device="cpu")
    files = sorted(str(p.relative_to(tmp_path / "lib")) for p in (tmp_path / "lib").rglob("*")
                   if p.is_file())
    assert sorted(str(p.relative_to(tmp_path / "cli"))
                  for p in (tmp_path / "cli").rglob("*") if p.is_file()) == files
    for f in files:
        a, b = tmp_path / "cli" / f, tmp_path / "lib" / f
        if f.endswith(".png"):
            assert np.array_equal(_png(a), _png(b)), f
        elif f.endswith("metrics.json") or f.endswith(".csv"):
            assert a.read_text() == b.read_text(), f


# ---- classification overlay -------------------------------------------------------


def _overlay_inputs(root: Path):
    """Two slides whose names are prefixes of each other (S1_1, S1_10), a
    224x288 BGR chunk image each, and the predictions of their 32^2 tiles in
    the three CSV dialects (chunk offsets in some names)."""
    rs = np.random.RandomState(11)
    wsi = root / "wsi"
    wsi.mkdir(parents=True)
    rows = []
    for slide in ("S1_1", "S1_10"):
        cv2.imwrite(str(wsi / f"{slide}.png"), (rs.rand(224, 288, 3) * 255).astype(np.uint8))
        for r in range(7):
            for c in range(9):
                chunk = "_x0_y0" if (r + c) % 3 == 0 else ""
                rows.append((f"tiles/{slide}{chunk}_r{r}_c{c}.jpg", int(rs.rand() > 0.5),
                             float(np.float32(rs.rand()))))
    dialects = {
        "evaluator": (("path", "label", "prob"), lambda f, lab, p: (f, lab, p)),
        "inference": (("image_path", "adipose_probability", "binary_prediction", "is_adipose"),
                      lambda f, lab, p: (f, p, int(p >= 0.5), "x")),
        "bare": (("file", "probability", "prediction"),
                 lambda f, lab, p: (f, "" if lab else p, int(p > 0.3))),
    }
    paths = {}
    for name, (header, row) in dialects.items():
        paths[name] = root / f"{name}.csv"
        with paths[name].open("w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(header)
            w.writerows(row(*r) for r in rows)
    (root / "metrics.json").write_text(json.dumps({"best_threshold": 0.4}))
    return wsi, paths


@pytest.mark.parametrize("dialect", ["evaluator", "inference", "bare"])
def test_classification_overlay_matches_jax(tmp_path, dialect):
    """``classification-overlay`` over a WSI directory (exact slide match,
    --save-original, the metrics JSON's threshold) and over one WSI: every
    written image bit-equal to the JAX CLI's."""
    wsi, csvs = _overlay_inputs(tmp_path / "in")
    common = ["classification-overlay", "--predictions-csv", str(csvs[dialect]),
              "--tile-size", "32", "--downsample", "2"]
    runs = {
        "dir": ["--wsi-dir", str(wsi), "--save-original", "--combine", "2",
                "--metrics-json", str(tmp_path / "in" / "metrics.json")],
        "one": ["--wsi", str(wsi / "S1_1.png"), "--combine", "1", "--overlay-alpha", "0.6"],
    }
    for run, extra in runs.items():
        jax_main(common + extra + ["--output-dir", str(tmp_path / "jax" / run)])
        torch_main(common + extra + ["--output-dir", str(tmp_path / "torch" / run)])
        names = sorted(p.name for p in (tmp_path / "jax" / run).iterdir())
        assert sorted(p.name for p in (tmp_path / "torch" / run).iterdir()) == names
        assert names
        for n in names:
            a = cv2.imread(str(tmp_path / "torch" / run / n), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "jax" / run / n), cv2.IMREAD_UNCHANGED)
            assert np.array_equal(a, b), n


def test_overlay_helpers_match_jax():
    for name in ("w_x2048_y1024_w6144_h6144_r1_c2.jpg", "plain_r0_c3.jpg"):
        assert overlay.parse_two_level_coords(name, 1024) == \
            jax_overlay.parse_two_level_coords(name, 1024)
    cats = {(x, y): overlay.categorize(x % 2, y % 2) for x in range(5) for y in range(4)}
    assert cats == {(x, y): jax_overlay.categorize(x % 2, y % 2) for x in range(5) for y in range(4)}
    assert overlay.combine_patches(cats, 2) == jax_overlay.combine_patches(cats, 2)


# ---- run-pipeline -------------------------------------------------------------------


def test_run_pipeline_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """``adipose-torch run-pipeline --device cpu`` (64^2 tiles, init_nb 8,
    1 + 1 epochs) on four seeded slides: the build tree and build log of the
    JAX package's builder with the run's configuration (masks bit-equal,
    JPEGs byte-identical: no stain normalization there), the summary keys of
    ``adipose run-pipeline`` with finite values, and the run's artifacts."""
    data = write_slides(tmp_path / "data", rgb=False)
    monkeypatch.chdir(tmp_path)  # checkpoints land under tmp
    torch_main(["run-pipeline", "--data-root", str(data), "--tile-size", str(N),
                "--init-nb", "8", "--epochs-phase1", "1", "--epochs-phase2", "1",
                "--min-train-tiles", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.rindex('{\n  "checkpoint_dir"'):])
    assert set(summary) == {"checkpoint_dir", "val_dice", "test_dice", "optimal_threshold",
                            "timings"}
    assert set(summary["timings"]) == {"build_s", "train_s", "val_eval_s", "test_eval_s"}
    assert 0.0 <= summary["val_dice"] <= 1.0 and 0.0 <= summary["test_dice"] <= 1.0
    ckpt = Path(summary["checkpoint_dir"])
    assert (ckpt / "normalization_stats.json").exists()
    assert (ckpt / "weights_best_overall").exists()
    assert len(list(ckpt.glob("evaluation/*"))) == 2
    (got,) = data.glob("_build_*")
    want = JaxBuilder(JaxDataBuildConfig(tile_size=N, stride=N, val_fraction=0.15,
                                         test_fraction=0.15),
                      build_root=tmp_path / "jax_build").build(data)
    files = sorted(str(p.relative_to(want)) for p in want.rglob("*") if p.is_file())
    assert sorted(str(p.relative_to(got)) for p in got.rglob("*") if p.is_file()) == files
    for f in files:
        if f.endswith(".json"):
            lg, lw = (json.loads((r / f).read_text()) for r in (got, want))
            lg.pop("timestamp"), lw.pop("timestamp")
            assert lg == lw, f
        elif f.endswith(".tif"):
            assert np.array_equal(cv2.imread(str(got / f), -1), cv2.imread(str(want / f), -1))
        else:
            assert filecmp.cmp(got / f, want / f, shallow=False), f
    with pytest.raises(SystemExit):
        torch_main(["run-pipeline", "--data-root", str(data), "--skip-build",
                    "--min-train-tiles", "1000", "--device", "cpu"])
