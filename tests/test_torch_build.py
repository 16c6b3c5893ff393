"""The dataset builders on the CPU: the port's colour conversion, Reinhard
stain transfer, device QC, tile planning, slide discovery and both builders
against the JAX package's, on the same slides and annotations made from a
seed with numpy (64^2 tiles on slides of at most 192^2). Every bound is
stated beside its test.
"""

import dataclasses
import filecmp
import json
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.core.config import DataBuildConfig as JaxDataBuildConfig
from adipose_tpu.data import tiling as jax_tiling
from adipose_tpu.data.class_builder import ClassificationDatasetBuilder as JaxClassBuilder
from adipose_tpu.ops import color as jax_color
from adipose_tpu.ops import stain as jax_stain
from adipose_tpu_torch.core.config import DataBuildConfig
from adipose_tpu_torch.data import tiling
from adipose_tpu_torch.data.class_builder import ClassificationDatasetBuilder
from adipose_tpu_torch.ops import color, stain

T = 64
# The same float32 formulas; XLA and torch round pow, the cube root (cbrt
# there, pow(t, 1/3) here) and the per-tile means in other orders: measured
# 9.5e-7 in unit RGB and 5.7e-5 in L*a*b* (5.7e-7 of its 100-unit range).
UNIT_ATOL = 1e-5
# A uint8 result truncates the unit value * 255: a 1e-6 gap moves a pixel
# that sits on a level boundary by one level, rarely (measured 1 level in
# 1.5e-5 of the pixels).
U8_LEVELS, U8_SHARE = 1, 1e-3
# Reinhard scales each tile's rounding by ref_std / src_std. A tile of low
# colour variance (a blurred or near-white one) amplifies it: at 28x (a
# blurred tile, L std 0.54) 1.5e-2 of its pixels moved by one level, so such
# tiles (amplification above 4) are held to 3e-2 and still to one level.
ILL_AMPLIFICATION, ILL_SHARE = 4.0, 3e-2
# A JPEG of a tile holds each 1-level pixel in its 8x8 block's DCT
# coefficients: decoded, the two builds' stain-normalized JPEGs differ by
# at most 2 levels (measured 2, in 0.19% of the pixels).
JPEG_LEVELS = 2


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unit_batch(seed=0, shape=(2, T, T, 3)):
    rs = np.random.RandomState(seed)
    x = (rs.rand(*shape) * 230 + 10).astype(np.uint8)
    return x, x.astype(np.float32) / 255.0


def _assert_u8_close(got, want, share=U8_SHARE):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= U8_LEVELS and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


def _amplification(tiles_u8) -> np.ndarray:
    """Each tile's largest ref_std / src_std over the L*a*b* channels."""
    ref = np.array(stain.DEFAULT_REFERENCE.std)
    return np.array([(ref / stain.compute_lab_stats(
        torch.from_numpy(t.astype(np.float32) / 255))[1].numpy()).max() for t in tiles_u8])


def _assert_stain_tiles_close(got, want, tiles_u8):
    """U8_SHARE on well-conditioned tiles, ILL_SHARE on the others."""
    ill = _amplification(tiles_u8) > ILL_AMPLIFICATION
    if (~ill).any():
        _assert_u8_close(np.asarray(got)[~ill], np.asarray(want)[~ill])
    if ill.any():
        _assert_u8_close(np.asarray(got)[ill], np.asarray(want)[ill], ILL_SHARE)


# ---- colour and stain ----------------------------------------------------------


def test_xyz2rgb_is_bit_equal_to_jax():
    """The float32 inverse copied, not re-derived in float64."""
    assert np.array_equal(np.array(color._XYZ2RGB, np.float32), np.asarray(jax_color._XYZ2RGB))


def test_color_conversions_match_jax():
    """rgb2lab (over its 100-unit range), lab2rgb, linear/sRGB and rgb2gray
    within UNIT_ATOL."""
    _, u = _unit_batch()
    lab_j = np.asarray(jax_color.rgb2lab(jnp.asarray(u)))
    lab_t = color.rgb2lab(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(lab_t / 100.0, lab_j / 100.0, rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(color.lab2rgb(torch.from_numpy(lab_j)).numpy(),
                               jax_color.lab2rgb(jnp.asarray(lab_j)), rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(color.linear_to_srgb(color.srgb_to_linear(torch.from_numpy(u))),
                               u, rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(color.rgb2gray(torch.from_numpy(u)).numpy(),
                               jax_color.rgb2gray(jnp.asarray(u)), rtol=0, atol=UNIT_ATOL)


def test_reinhard_matches_jax():
    """compute_lab_stats (unit-range L*a*b*), reinhard_normalize_batch (each
    tile's own statistics) and the single-image transfer within UNIT_ATOL;
    normalize_image on uint8 within U8_LEVELS and on unit floats within
    UNIT_ATOL; LabStats from an image and from metadata equal."""
    x, u = _unit_batch()
    m_j, s_j = jax_stain.compute_lab_stats(jnp.asarray(u))
    m_t, s_t = stain.compute_lab_stats(torch.from_numpy(u))
    np.testing.assert_allclose(m_t.numpy() / 100, np.asarray(m_j) / 100, rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(s_t.numpy() / 100, np.asarray(s_j) / 100, rtol=0, atol=UNIT_ATOL)
    rm_j, rs_j = jax_stain.DEFAULT_REFERENCE.as_arrays()
    rm_t, rs_t = stain.DEFAULT_REFERENCE.as_arrays("cpu")
    want = np.asarray(jax_stain.reinhard_normalize_batch(jnp.asarray(u), rm_j, rs_j))
    got = stain.reinhard_normalize_batch(torch.from_numpy(u), rm_t, rs_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(stain.reinhard_normalize(torch.from_numpy(u[1]), rm_t, rs_t),
                               want[1], rtol=0, atol=UNIT_ATOL)
    got_u8 = stain.normalize_image(x[0], device="cpu").numpy()
    assert got_u8.dtype == np.uint8
    _assert_u8_close(got_u8, jax_stain.normalize_image(x[0]))
    np.testing.assert_allclose(stain.normalize_image(u[0], device="cpu").numpy(),
                               jax_stain.normalize_image(u[0]), rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(stain.LabStats.from_image(x[0]).mean,
                               jax_stain.LabStats.from_image(x[0]).mean, rtol=0, atol=1e-3)


def test_reinhard_zero_std_channel_maps_to_the_reference_mean():
    """The reference's zero-variance rule (stain_normalization.py:129-134):
    a tile constant in a channel takes the reference mean there. The JAX
    package does not reach it on a constant tile: its float32 mean of 4096
    equal L values is off by 8.9e-4, so its std is 8.9e-4, not 0, and the
    tile moves by one reference std (grey 134.6 instead of 175.4 at RGB
    250). torch's std of equal values is exactly 0."""
    u = np.full((1, T, T, 3), 250 / 255.0, np.float32)
    rm, rs = stain.DEFAULT_REFERENCE.as_arrays("cpu")
    out = stain.reinhard_normalize_batch(torch.from_numpy(u), rm, rs)
    lab = color.rgb2lab(out)
    np.testing.assert_allclose(lab[0, 0, 0].numpy(), stain.DEFAULT_REFERENCE.mean, atol=0.05)
    assert torch.equal(out, out[:, :1, :1].expand_as(out))
    jax_std = np.asarray(jax_stain.compute_lab_stats(jnp.asarray(u))[1])
    assert jax_std[0] > 0.0  # the JAX package's rounding, recorded above


@pytest.mark.parametrize("stain_on", [False, True])
def test_device_rgb_qc_matches_jax(stain_on):
    """Verdicts equal; grayscale bit-equal with stain off and with stain on
    within U8_LEVELS in at most U8_SHARE of the pixels (ILL_SHARE on the
    blurred and near-white tiles); the Laplacian variances within 1e-4
    relative (5e-3 with stain on)."""
    rs = np.random.RandomState(1)
    x = (rs.rand(8, T, T, 3) * 200 + 30).astype(np.uint8)
    x[0] = 250 - (rs.rand(T, T, 3) * 8).astype(np.uint8)  # near-white: empty
    x[1] = cv2.GaussianBlur(x[1], (31, 31), 15)  # smooth: blurry
    x[2, :, : T // 2] = 252
    rm_j, rs_j = jax_stain.DEFAULT_REFERENCE.as_arrays()
    g_j, v_j = jax_tiling._device_rgb_qc_jit(jnp.asarray(x), rm_j, rs_j, 235, 0.7, 7.5,
                                             stain=stain_on)
    rm_t, rs_t = stain.DEFAULT_REFERENCE.as_arrays("cpu")
    g_t, v_t = tiling._device_rgb_qc(torch.from_numpy(x), rm_t, rs_t, 235, 0.7, 7.5, stain_on)
    assert g_t.dtype == torch.uint8 and g_t.shape == (8, T, T)
    if stain_on:
        _assert_stain_tiles_close(g_t.numpy(), g_j, x)
    else:
        assert np.array_equal(g_t.numpy(), np.asarray(g_j))
    for k in ("is_empty", "is_blurry", "is_good", "white_ratio"):
        assert np.array_equal(v_t[k].numpy(), np.asarray(v_j[k])), k
    # with stain on, the 1-level pixels move the blurred tile's variance by
    # 7.3e-4 relative (measured); float32 sums alone, by < 1e-6
    np.testing.assert_allclose(v_t["laplacian_var"].numpy(), v_j["laplacian_var"],
                               rtol=5e-3 if stain_on else 1e-4)
    if not stain_on:  # Reinhard spreads the near-white and blurred tiles
        assert bool(v_t["is_empty"][0]) and bool(v_t["is_blurry"][1])


# ---- tile planning and discovery ------------------------------------------------


@pytest.mark.parametrize("h,w,tile,stride", [
    (192, 192, 64, 64), (160, 192, 64, 64), (191, 64, 64, 48), (64, 64, 64, 64),
    (63, 200, 64, 64), (200, 63, 64, 64), (130, 70, 64, 100), (1000, 1000, 1024, 1024),
    (6144, 4096, 1024, 1024), (3000, 5000, 1024, 1024),
])
def test_tile_coords_match_jax(h, w, tile, stride):
    assert tiling.tile_coords(h, w, tile, stride) == jax_tiling.tile_coords(h, w, tile, stride)


def _write_image(path: Path, rs, shape):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), (rs.rand(*shape) * 200).astype(np.uint8))


def test_discover_slides_matches_jax(tmp_path):
    """A test/ folder, a main-folder duplicate of a test slide, a slide
    whose annotations are all below the gate, one without annotations, and
    other extensions; with and without the test set and the duplicate rule,
    and through the override dirs."""
    rs = np.random.RandomState(2)
    root = tmp_path / "data"
    for name in ("a.png", "b.jpg", "c.tif", "dup.png", "test/dup.png", "test/t1.png",
                 "notes.txt"):
        if name.endswith(".txt"):
            (root / "Pseudocolored" / name).write_text("x")
        else:
            _write_image(root / "Pseudocolored" / name, rs, (8, 8))
    fat = root / "Masks" / "fat"
    fat.mkdir(parents=True)
    (root / "Masks" / "bubbles").mkdir()
    tri = [[1, 1], [6, 1], [6, 6]]
    for base, conf in (("a", 3), ("b", 1), ("dup", 2), ("t1", 2)):
        (fat / f"{base}_fat.json").write_text(json.dumps(
            [{"confidenceScore": conf, "annotation": {"elements": [
                {"type": "polyline", "points": tri}]}}]))
    (root / "Masks" / "bubbles" / "a.json").write_text("[]")
    for kw in ({}, {"min_confidence": 2}, {"include_test_set": False},
               {"exclude_test_duplicates": False}, {"subtract": None},
               {"images_dir": root / "Pseudocolored", "masks_dir": root / "Masks"}):
        got = tiling.discover_slides(root, **kw)
        want = jax_tiling.discover_slides(root, **kw)
        assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
        assert got, kw


# ---- the builders ---------------------------------------------------------------


def _poly(cx, cy, r, n=10):
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return [[float(cx + r * np.cos(t)), float(cy + r * np.sin(t))] for t in a]


def _record(conf, points):
    rec = {"annotation": {"elements": [{"type": "polyline", "points": points}]}}
    if conf is not None:
        rec["confidenceScore"] = conf
    return rec


def write_slides(root: Path, rgb: bool, seed: int = 0) -> Path:
    """Four seeded slides in the reference layout (192^2, 160x192, 192x128,
    and a test/ slide duplicated in the main folder): a near-white band
    over the first tile row of slide 0, a blurred tile in slide 1, large
    confidence-3 fat polygons, a small one (an ambiguous tile), a
    confidence-1 polygon alone in its tile, one with no score, bubbles
    over fat; slide 2's fat is all confidence 1."""
    rs = np.random.RandomState(seed)
    shapes = {"slide0": (192, 192), "slide1": (160, 192), "slide2": (192, 128),
              "test/slide3": (128, 192), "slide3": (128, 192)}
    for name, (h, w) in shapes.items():
        img = cv2.GaussianBlur((rs.rand(h, w, 3) * 150 + 50).astype(np.uint8), (3, 3), 0)
        if name == "slide0":
            img[:T] = 255 - (rs.rand(T, w, 3) * 10).astype(np.uint8)
        if name == "slide1":
            img[T:2 * T, T:2 * T] = cv2.GaussianBlur(img[T:2 * T, T:2 * T], (31, 31), 15)
        if not rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        path = root / "Pseudocolored" / f"{name}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), img)
        base = Path(name).name
        big = 3 if base != "slide2" else 1
        recs = [_record(big, _poly(40, 150, 30)), _record(big, _poly(w - 40, 100, 25)),
                _record(2, _poly(96, 96, 5)),  # ~2% of its tile: ambiguous
                _record(1, _poly(w - 32, 32, 12)),  # alone in the top-right tile
                _record(None, _poly(90, h - 20, 10))]
        fat = root / "Masks" / "fat" / f"{base}.json"
        fat.parent.mkdir(parents=True, exist_ok=True)
        fat.write_text(json.dumps(recs))
        bub = root / "Masks" / "bubbles" / f"{base}.json"
        bub.parent.mkdir(parents=True, exist_ok=True)
        bub.write_text(json.dumps([_record(3, _poly(40, 150, 10))]))
    return root


@pytest.fixture(scope="module")
def slide_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("slides")
    return {"gray": write_slides(root / "gray", rgb=False),
            "rgb": write_slides(root / "rgb", rgb=True)}


SEG = {"tile_size": T, "stride": T, "test_stride": T, "workers": 2}
BUILDS = {  # name: (kind, slides, config, mark_all_test)
    "seg_gray_defaults": ("seg", "gray", {}, False),
    "seg_rgb_stain_drop_white_no_subtract": (
        "seg", "rgb", {"apply_stain_norm": True, "keep_white": False, "subtract": False,
                       "val_fraction": 0.34}, False),
    "seg_rgb_test_set_ambiguous_neg_pct": (
        "seg", "rgb", {"include_test_set": True, "include_ambiguous": True,
                       "test_neg_pct": 0.5, "test_include_blurry": True,
                       "test_min_mask_ratio": 0.05}, False),
    "seg_gray_tile_split_conf2_overlap": (
        "seg", "gray", {"split_by_slide": False, "test_fraction": 0.3,
                        "min_confidence_train": 2, "stride": 48, "morph_close_k": 5,
                        "min_cc_px": 30, "negative_fraction": 0.2}, False),
    "seg_rgb_stain_test_only": (
        "seg", "rgb", {"apply_stain_norm": True, "subtract": False, "test_include_white": True,
                       "test_include_blurry": True, "val_fraction": 0.0}, True),
    "class_rgb": ("class", "rgb", {"val_fraction": 0.34, "white_threshold": 245,
                                   "negative_fraction": 0.8}, False),
    "class_rgb_stain_ambiguous_drop_white": (
        "class", "rgb", {"apply_stain_norm": True, "include_ambiguous": True,
                         "keep_white": False, "test_fraction": 0.34}, False),
    "class_gray_test_only": ("class", "gray", {"balance_classes": False, "val_fraction": 0.0,
                                               "min_confidence_eval": 1}, True),
}


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _json_without_timestamp(path: Path) -> dict:
    d = json.loads(path.read_text())
    d.pop("timestamp")
    return d


@pytest.mark.parametrize("name", list(BUILDS))
def test_builders_match_jax(slide_roots, tmp_path, name):
    """The same files (tile names per split, QA tiles), bit-equal masks,
    equal logs and stats apart from the timestamp, byte-identical manifests,
    and JPEGs byte-identical with stain normalization off and decoded within
    JPEG_LEVELS with it on."""
    kind, slides, kw, mark_all_test = BUILDS[name]
    data = slide_roots[slides]
    cfg_kw = {**SEG, **kw}
    if kind == "seg":
        want = jax_tiling.SegmentationDatasetBuilder(
            JaxDataBuildConfig(**cfg_kw), build_root=tmp_path / "jax").build(
                data, mark_all_test=mark_all_test)
        builder = tiling.SegmentationDatasetBuilder(
            DataBuildConfig(**cfg_kw), build_root=tmp_path / "torch", device="cpu")
        logs = ("build_log.json", "build_summary.json")
    else:
        want = JaxClassBuilder(JaxDataBuildConfig(**cfg_kw), build_root=tmp_path / "jax").build(
            data, mark_all_test=mark_all_test)
        builder = ClassificationDatasetBuilder(
            DataBuildConfig(**cfg_kw), build_root=tmp_path / "torch", device="cpu")
        logs = ("balance_report.json",)
    got = builder.build(data, mark_all_test=mark_all_test)
    files = _files(want)
    assert _files(got) == files
    assert any("/images/" in f or "adipose/" in f for f in files)
    for f in files:
        a, b = got / f, want / f
        if f.endswith((".tif", ".png")):
            assert np.array_equal(cv2.imread(str(a), -1), cv2.imread(str(b), -1)), f
        elif f.endswith(".jpg") and cfg_kw.get("apply_stain_norm"):
            d = np.abs(cv2.imread(str(a), 0).astype(int) - cv2.imread(str(b), 0).astype(int))
            assert d.max() <= JPEG_LEVELS, f
        elif f.endswith(".json") and f in logs:
            assert _json_without_timestamp(a) == _json_without_timestamp(b), f
        else:  # JPEGs without stain, manifests, config.json, build_summary.txt
            assert filecmp.cmp(a, b, shallow=False), f
    if kind == "seg":
        assert json.loads((got / "build_log.json").read_text())["stats"] == vars(builder.stats)
        assert set(builder.timings) == {"rasterize_s", "tile_s", "write_s"}


def _rgb_tiles(slide, tiles) -> np.ndarray:
    """The source RGB crops of named tiles of a slide (stride T)."""
    rgb = cv2.cvtColor(cv2.imread(str(slide.image_path)), cv2.COLOR_BGR2RGB)
    rc = [t["name"].rsplit("_r", 1)[1].split("_c") for t in tiles]
    return np.stack([rgb[int(r) * T:(int(r) + 1) * T, int(c) * T:(int(c) + 1) * T] for r, c in rc])


def test_tile_slide_images_match_jax_with_stain(slide_roots, tmp_path):
    """The in-memory tiles of a stain-normalized slide: the same names,
    pos ratios and masks, images within U8_LEVELS in at most U8_SHARE of
    the pixels (ILL_SHARE on its near-white tiles)."""
    cfg = {**SEG, "apply_stain_norm": True}
    jb = jax_tiling.SegmentationDatasetBuilder(JaxDataBuildConfig(**cfg),
                                               build_root=tmp_path / "jax")
    tb = tiling.SegmentationDatasetBuilder(DataBuildConfig(**cfg), build_root=tmp_path / "torch",
                                           device="cpu")
    slide = tiling.discover_slides(slide_roots["rgb"])[0]
    jslide = jax_tiling.SlideSource(*dataclasses.astuple(slide))
    mask = tb.build_slide_mask(slide)
    assert np.array_equal(mask, jb.build_slide_mask(jslide))
    got, want = tb.tile_slide(slide, mask), jb.tile_slide(jslide, mask)
    assert [(t["name"], t["pos_ratio"]) for t in got] == [(t["name"], t["pos_ratio"]) for t in want]
    for g, w in zip(got, want):
        assert np.array_equal(g["mask"], w["mask"])
    _assert_stain_tiles_close(np.stack([t["image"] for t in got]),
                              np.stack([t["image"] for t in want]), _rgb_tiles(slide, got))
    assert vars(tb.stats) == vars(jb.stats)


def test_the_builder_raises_for_a_missing_card(slide_roots, tmp_path):
    """No fallback: a cuda builder without a card raises, on the gray and
    the RGB path alike."""
    for slides in ("gray", "rgb"):
        b = tiling.SegmentationDatasetBuilder(DataBuildConfig(**SEG),
                                              build_root=tmp_path / slides, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            b.build(slide_roots[slides])


def test_data_build_config_matches_jax():
    """The same fields, order and defaults: build_log.json's config block."""
    assert list(vars(DataBuildConfig())) == list(vars(JaxDataBuildConfig()))
    assert vars(DataBuildConfig()) == vars(JaxDataBuildConfig())
