"""The ECM preprocessing on the CPU: the port's reflect padding, morphology,
FFT and Gaussian ops, CLAHE, the z-score and percentile stretches,
``preprocess_ecm_image`` and ``adipose-torch preprocess-ecm`` against the JAX
package's, on seeded images of 64^2 to 160^2 and odd shapes. Each JAX
reference is compiled once, without XLA's CPU optimizations, which change
no semantics. Every bound is stated beside its test.
"""

import dataclasses
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.core.config import ECMPreprocessConfig as JaxECMConfig
from adipose_tpu.ops import clahe as jax_clahe
from adipose_tpu.ops import fftops as jax_fft
from adipose_tpu.ops import morphology as jax_morph
from adipose_tpu.ops import normalize as jax_norm
from adipose_tpu.wsi import ecm as jax_ecm
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import ECMPreprocessConfig
from adipose_tpu_torch.ops import clahe, fftops, morphology, normalize
from adipose_tpu_torch.wsi import ecm

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# float32 results in [0, 255]: the same formulas, summed in other orders
# (means, the CLAHE clip excess and CDF, the FFT, a conv's taps). Measured
# up to 1.2e-4 (the FFT; the 1201-tap blur at sigma 150: 2.2e-4).
F32_ATOL = 1e-3
# The flat field multiplies by mean / (background + 1), up to ~8x on these
# images: measured 2.3e-3.
POLY_ATOL = 1e-2
# A uint8 result truncates: a 1e-4 gap moves a pixel on a level boundary by
# one level (measured in at most 2e-4 of the pixels).
U8_LEVELS, U8_SHARE = 1, 1e-3
# CLAHE after a float stage bins its input by truncation, so a 1e-5 gap at
# an integer moves a pixel to the next bin: that pixel moves by one step of
# the clipped CDF, at most 255 x (clip + excess) / tile pixels = 255 x 4 / 256
# levels at clip 3, which the sharpening after it scales by 1 + 0.5 x (1 -
# 0.16): at most 6 levels. The tile's brighter pixels move by 255 / (tile
# pixels) levels, 0.27 on these 960-pixel tiles (0.002 on a 6144^2 chunk's
# 384^2 tiles), and some of them cross a level. Measured over seeds: 1-4
# levels in 0-0.51% of the pixels.
CLAHE_LEVELS, CLAHE_SHARE = 6, 1e-2


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ecm_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded uint8 fluorescence-like image: smooth fibres, vertical
    banding, a slow illumination ramp and noise."""
    rs = np.random.RandomState(seed)
    coarse = cv2.resize(rs.rand(h // 8 + 2, w // 8 + 2).astype(np.float32), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    band = 18.0 * np.sin(np.arange(w) * 2 * np.pi / 9.0)[None, :]
    ramp = np.linspace(0.0, 40.0, h)[:, None]
    img = 60 + 110 * coarse + band + ramp + rs.normal(0.0, 8.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jax(fn, *args):
    """``jax.jit(fn)`` compiled without XLA's CPU optimizations, called."""
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_u8_close(got, want, levels=U8_LEVELS, share=U8_SHARE):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= levels and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("n,lo,hi", [(5, 7, 7), (1, 3, 2), (2, 5, 0), (16, 40, 33)])
def test_reflect_pad_matches_jnp_pad(n, lo, hi):
    """Bit-equal to ``jnp.pad(..., 'reflect')`` on both axes, pads wider than
    the side included (F.pad refuses those)."""
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = _jax(lambda a: jnp.pad(a, ((lo, hi), (hi, lo)), mode="reflect"), x)
    got = fftops.reflect_pad(_t(x), lo, hi, hi, lo).numpy()
    np.testing.assert_array_equal(got, want)


MORPH = {  # name: (port, JAX); each a min or max of the same floats: bit-equal
    "erode_rect_5x3": (lambda x: morphology.erode_rect(x, 5, 3),
                       lambda x: jax_morph.erode_rect(x, 5, 3)),
    "dilate_rect_4x2": (lambda x: morphology.dilate_rect(x, 4, 2),
                        lambda x: jax_morph.dilate_rect(x, 4, 2)),
    "open_rect_32x1": (lambda x: morphology.open_rect(x, 32, 1),
                       lambda x: jax_morph.open_rect(x, 32, 1)),
    "close_rect_3x6": (lambda x: morphology.close_rect(x, 3, 6),
                       lambda x: jax_morph.close_rect(x, 3, 6)),
    "erode_disk_5": (lambda x: morphology.erode_disk(x, 5), lambda x: jax_morph.erode_disk(x, 5)),
    "dilate_disk_4": (lambda x: morphology.dilate_disk(x, 4),
                      lambda x: jax_morph.dilate_disk(x, 4)),
    "open_disk_3": (lambda x: morphology.open_disk(x, 3), lambda x: jax_morph.open_disk(x, 3)),
    "close_disk_2": (lambda x: morphology.close_disk(x, 2), lambda x: jax_morph.close_disk(x, 2)),
}


@pytest.mark.parametrize("name", list(MORPH))
def test_morphology_is_bit_equal_to_jax(name):
    port, ref = MORPH[name]
    x = ecm_image(67, 131, seed=1)
    np.testing.assert_array_equal(port(_t(x)).numpy(), _jax(ref, x))


COMPOSITE = {  # the same min/max plus a mean: within F32_ATOL (measured 1.5e-5)
    "remove_banding_morphological": (
        lambda x: morphology.remove_banding_morphological(x, 1, 32),
        lambda x: jax_morph.remove_banding_morphological(x, 1, 32)),
    "rolling_ball_5": (lambda x: morphology.correct_illumination_rolling_ball(x, 5),
                       lambda x: jax_morph.correct_illumination_rolling_ball(x, 5)),
    "tophat_8": (lambda x: morphology.correct_illumination_tophat(x, 8),  # even: 9
                 lambda x: jax_morph.correct_illumination_tophat(x, 8)),
}


@pytest.mark.parametrize("name", list(COMPOSITE))
def test_morphological_corrections_match_jax(name):
    port, ref = COMPOSITE[name]
    x = ecm_image(96, 160, seed=2)
    np.testing.assert_allclose(port(_t(x)).numpy(), _jax(ref, x), rtol=0, atol=F32_ATOL)


FFT = {  # name: (shape, port, JAX, atol)
    "fft_default": ((96, 160), fftops.remove_banding_fft, jax_fft.remove_banding_fft, F32_ATOL),
    "fft_odd_blend": ((67, 131),
                      lambda x: fftops.remove_banding_fft(x, (0.1, 0.15), 5, 0.8, 0.6),
                      lambda x: jax_fft.remove_banding_fft(x, (0.1, 0.15), 5, 0.8, 0.6), F32_ATOL),
    "column_normalize": ((96, 160), fftops.remove_banding_column_normalize,
                         jax_fft.remove_banding_column_normalize, F32_ATOL),
    "column_normalize_scaled": (
        (67, 131), lambda x: fftops.remove_banding_column_normalize(x, False),
        lambda x: jax_fft.remove_banding_column_normalize(x, False), F32_ATOL),
    # the reflect hazard: radius 600 on a 128^2 image
    "gaussian_150": ((128, 128), lambda x: fftops.gaussian_blur(x, 150.0),
                     lambda x: jax_fft.gaussian_blur(x, 150.0), F32_ATOL),
    "gaussian_1": ((67, 131), lambda x: fftops.gaussian_blur(x, 1.0),
                   lambda x: jax_fft.gaussian_blur(x, 1.0), F32_ATOL),
    "polynomial_150": ((128, 128), fftops.correct_illumination_polynomial,
                       jax_fft.correct_illumination_polynomial, POLY_ATOL),
    "sharpen": ((96, 160), lambda x: fftops.sharpen_unsharp(x, 1.5, 0.7),
                lambda x: jax_fft.sharpen_unsharp(x, 1.5, 0.7), F32_ATOL),
}


@pytest.mark.parametrize("name", list(FFT))
def test_fft_and_gaussian_ops_match_jax(name):
    shape, port, ref, atol = FFT[name]
    x = ecm_image(*shape, seed=3)
    np.testing.assert_allclose(port(_t(x)).numpy(), _jax(ref, x.astype(np.float32)),
                               rtol=0, atol=atol)


def test_gaussian_blur_is_full_float32_under_tf32():
    """The blur and SSIM turn cuDNN's TF32 off around their convs and restore
    the caller's setting."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            with fftops.full_f32():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("grid", [8, 16])
def test_clahe_histograms_are_bit_equal(grid):
    """The port's bincount histograms equal the JAX package's one-hot sums
    (``adipose_tpu/ops/clahe.py:49-54``) count for count."""
    x = ecm_image(128, 96, seed=4).astype(np.float32)

    def one_hot_hist(img):
        h, w = img.shape
        th, tw = h // grid, w // grid
        tiles = img.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3).reshape(grid, grid, -1)
        bins = jnp.clip(tiles.astype(jnp.int32), 0, 255)
        return jnp.sum(jax.nn.one_hot(bins, 256, dtype=jnp.float32), axis=2)

    pix = _t(x).to(torch.int32).clamp(0, 255).to(torch.int64)
    np.testing.assert_array_equal(clahe._tile_histograms(pix, grid, 256).numpy(),
                                  _jax(one_hot_hist, x))


CLAHE = {  # name: (shape, clip, grid); the padded ones reflect to the grid
    "clahe_64": ((64, 64), 2.0, 8),
    "any_shape_odd": ((67, 131), 3.0, 16),
    "any_shape_tiny": ((3, 5), 2.0, 8),  # pads of 5 and 3 reflect more than once
}


@pytest.mark.parametrize("name", list(CLAHE))
def test_clahe_matches_jax(name):
    """Within F32_ATOL (measured 6.1e-5: the clip excess and CDF sums)."""
    shape, clip, grid = CLAHE[name]
    x = ecm_image(*shape, seed=5).astype(np.float32) if min(shape) > 8 else \
        np.random.RandomState(5).randint(0, 256, shape).astype(np.float32)
    got = clahe._clahe_any_shape(_t(x), clip, grid).numpy()
    want = _jax(lambda a: jax_clahe._clahe_any_shape(a, clip, grid), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _adaptive_inputs() -> dict:
    rs = np.random.RandomState(6)
    base = ecm_image(64, 64, seed=6).astype(np.float32)
    z = (base - base.mean()) / base.std()
    return {"poor": np.clip(150 + 10 * z, 0, 255).astype(np.uint8),  # std / mean ~ 0.07
            "medium": np.clip(120 + 27 * z, 0, 255).astype(np.uint8),  # ~ 0.22
            "good": (rs.rand(64, 64) * 255).astype(np.uint8)}  # ~ 0.58, sharp


@pytest.mark.parametrize("route", ["poor", "medium", "good"])
def test_adaptive_clahe_routes_as_jax(route):
    """The same strategy, and the unit image within F32_ATOL / 255."""
    img = _adaptive_inputs()[route]
    want, want_route = jax_clahe.adaptive_clahe_normalize(img)
    got, got_route = clahe.adaptive_clahe_normalize(img, device="cpu")
    assert got_route == want_route == route
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL / 255)


@pytest.mark.parametrize("shape", [(96, 160), (3, 5)])
def test_zscore_to_target_matches_jax(shape):
    """The population std (``jnp.std``), not torch's default Bessel
    correction: on a 3 x 5 image the two differ by 3.5%. Measured 1.5e-5."""
    x = ecm_image(*shape, seed=7) if min(shape) > 8 else \
        np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    got = normalize.zscore_to_target(_t(x)).numpy()
    np.testing.assert_allclose(got, _jax(jax_norm.zscore_to_target, x), rtol=0, atol=F32_ATOL)
    constant = np.full((4, 6), 37, np.uint8)
    np.testing.assert_array_equal(normalize.zscore_to_target(_t(constant)).numpy(),
                                  _jax(jax_norm.zscore_to_target, constant))


@pytest.mark.parametrize("p", [(1.0, 99.0), (5.0, 95.0)])
def test_percentile_stretch_255_is_bit_equal_to_jax(p):
    """The sort path reproduces ``jnp.percentile``'s float32 rank: bit-equal,
    the degenerate (constant) image returned as it is."""
    for x in (ecm_image(67, 131, seed=8), np.full((5, 7), 9, np.uint8)):
        got = normalize.percentile_stretch_255(_t(x), *p).numpy()
        want = _jax(lambda a: jax_norm.percentile_stretch_255(a, *p), x)
        np.testing.assert_array_equal(got, want)


STACKS = {  # name: ECMPreprocessConfig fields, and the CLI flags that set them
    "fft_percentile_rolling_clahe_sharpen": (
        dict(deband_method="fft", normalization_method="percentile",
             illumination_method="rolling_ball", rolling_ball_radius=5, apply_clahe=True,
             clahe_grid=4, sharpen=True),
        ["--deband", "fft", "--normalization-method", "percentile", "--illumination",
         "rolling-ball", "--rolling-ball-radius", "5", "--clahe", "--clahe-tile-size", "4",
         "--sharpen"]),
    "morphological_zscore_tophat": (
        dict(deband_method="morphological", morph_height=32, normalization_method="zscore",
             illumination_method="tophat", tophat_kernel=9),
        ["--banding-method", "morphological", "--morph-height", "32",
         "--normalization-method", "zscore", "--illumination", "tophat", "--tophat-kernel",
         "9"]),
    "column_norm_gaussian": (
        dict(deband_method="column_norm", illumination_method="gaussian"),
        ["--deband", "column_norm", "--illumination-method", "gaussian"]),
    "clahe_illumination": (
        dict(illumination_method="clahe", clahe_illum_tile=8),
        ["--illumination", "clahe", "--clahe-illum-tile", "8", "--visualize",
         "--max-visualizations", "2", "--test-mode", "--test-samples", "2"]),
}
ECM_SHAPE = (96, 160)


def _stack_bound(name: str) -> tuple:
    """CLAHE after float stages: CLAHE_LEVELS; else U8_LEVELS."""
    return (CLAHE_LEVELS, CLAHE_SHARE) if STACKS[name][0].get("apply_clahe") else \
        (U8_LEVELS, U8_SHARE)


@pytest.mark.parametrize("name", list(STACKS))
def test_preprocess_ecm_image_matches_jax(name):
    """Each stage stack on a gray image, and the first on an RGB one (cv2's
    gray first), within its stack's bound."""
    fields, _ = STACKS[name]
    img = ecm_image(*ECM_SHAPE, seed=9)
    _assert_u8_close(ecm.preprocess_ecm_image(img, ECMPreprocessConfig(**fields), "cpu"),
                     jax_ecm.preprocess_ecm_image(img, JaxECMConfig(**fields)),
                     *_stack_bound(name))
    if name == "fft_percentile_rolling_clahe_sharpen":
        rgb = np.stack([img, ecm_image(*ECM_SHAPE, seed=10), img // 2], axis=-1)
        _assert_u8_close(ecm.preprocess_ecm_image(rgb, ECMPreprocessConfig(**fields), "cpu"),
                         jax_ecm.preprocess_ecm_image(rgb, JaxECMConfig(**fields)),
                         *_stack_bound(name))


def _write_ecm_inputs(root: Path) -> Path:
    """Five seeded chunks: two JPEGs, two PNGs and a TIFF (the driver lists
    *.jpg, then *.png, then *.tif), and a file that is not an image."""
    root.mkdir()
    for i, name in enumerate(("b.jpg", "a.jpg", "c.png", "d.png", "e.tif")):
        cv2.imwrite(str(root / name), ecm_image(*ECM_SHAPE, seed=20 + i))
    (root / "notes.txt").write_text("not an image")
    return root


def _images(root: Path) -> dict:
    return {str(p.relative_to(root)): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*")) if p.suffix in (".jpg", ".png", ".tif")}


@pytest.mark.parametrize("name", list(STACKS))
def test_preprocess_ecm_cli_matches_jax(tmp_path, capsys, name):
    """``adipose-torch preprocess-ecm`` against ``adipose preprocess-ecm`` on
    the same folder: the same files (visualizations and the test-mode
    sample included), processing_log.json equal but its timestamp, the same
    printed line. Lossless outputs within the stack's bound. A JPEG spreads
    a pixel's level over its 8x8 block, so each JPEG is held to be the
    quality-95 encoding of its package's array, and the arrays to the bound."""
    fields, flags = STACKS[name]
    src = _write_ecm_inputs(tmp_path / "in")
    jax_main(["preprocess-ecm", "--input-dir", str(src), "--output-dir", str(tmp_path / "jax"),
              *flags])
    want_line = capsys.readouterr().out
    torch_main(["preprocess-ecm", "--input-dir", str(src), "--output-dir",
                str(tmp_path / "torch"), *flags, "--device", "cpu"])
    assert capsys.readouterr().out == want_line
    logs = [json.loads((tmp_path / d / "processing_log.json").read_text())
            for d in ("jax", "torch")]
    for log in logs:
        log.pop("timestamp")
    assert logs[0] == logs[1] and not logs[0]["errors"]
    want, got = _images(tmp_path / "jax"), _images(tmp_path / "torch")
    assert list(got) == list(want) and want
    for rel, img in want.items():
        if rel.startswith("visualizations"):
            continue  # before|after, quality 90: the outputs' check covers it
        if rel.endswith(".jpg"):
            gray = cv2.imread(str(src / rel), cv2.IMREAD_GRAYSCALE)
            arrays = (jax_ecm.preprocess_ecm_image(gray, JaxECMConfig(**fields)),
                      ecm.preprocess_ecm_image(gray, ECMPreprocessConfig(**fields), "cpu"))
            for d, arr in zip(("jax", "torch"), arrays):
                assert (tmp_path / d / rel).read_bytes() == cv2.imencode(
                    ".jpg", arr, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
            _assert_u8_close(arrays[1], arrays[0], *_stack_bound(name))
        else:
            _assert_u8_close(got[rel], img, *_stack_bound(name))


def test_ecm_config_matches_jax():
    """The same fields, order and defaults: processing_log.json's config."""
    assert list(vars(ECMPreprocessConfig())) == list(vars(JaxECMConfig()))
    assert dataclasses.asdict(ECMPreprocessConfig()) == dataclasses.asdict(JaxECMConfig())


def test_ecm_on_a_missing_card_raises(tmp_path):
    """No fallback: the default device is the card, and without one the
    driver raises before it lists a file."""
    src = _write_ecm_inputs(tmp_path / "in")
    with pytest.raises((RuntimeError, AssertionError)):
        ecm.process_directory(src, tmp_path / "out")
    with pytest.raises((RuntimeError, AssertionError)):
        ecm.preprocess_ecm_image(ecm_image(16, 16))
