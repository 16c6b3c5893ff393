"""The WSI chunkers and the modality tools on the CPU: the port's
``generate_axis_segments``, ``convert_16_to_8bit``, ``enhance``, SSIM, the
histogram correlation, ``compute_metrics`` and ``stratified_sample``, and
``adipose-torch chunk-wsi``, ``compare-modalities``, ``scale-ecm`` and
``tif2jpg`` against the JAX package's, on seeded 8- and 16-bit slides of at
most 600 x 700 cut into 256^2 chunks. Every bound is stated beside its test.
"""

import csv
import dataclasses
import struct
import zlib
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.core import native as jax_native
from adipose_tpu.core.config import WSIChunkConfig as JaxWSIChunkConfig
from adipose_tpu.wsi import chunker as jax_chunker
from adipose_tpu.wsi import compare as jax_compare
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import WSIChunkConfig
from adipose_tpu_torch.wsi import chunker, compare

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# Enhanced chunks: float32 in [0, 255] truncated to uint8. The z-score's and
# CLAHE's sums run in other orders (up to 4.6e-5 before the truncation), so
# a pixel on a level boundary may move by one level: measured for CLAHE in up
# to 3.3e-4 of the pixels, for the z-score and percentile stretch in none.
U8_LEVELS, U8_SHARE = 1, 1e-3
# SSIM: five 11 x 11 float32 convolutions (XLA's and oneDNN's summation
# orders) and the variance differences mu_aa - mu_a^2 over [0, 255]^2
# values: measured up to 2.6e-6. MSE and the histogram correlation: float32
# sums in other orders (measured equal here).
SSIM_ATOL = 1e-5
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_u16_by_numpy(monkeypatch):
    """The JAX package converts 16-bit images through its native library
    when that is built; built with OpenMP, it fills its lookup table in one
    thread only (tests/test_native_stain_vis.py fails on it). The reference
    here is the package's own numpy path, which the port copies."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def slide16(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded 16-bit grayscale slide: tissue-like texture over a dim
    background, vertical banding and noise, in 900..41000."""
    rs = np.random.RandomState(seed)
    coarse = cv2.resize(rs.rand(h // 32 + 2, w // 32 + 2).astype(np.float32), (w, h),
                        interpolation=cv2.INTER_CUBIC)
    fine = cv2.GaussianBlur(rs.rand(h, w).astype(np.float32), (0, 0), 2.0)
    band = 2500.0 * np.sin(np.arange(w) * 2 * np.pi / 37.0)[None, :]
    img = 3000 + 30000 * coarse * (0.6 + fine) + band + rs.normal(0.0, 400.0, (h, w))
    return np.clip(img, 900, 41000).astype(np.uint16)


def slide8(h: int, w: int, seed: int) -> np.ndarray:
    return chunker.convert_16_to_8bit(slide16(h, w, seed))


def _jax(fn, *args):
    """``jax.jit(fn)`` compiled without XLA's CPU optimizations, called."""
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args))


def _assert_u8_close(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= U8_LEVELS and (d > 0).mean() <= U8_SHARE, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("multiple", [1024, 512, 100])
def test_generate_axis_segments_are_jax_s(multiple):
    """The coordinate contract, span for span, over every length to 14000 in
    steps of 7 (and the edges), at primary tiles 6144 and 256."""
    for primary in (6144, 256):
        for length in list(range(-1, 14000, 7)) + [6144, 12288, 13112, 256, 512]:
            assert chunker.generate_axis_segments(length, primary, multiple) == \
                jax_chunker.generate_axis_segments(length, primary, multiple)


def _u16_formula(img: np.ndarray) -> np.ndarray:
    """``adipose_tpu/core/native.py:100-103``, the numpy path."""
    lo, hi = int(img.min()), int(img.max())
    if hi == lo:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img.astype(np.float32) - lo) / (hi - lo) * 255).astype(np.uint8)


def test_convert_16_to_8bit_is_the_numpy_formula():
    """Bit-equal to the numpy formula and to the JAX function on 16-bit
    images of narrow, wide, full and constant ranges; 8-bit passes through
    and other depths are cast, as in the JAX package."""
    rs = np.random.RandomState(3)
    for lo, hi in ((0, 65535), (1000, 1007), (30000, 30255), (0, 1), (500, 501), (7, 7)):
        img = rs.randint(lo, hi + 1, (37, 53)).astype(np.uint16)
        got = chunker.convert_16_to_8bit(img)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _u16_formula(img))
        np.testing.assert_array_equal(got, jax_chunker.convert_16_to_8bit(img))
    u8 = rs.randint(0, 256, (5, 6)).astype(np.uint8)
    assert chunker.convert_16_to_8bit(u8) is u8
    i32 = rs.randint(0, 300, (5, 6)).astype(np.int32)
    np.testing.assert_array_equal(chunker.convert_16_to_8bit(i32),
                                  jax_chunker.convert_16_to_8bit(i32))


@pytest.mark.parametrize("method", ["zscore", "percentile", "clahe"])
@pytest.mark.parametrize("shape", [(128, 96), (67, 131)])
def test_enhance_matches_jax(method, shape):
    """Each enhancement of an 8-bit chunk within U8_LEVELS in U8_SHARE; the
    odd shape takes CLAHE's reflect padding to the 8 x 8 grid."""
    img = slide8(*shape, seed=4)
    _assert_u8_close(chunker.enhance(img, method, "cpu"), jax_chunker.enhance(img, method))


def _png_header_only(path: Path, w: int, h: int) -> None:
    """A PNG whose header claims w x h pixels, with no pixel data."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def slides(tmp_path_factory) -> Path:
    """A 16-bit TIFF slide (600 x 700) and an 8-bit PNG one (500 x 650) over
    the gate, a 200 x 250 PNG under it, a PNG header claiming 20000 x 9000
    (over PIL's 2 x 89,478,485-pixel bomb limit) and a text file."""
    root = tmp_path_factory.mktemp("slides")
    cv2.imwrite(str(root / "s16.tif"), slide16(600, 700, seed=1))
    cv2.imwrite(str(root / "s8.png"), slide8(500, 650, seed=2))
    cv2.imwrite(str(root / "small.png"), slide8(200, 250, seed=3))
    _png_header_only(root / "bomb.png", 20000, 9000)
    (root / "notes.txt").write_text("not a slide")
    return root


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


CHUNK = {  # name: flags after the input; the gate is lowered to 300 px
    "defaults": [],
    "clahe_save_enhanced_png": ["--enhancement", "clahe", "--save-enhanced",
                                "--output-format", "png"],
    "percentile_png": ["--enhancement-method", "percentile", "--output-format", "png"],
    "zscore_tif_invert": ["--enhancement", "zscore", "--output-format", "tif", "--invert"],
    "save_enhanced_only_png": ["--save-enhanced", "--output-format", "png"],
    "bit_depth_16_png": ["--bit-depth", "16", "--output-format", "png"],
    "grid": ["--mode", "grid", "--grid-tile", "256", "--grid-overlap", "32"],
    "dry_run": ["--dry-run"],
}


@pytest.mark.parametrize("name", list(CHUNK))
def test_chunk_wsi_cli_matches_jax(slides, tmp_path, capsys, name):
    """``adipose-torch chunk-wsi --input-dir`` against ``adipose chunk-wsi``:
    the same printed counts, the same file names; lossless chunks (PNG, TIFF)
    within U8_LEVELS in U8_SHARE, or equal where nothing was enhanced; JPEGs
    of unenhanced chunks equal in bytes."""
    flags = ["--input-dir", str(slides), "--primary-tile", "256", "--max-dimension-px", "300",
             *CHUNK[name]]
    jax_main(["chunk-wsi", "--output-dir", str(tmp_path / "jax"), *flags])
    want_out = capsys.readouterr().out
    torch_main(["chunk-wsi", "--output-dir", str(tmp_path / "torch"), *flags, "--device", "cpu"])
    assert capsys.readouterr().out == want_out
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert list(got) == list(want)
    assert bool(want) != (name == "dry_run")
    enhanced = "--enhancement" in flags or "--enhancement-method" in flags
    for rel, path in want.items():
        a = cv2.imread(str(got[rel]), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape
        if enhanced or rel.startswith("enhanced"):
            assert not rel.endswith(".jpg")
            _assert_u8_close(a, b)
        else:
            assert got[rel].read_bytes() == path.read_bytes(), rel


def test_chunk_directory_report_matches_jax(slides, tmp_path):
    """The directory driver's report: the bomb skipped as "unreadable" (PIL
    refuses its header, in both packages), the small slide as "small", the
    two slides chunked into the same planned names."""
    cfg = dict(primary_tile=256, max_dimension_px=300)
    got = chunker.chunk_directory(slides, tmp_path / "torch", WSIChunkConfig(**cfg),
                                  dry_run=True, device="cpu")
    want = jax_chunker.chunk_directory(slides, tmp_path / "jax", JaxWSIChunkConfig(**cfg),
                                       dry_run=True)
    assert got["skipped"] == want["skipped"] == [{"file": "bomb.png", "reason": "unreadable"},
                                                 {"file": "small.png", "reason": "small"}]
    assert got["processed"] == want["processed"] and len(got["processed"]) == 2
    assert [Path(o).name for o in got["outputs"]] == [Path(o).name for o in want["outputs"]]


def test_chunk_wsi_single_inputs_and_skip_existing_match_jax(slides, tmp_path, capsys):
    """``--input`` in both modes, then ``--skip-existing`` over the folder
    that holds those chunks: the same lines and files."""
    runs = [["--input", str(slides / "s16.tif"), "--primary-tile", "256"],
            ["--input", str(slides / "s8.png"), "--mode", "grid", "--grid-tile", "300"],
            ["--input-dir", str(slides), "--max-dimension-px", "300", "--skip-existing"]]
    for flags in runs:
        jax_main(["chunk-wsi", "--output-dir", str(tmp_path / "jax"), *flags])
        want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
        torch_main(["chunk-wsi", "--output-dir", str(tmp_path / "torch"), *flags,
                    "--device", "cpu"])
        assert capsys.readouterr().out.replace(str(tmp_path / "torch"), "OUT") == want_out
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert list(got) == list(want) and want
    assert all(got[rel].read_bytes() == p.read_bytes() for rel, p in want.items())


def test_wsi_chunk_config_matches_jax():
    assert dataclasses.asdict(WSIChunkConfig()) == dataclasses.asdict(JaxWSIChunkConfig())
    assert list(vars(WSIChunkConfig())) == list(vars(JaxWSIChunkConfig()))


@pytest.mark.parametrize("shape", [(64, 64), (67, 131)])
def test_ssim_and_histogram_correlation_match_jax(shape):
    """Two related images and an image with itself (SSIM 1, correlation 1)."""
    a, b = slide8(*shape, seed=5), slide8(*shape, seed=6) // 2 + slide8(*shape, seed=5) // 2
    for x, y in ((a, b), (a, a)):
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        assert abs(float(compare.ssim(xt, yt)) - float(_jax(jax_compare.ssim, x, y))) <= SSIM_ATOL
        np.testing.assert_allclose(float(compare.histogram_correlation(xt, yt)),
                                   float(_jax(jax_compare.histogram_correlation, x, y)),
                                   rtol=METRIC_RTOL)


def test_compute_metrics_and_stratified_sample_match_jax():
    """A same-shape pair and a pair resampled to the first's shape; the
    stratified pick over 2..40 names."""
    a = slide8(96, 128, seed=7)
    for b in (slide8(96, 128, seed=8), slide8(80, 100, seed=8)):
        got = compare.compute_metrics(a, b, device="cpu")
        want = jax_compare.compute_metrics(a, b)
        assert list(got) == list(want)
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=METRIC_RTOL)
        assert abs(got["ssim"] - want["ssim"]) <= SSIM_ATOL
        np.testing.assert_allclose(got["histogram_correlation"], want["histogram_correlation"],
                                   rtol=METRIC_RTOL)
    names = [f"t{i:02d}" for i in range(40)][::-1]
    for n in (2, 7, 40, 50):
        assert compare.stratified_sample(names, n) == jax_compare.stratified_sample(names, n)


@pytest.fixture(scope="module")
def modalities(tmp_path_factory) -> tuple[Path, Path]:
    """Pseudocolored and ECM folders: five pairs of the same size, three
    whose ECM is 3/4 size, one unpaired, in a scrambled creation order."""
    root = tmp_path_factory.mktemp("modalities")
    pseudo, ecm_dir = root / "pseudo", root / "ecm"
    pseudo.mkdir()
    ecm_dir.mkdir()
    for i in (4, 0, 7, 2, 6, 1, 3, 5, 8):
        p = slide8(72, 96, seed=10 + i)
        cv2.imwrite(str(pseudo / f"tile{i}.png"), cv2.merge([p, p // 2, 255 - p]))
        if i == 8:
            continue  # unpaired
        e = slide8(72, 96, seed=30 + i) // 2 + p // 2
        cv2.imwrite(str(ecm_dir / f"tile{i}.jpg"),
                    cv2.resize(e, (72, 54)) if i in (1, 3, 5) else e)
    return pseudo, ecm_dir


def _csv(path: Path) -> tuple[str, list[dict]]:
    text = path.read_text()
    return text.splitlines()[0], list(csv.DictReader(text.splitlines()))


@pytest.mark.parametrize("flags", [[], ["--n-samples", "3"],
                                   ["--n-perfect", "3", "--n-mismatch", "2"],
                                   ["--n-perfect", "2", "--seed", "3"]])
def test_compare_modalities_cli_matches_jax(modalities, tmp_path, capsys, flags):
    """``adipose-torch compare-modalities`` against ``adipose
    compare-modalities`` on the same folders: the same pairs, in the same
    order (stratified over the sorted pairs; by dimensions in the folder's
    listing order, then ``RandomState``); the CSV's header bytes equal and
    its values within SSIM_ATOL and METRIC_RTOL; each side-by-side
    comparison JPEG equal in bytes; the same printed line."""
    pseudo, ecm_dir = modalities
    base = ["compare-modalities", "--pseudo-dir", str(pseudo), "--ecm-dir", str(ecm_dir)]
    jax_main(base + ["--output-dir", str(tmp_path / "jax"), *flags])
    want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    torch_main(base + ["--output-dir", str(tmp_path / "torch"), *flags, "--device", "cpu"])
    assert capsys.readouterr().out.replace(str(tmp_path / "torch"), "OUT") == want_out
    (want_head, want), (got_head, got) = (_csv(tmp_path / d / "comparison_metrics.csv")
                                          for d in ("jax", "torch"))
    assert got_head == want_head == "tile,mse,ssim,histogram_correlation"
    assert [r["tile"] for r in got] == [r["tile"] for r in want] and want
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g["mse"]), float(w["mse"]), rtol=METRIC_RTOL)
        assert abs(float(g["ssim"]) - float(w["ssim"])) <= SSIM_ATOL
        np.testing.assert_allclose(float(g["histogram_correlation"]),
                                   float(w["histogram_correlation"]), rtol=METRIC_RTOL)
    jpgs = {rel: p for rel, p in _tree(tmp_path / "jax").items() if rel.endswith(".jpg")}
    assert sorted(jpgs) == sorted(rel for rel in _tree(tmp_path / "torch") if rel.endswith(".jpg"))
    assert all((tmp_path / "torch" / rel).read_bytes() == p.read_bytes()
               for rel, p in jpgs.items())


@pytest.mark.parametrize("flags", [[], ["--interpolation", "lanczos"], ["--dry-run"]])
def test_scale_ecm_cli_matches_jax(modalities, tmp_path, capsys, flags):
    """Host cv2 on both sides: the same lines and byte-identical files."""
    pseudo, ecm_dir = modalities
    base = ["scale-ecm", "--target-dir", str(ecm_dir), "--reference-dir", str(pseudo)]
    jax_main(base + ["--output-dir", str(tmp_path / "jax"), *flags])
    want_out = capsys.readouterr().out
    torch_main(base + ["--output-dir", str(tmp_path / "torch"), *flags])
    assert capsys.readouterr().out == want_out
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert list(got) == list(want) and bool(want) != ("--dry-run" in flags)
    assert all(got[rel].read_bytes() == p.read_bytes() for rel, p in want.items())


@pytest.mark.parametrize("flags", [[], ["--invert", "--quality", "80"], ["--dry-run"]])
def test_tif2jpg_cli_matches_jax(tmp_path, capsys, flags):
    """16-bit and 8-bit TIFFs (``*.tif`` then ``*.tiff``): the same lines and
    byte-identical JPEGs."""
    src = tmp_path / "in"
    src.mkdir()
    cv2.imwrite(str(src / "b.tif"), slide16(90, 70, seed=40))
    cv2.imwrite(str(src / "a.tiff"), slide8(50, 60, seed=41))
    cv2.imwrite(str(src / "c.tif"), np.full((20, 30), 1234, np.uint16))  # constant: all 0
    jax_main(["tif2jpg", "--input-dir", str(src), "--output-dir", str(tmp_path / "jax"), *flags])
    want_out = capsys.readouterr().out
    torch_main(["tif2jpg", "--input-dir", str(src), "--output-dir", str(tmp_path / "torch"),
                *flags])
    assert capsys.readouterr().out == want_out
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert list(got) == list(want) and bool(want) != ("--dry-run" in flags)
    assert all(got[rel].read_bytes() == p.read_bytes() for rel, p in want.items())


def test_device_work_on_a_missing_card_raises(slides, tmp_path):
    """No fallback: enhancement and the metrics default to the card, and
    without one they raise."""
    img = slide8(32, 32, seed=9)
    with pytest.raises((RuntimeError, AssertionError)):
        chunker.enhance(img, "clahe")
    with pytest.raises((RuntimeError, AssertionError)):
        compare.compute_metrics(img, img)
    with pytest.raises((RuntimeError, AssertionError)):
        torch_main(["chunk-wsi", "--input", str(slides / "s8.png"), "--primary-tile", "256",
                    "--enhancement", "clahe", "--output-dir", str(tmp_path)])
