"""The dual-model WSI cascade on the CPU: the port's QC, blend and
``DualModelWSIPipeline`` against the JAX package's, and ``adipose-torch
pipeline`` against ``adipose pipeline``."""

import importlib.util
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.cli.main import main as jax_main
from adipose_tpu.models.inception import InceptionV3Classifier as JaxInception
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.ops import blend as jax_blend
from adipose_tpu.ops import qc as jax_qc
from adipose_tpu.train import checkpoint as jax_ckpt
from adipose_tpu.train.state import make_unet_predict as jax_make_unet_predict
from adipose_tpu.train.trainer_classifier import _make_val_step as jax_make_val_step
from adipose_tpu.wsi.pipeline import DualModelWSIPipeline as JaxPipeline
from adipose_tpu_torch.serving.predict import load_classifier, load_segmenter
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.models.convert import (flax_inception_to_torch, flax_unet_to_torch,
                                              torch_unet_to_flax)
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops import blend, qc
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.train.state import make_unet_predict
from adipose_tpu_torch.train.trainer_classifier import _make_val_step
from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

ROOT = Path(__file__).resolve().parents[1]
MEAN, STD = 127.0, 60.0
# bf16 U-Nets differ by at most 2e-3 (tests/test_torch_unet.py); blending
# averages such differences and the float16 copy adds at most 2.4e-4 near
# 0.5, so a mask pixel may flip only this close to the threshold.
MASK_FLIP_BAND = 2.5e-3


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU: a small intra-op
    pool keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _slide(shape=(160, 224), seed=0) -> np.ndarray:
    """Textured uint8 slide with a white quarter (QC-empty tiles) and a flat
    quarter (QC-blurry tiles)."""
    h, w = shape
    s = (np.random.RandomState(seed).rand(h, w) * 200 + 20).astype(np.uint8)
    s[: h // 2, : w // 2] = 250
    s[h // 2 :, w // 2 :] = 120
    return s


@pytest.fixture(scope="module")
def weights():
    """Flax variables of the seeded InceptionV3 (the TF-oracle stream) and
    of a seeded init_nb 4 U-Net, as numpy trees."""
    from tf_oracle_util import fill_flax_inception, seeded_inception_weights

    shapes = jax.eval_shape(JaxInception(dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 75, 75, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    cls_vars = fill_flax_inception(zeros, seeded_inception_weights(321))
    unet = DilatedUNet(init_nb=4).init_params(torch.Generator().manual_seed(5))
    return cls_vars, torch_unet_to_flax(unet.state_dict())


# ---- QC and blend ----------------------------------------------------------

def _qc_tiles() -> np.ndarray:
    rs = np.random.RandomState(3)
    t = (rs.rand(6, 48, 40) * 255).astype(np.float32)
    t[1] = 250.0                       # empty
    t[2] = 100.0                       # blurry
    t[3, :, :30] = 240.0               # 75% white
    t[4] = np.round(t[4] / 64) * 0.5 + 100  # low-variance texture
    return t


@pytest.mark.parametrize("rgb", [False, True])
def test_qc_matches_jax(rgb):
    tiles = _qc_tiles()
    if rgb:
        tiles = np.stack([tiles, tiles[:, ::-1], np.roll(tiles, 3, axis=2)], -1)
    want = jax.tree.map(np.asarray, jax_qc.classify_tiles_batch(jnp.asarray(tiles),
                                                                235.0, 0.70, 7.5))
    got = {k: v.numpy() for k, v in qc.classify_tiles_batch(torch.from_numpy(tiles)).items()}
    assert got.keys() == want.keys()
    for k in ("is_empty", "is_blurry", "is_good"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["white_ratio"], want["white_ratio"])
    np.testing.assert_allclose(got["laplacian_var"], want["laplacian_var"], rtol=1e-5)
    assert want["is_good"].sum() not in (0, len(tiles))
    one = qc.classify_tile(torch.from_numpy(tiles[0]))
    assert bool(one["is_good"]) == bool(want["is_good"][0])


@pytest.mark.parametrize("shape,tile,overlap", [((160, 224), 64, 0.0), ((160, 224), 64, 0.25),
                                                ((100, 50), 64, 0.5), ((1024, 3000), 1024, 0.9)])
def test_sliding_window_positions_match_jax(shape, tile, overlap):
    want = jax_blend.sliding_window_positions(shape, tile, overlap)
    got = blend.sliding_window_positions(shape, tile, overlap)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_blend_matches_jax():
    rs = np.random.RandomState(9)
    t, shape = 32, (80, 72)
    positions = blend.sliding_window_positions(shape, t, 0.25)
    n = len(positions)
    tiles = rs.rand(n, t, t).astype(np.float32)
    valid = (np.arange(n) < n - 2).astype(np.float32)  # two pad entries
    wm = blend.gaussian_weight_map(t)
    jwm = jax_blend.gaussian_weight_map(t)
    assert np.abs(wm.numpy() - np.asarray(jwm)).max() <= 1e-6
    jpos = jnp.asarray(positions)
    jacc = jax_blend.accumulate_predictions(jnp.zeros(shape), jnp.asarray(tiles), jpos, jwm,
                                            jnp.asarray(valid))
    jw = jax_blend.accumulate_weights(jnp.zeros(shape), jpos, jwm, jnp.asarray(valid))
    acc = torch.zeros(shape)
    assert blend.accumulate_predictions(acc, torch.from_numpy(tiles), positions, wm,
                                        valid) is acc  # in place
    w = blend.accumulate_weights(torch.zeros(shape), positions, wm, valid)
    assert np.abs(acc.numpy() - np.asarray(jacc)).max() <= 1e-6
    assert np.abs(w.numpy() - np.asarray(jw)).max() <= 1e-6
    want = np.asarray(jax_blend.finalize_blend(jacc, jw))
    assert np.abs(blend.finalize_blend(acc, w).numpy() - want).max() <= 1e-6
    stripe = blend.finalize_blend_stripe(acc, w, 24, 24, out_dtype="float32").numpy()
    assert np.abs(stripe - want[24:48]).max() <= 1e-6
    for got_u8, want_u8, ref in (
            (blend.finalize_blend_u8(acc, w), jax_blend.finalize_blend_u8(jacc, jw), want),
            (blend.finalize_blend_stripe(acc, w, 24, 24),
             jax_blend.finalize_blend_stripe(jacc, jw, 24, 24, out_dtype="uint8"), want[24:48])):
        got_u8, want_u8 = got_u8.numpy(), np.asarray(want_u8)
        assert got_u8.dtype == np.uint8
        # exact except where the value sits within 1e-6 of a level boundary
        level = np.clip(ref, 0, 1) * 255
        near = np.abs(level - np.round(level)) <= 255e-6
        assert np.array_equal(got_u8[~near], want_u8[~near])
    f16 = blend.finalize_blend_stripe(acc, w, 0, 24, out_dtype="float16").numpy()
    assert f16.dtype == np.float16
    assert np.array_equal(f16, np.asarray(jax_blend.finalize_blend_stripe(
        jacc, jw, 0, 24, out_dtype="float16")))


def test_extract_tiles_matches_jax():
    slide = _slide((96, 80))
    pos = blend.sliding_window_positions(slide.shape, 32, 0.5)
    want = np.asarray(jax_blend.extract_tiles(jnp.asarray(slide), jnp.asarray(pos), 32))
    assert np.array_equal(blend.extract_tiles(torch.from_numpy(slide), pos, 32).numpy(), want)


# ---- the pipeline, f32 ------------------------------------------------------

def _pipelines(weights, **kw):
    cls_vars, unet_tree = weights
    jax_val = jax_make_val_step(JaxInception(dtype=jnp.float32), True, 1.0, 99.0)
    jax_unet = jax_make_unet_predict(JaxUNet(init_nb=4, compute_dtype=jnp.float32))
    jax_pipe = JaxPipeline(
        lambda v, t: jax_val(v["params"], v["batch_stats"], t), cls_vars,
        lambda p, t: jax_unet(p, (t - MEAN) / (STD + 1e-10)), unet_tree, **kw)
    unet = make_unet_predict(DilatedUNet(init_nb=4, compute_dtype=torch.float32,
                                         device="meta"))
    pipe = DualModelWSIPipeline(
        _make_val_step(InceptionV3Classifier(compute_dtype=torch.float32, device="meta"),
                       True, 1.0, 99.0),
        flax_inception_to_torch(cls_vars),
        lambda p, t: unet(p, fused_zscore_normalize(t, MEAN, STD)[0]),
        flax_unet_to_torch(unet_tree), device="cpu", **kw)
    return jax_pipe, pipe


def _threshold_between(probs: np.ndarray) -> float:
    """A classifier threshold in the widest gap between the sorted
    probabilities (both sides non-empty), at least 1e-3 from every one."""
    p = np.sort(probs)
    gaps = np.diff(p)
    i = int(np.argmax(gaps))
    assert gaps[i] >= 2e-3, p
    return float(p[i] + gaps[i] / 2)


def test_pipeline_matches_jax_f32(weights):
    """Same weights and slide through both cascades with f32 models. The
    classifier threshold splits the QC-good tiles, so the gate is tested."""
    slide = _slide()
    kw = dict(tile_size=64, batch_size=4, transfer_dtype="float32")
    jax_pipe, pipe = _pipelines(weights, **kw)
    tiles = blend.extract_tiles(torch.from_numpy(slide),
                                blend.sliding_window_positions(slide.shape, 64, 0.0), 64)
    good = tiles[qc.classify_tiles_batch(tiles)["is_good"]]
    threshold = _threshold_between(pipe.classifier_predict(pipe.classifier_variables,
                                                           good).numpy())
    results = {}
    for overlap in (0.25, 0.0):  # run_many below runs at 0.0
        for p in (jax_pipe, pipe):
            p.overlap, p.classifier_threshold = overlap, threshold
        want, got = jax_pipe.run(slide), pipe.run(slide)
        counts = (got.n_tiles, got.n_good, got.n_positive)
        assert counts == (want.n_tiles, want.n_good, want.n_positive)
        assert 0 < got.n_positive < got.n_good < got.n_tiles, counts
        assert got.probability_map.shape == slide.shape
        assert np.abs(got.probability_map - want.probability_map).max() <= 1e-4
        assert set(got.timings) == set(want.timings)
        results[overlap] = got
    # run_many pipelines the two chunks and must equal separate run() calls
    second = _slide((64, 128), seed=1)
    single = pipe.run(second)
    many = pipe.run_many([slide, second])
    for a, b in zip(many, [results[0.0], single]):
        assert (a.n_tiles, a.n_good, a.n_positive) == (b.n_tiles, b.n_good, b.n_positive)
        assert np.array_equal(a.probability_map, b.probability_map)
        assert a.timings["pipelined"] and not b.timings["pipelined"]


def test_host_tiling_and_u8_transfer_match_device_tiling(weights):
    _, pipe = _pipelines(weights, tile_size=64, batch_size=4, classifier_threshold=0.0)
    slide = _slide((96, 128), seed=2)
    ref = pipe.run(slide)
    pipe.device_tiling, pipe.transfer_dtype = False, "uint8"
    got = pipe.run(slide)
    assert (got.n_tiles, got.n_good, got.n_positive) == (ref.n_tiles, ref.n_good, ref.n_positive)
    want_u8 = blend._quantize_u8(torch.from_numpy(ref.probability_map)).numpy()
    assert got.probability_u8.dtype == np.uint8
    # ref went through a float16 copy: a level may differ by one
    assert np.abs(got.probability_u8.astype(int) - want_u8).max() <= 1


@pytest.mark.parametrize("device_tiling", [True, False])
def test_the_routing_of_each_tile_agrees_with_the_counts(weights, device_tiling):
    _, pipe = _pipelines(weights, tile_size=64, batch_size=4, device_tiling=device_tiling)
    slides = [_slide(), _slide((100, 150), seed=3)]  # the second is cut with clamped origins
    pipe.classifier_threshold = float(np.median(
        [p for r in pipe.run_many(slides) for p in r.gate_prob[r.is_good]]))
    for slide, r in zip(slides, pipe.run_many(slides)):
        positions = blend.sliding_window_positions(slide.shape, 64, 0.0)
        np.testing.assert_array_equal(r.positions, positions)
        assert r.is_good.dtype == bool and r.gate_prob.dtype == np.float32
        assert r.is_good.shape == r.gate_prob.shape == (r.n_tiles,) == (len(positions),)
        assert int(r.is_good.sum()) == r.n_good
        assert int((r.is_good & (r.gate_prob >= pipe.classifier_threshold)).sum()) == \
            r.n_positive
        tiles = blend.extract_tiles(torch.from_numpy(slide), positions, 64)
        assert np.array_equal(r.is_good, qc.classify_tiles_batch(tiles)["is_good"].numpy())
    assert 0 < r.n_positive < r.n_good < r.n_tiles


# ---- the CLI ----------------------------------------------------------------

def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_flax_params_npz", ROOT / "scripts" / "export_flax_params_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipeline_cli_matches_jax_cli(weights, tmp_path):
    """``adipose pipeline`` and ``adipose-torch pipeline --device cpu`` (both
    bf16) on one chunk folder. ``--classifier-threshold 0`` makes the gate QC
    only, so bf16 noise cannot flip a classifier decision."""
    cls_vars, unet_tree = weights
    cls_run, seg_run, chunks = tmp_path / "cls", tmp_path / "seg", tmp_path / "chunks"
    for d in (cls_run, seg_run, chunks):
        d.mkdir()
    jax_ckpt.save_params(cls_run, "weights_best", cls_vars)
    jax_ckpt.save_params(seg_run, "weights_best_overall", unet_tree)
    jax_ckpt.save_normalization_stats(seg_run, MEAN, STD)
    (seg_run / "training_settings.log").write_text("init_nb: 4\ntile_size: 64\n")
    _export_script().main([str(cls_run), str(seg_run)])
    for name, shape, seed in (("a", (96, 128), 3), ("b", (64, 128), 4)):
        cv2.imwrite(str(chunks / f"{name}.png"), _slide(shape, seed))
    flags = ["--wsi-dir", str(chunks), "--classifier-weights", str(cls_run),
             "--segmenter-weights", str(seg_run), "--tile-size", "64",
             "--batch-size", "2", "--classifier-threshold", "0"]
    jax_main(["pipeline", "--output-dir", str(tmp_path / "jax"), *flags])
    torch_main(["pipeline", "--output-dir", str(tmp_path / "torch"), "--device", "cpu", *flags])

    names = lambda d: sorted(p.name for p in d.iterdir())  # noqa: E731
    assert names(tmp_path / "jax") == names(tmp_path / "torch")
    assert len(names(tmp_path / "torch")) == 7
    logs = [json.loads((tmp_path / side / "pipeline_log.json").read_text())
            for side in ("jax", "torch")]
    for key in ("n_chunks", "n_tiles", "n_positive"):
        assert logs[0][key] == logs[1][key], key
    for cj, ct in zip(logs[0]["chunks"], logs[1]["chunks"]):
        assert [cj[k] for k in ("chunk", "n_tiles", "n_good", "n_positive")] == \
               [ct[k] for k in ("chunk", "n_tiles", "n_good", "n_positive")]
        assert set(cj["timings"]) == set(ct["timings"])
    assert 0 < logs[1]["n_positive"] < logs[1]["n_tiles"]

    # the port's map as the CLI computed it, to locate mask flips
    seg_predict, seg_params, _, _ = load_segmenter(seg_run, device="cpu")
    cls_predict, cls_state = load_classifier(cls_run, device="cpu")
    pipe = DualModelWSIPipeline(cls_predict, cls_state, seg_predict, seg_params, tile_size=64,
                                batch_size=2, classifier_threshold=0.0, device="cpu")
    read = lambda side, f: cv2.imread(str(tmp_path / side / f), cv2.IMREAD_UNCHANGED)  # noqa: E731
    for name in ("a", "b"):
        prob = pipe.run(pipe._read_image(chunks / f"{name}.png")).probability_map
        mj, mt = read("jax", f"{name}_mask.png"), read("torch", f"{name}_mask.png")
        assert np.array_equal(mt, ((prob > 0.5) * 255).astype(np.uint8))
        assert np.all(np.abs(prob[mj != mt] - 0.5) <= MASK_FLIP_BAND)
        pj = read("jax", f"{name}_probability.png").astype(int)
        pt = read("torch", f"{name}_probability.png").astype(int)
        assert pt.shape == prob.shape and np.abs(pj - pt).max() <= 2
