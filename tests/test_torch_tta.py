"""D4 test-time augmentation, the blend and the sliding window on the CPU:
the port (``adipose_tpu_torch/ops/d4.py``, ``eval/tta.py``,
``ops/blend.py``, ``eval/sliding_window.py``) against the JAX package on
the same inputs, made from a seed with numpy.

On the CPU the D4 kernel's and the z-score kernel's wrappers run their
plain versions, which are bit-equal to the kernels (``chip_smoke.py``
holds them so on the card), so these bounds hold for the kernel path too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.eval.sliding_window import SlidingWindowInference as JaxSlidingWindow
from adipose_tpu.eval.tta import make_classifier_tta_predict as jax_classifier_tta
from adipose_tpu.eval.tta import make_tta_predict as jax_make_tta_predict
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.ops import blend as jax_blend
from adipose_tpu.ops import d4 as jax_d4
from adipose_tpu.train.state import make_unet_predict as jax_make_unet_predict
from adipose_tpu_torch.eval.sliding_window import SlidingWindowInference
from adipose_tpu_torch.eval.tta import make_classifier_tta_predict, make_tta_predict
from adipose_tpu_torch.models.convert import flax_unet_to_torch
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops import blend, d4
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.train.state import make_unet_predict

N = 64  # tile side
MEAN, STD = 127.0, 50.0
# Both U-Nets run in float32 on the CPU; their forwards differ by ~1e-6
# (tests/test_torch_unet.py holds them to 1e-4 against the goldens), and TTA
# and blending average such maps: 5e-5 leaves a margin of ten.
MAP_ATOL = 5e-5
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fast_jit(fn):
    """``jax.jit(fn)`` compiled once per argument shape without LLVM's
    optimization passes."""
    compiled = {}

    def call(*args):
        key = tuple((np.shape(a), np.asarray(a).dtype.str) for a in args[1:])
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(compiler_options=FAST)
        return compiled[key](*args)

    return call


@pytest.fixture(scope="module")
def unet():
    """(JAX params, torch params, JAX normalized predict, torch normalized
    predict) of a float32 DilatedUNet(init_nb=4), its z-score folded in as
    the evaluator folds it."""
    model = JaxUNet(init_nb=4, compute_dtype=jnp.float32)
    variables = fast_jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, N, N)))
    variables = jax.tree.map(np.asarray, variables)
    jax_base = jax_make_unet_predict(model)

    def jax_predict(params, tiles):
        return jax_base(params, (tiles - MEAN) / (STD + 1e-10))

    torch_model = DilatedUNet(init_nb=4, compute_dtype=torch.float32, device="meta")
    base = make_unet_predict(torch_model)

    def torch_predict(params, tiles):
        return base(params, fused_zscore_normalize(tiles, MEAN, STD)[0])

    return variables, flax_unet_to_torch(variables), jax_predict, torch_predict


def test_mode_tables_match_jax():
    """The id tables: equal."""
    assert d4.NUM_TRANSFORMS == jax_d4.NUM_TRANSFORMS
    assert d4.MODE_IDS == jax_d4.MODE_IDS
    assert d4.CLASSIFIER_MODE_IDS == jax_d4.CLASSIFIER_MODE_IDS


@pytest.mark.parametrize("shape,num", [((8, 8), 8), ((6, 6, 3), 8), ((5, 5), 4)])
def test_expand_and_collapse_tta_bit_equal_jax(shape, num):
    """Bit-equal: permutations, and the mean summed in order and divided as
    XLA reduces it."""
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    views = d4.expand_tta(torch.from_numpy(x), num).numpy()
    want = np.asarray(jax_d4.expand_tta(jnp.asarray(x), num))
    assert np.array_equal(views, want)
    preds = np.random.RandomState(2).rand(num, *shape).astype(np.float32)
    got = d4.collapse_tta(torch.from_numpy(preds), num).numpy()
    assert np.array_equal(got, np.asarray(jax_d4.collapse_tta(jnp.asarray(preds), num)))


def test_tta_views_are_view_major():
    """View k * B + b is image b under ids[k], JAX's (n, B) order, and the
    collapse undoes each view with its own inverse."""
    x = torch.from_numpy(np.random.RandomState(4).rand(3, 8, 8).astype(np.float32))
    ids = d4.MODE_IDS["basic"]
    vids = d4.tta_view_ids(ids, 3, "cpu")
    views = d4.tta_views(x, vids)
    for k, t in enumerate(ids):
        for b in range(3):
            assert torch.equal(views[k * 3 + b], d4.apply_transform(x[b], t))
    assert torch.equal(d4.tta_collapse(views, vids, len(ids)), x)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("mode", ["minimal", "basic", "full"])
def test_make_tta_predict_matches_jax(unet, mode, dtype):
    """The U-Net under TTA: bound MAP_ATOL (the two float32 forwards, averaged)."""
    jax_params, params, jax_predict, torch_predict = unet
    rs = np.random.RandomState(5)
    tiles = (rs.rand(2, N, N) * 255).astype(np.float32)
    tiles[:, : N // 2] *= 0.5  # not D4-invariant
    tiles = tiles.astype(dtype)
    want = np.asarray(fast_jit(jax_make_tta_predict(jax_predict, mode))(jax_params, tiles))
    got = make_tta_predict(torch_predict, mode)(params, torch.from_numpy(tiles)).numpy()
    plain = torch_predict(params, torch.from_numpy(tiles.astype(np.float32))).numpy()
    assert got.shape == (2, N, N) and got.dtype == np.float32
    assert np.abs(got - want).max() <= MAP_ATOL
    assert np.abs(got - plain).max() > 10 * MAP_ATOL  # the views really differ


def _jax_toy_classifier(_, images):
    """A predict that is not D4-invariant: sigmoid of a row-weighted mean,
    in [0.01, 0.99] so the logits stay finite."""
    ramp = jnp.arange(images.shape[1], dtype=jnp.float32) / images.shape[1]
    ramp = ramp.reshape((-1,) + (1,) * (images.ndim - 2))
    s = jnp.mean(images * ramp, axis=tuple(range(1, images.ndim)))
    return jnp.clip(1 / (1 + jnp.exp(-(s - 0.25) * 8.0)), 0.01, 0.99)


def _toy_classifier(_, images):
    """:func:`_jax_toy_classifier` in torch."""
    ramp = torch.arange(images.shape[1], dtype=torch.float32) / images.shape[1]
    ramp = ramp.reshape((-1,) + (1,) * (images.dim() - 2))
    s = (images * ramp).mean(dim=tuple(range(1, images.dim())))
    return torch.clamp(1 / (1 + torch.exp(-(s - 0.25) * 8.0)), 0.01, 0.99)


@pytest.mark.parametrize("logit_space", [True, False])
@pytest.mark.parametrize("shape", [(3, 8, 8), (3, 8, 8, 3)])
@pytest.mark.parametrize("mode", ["basic", "full"])
def test_classifier_tta_matches_jax(shape, logit_space, mode):
    """Bound 1e-6: the same float32 arithmetic on bit-equal views; the
    means and the exp differ in the last bits."""
    x = np.random.RandomState(6).rand(*shape).astype(np.float32)
    want = np.asarray(fast_jit(jax_classifier_tta(_jax_toy_classifier, mode, logit_space))(
        None, x))
    got = make_classifier_tta_predict(_toy_classifier, mode, logit_space)(
        None, torch.from_numpy(x)).numpy()
    assert got.shape == (3,)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("mode", ["gaussian", "linear"])
def test_blend_tiles_matches_jax(mode):
    """Bound 1e-6: the same float32 products, summed in the same tile order."""
    rs = np.random.RandomState(7)
    positions = blend.sliding_window_positions((100, 140), 32, 0.5)
    tiles = rs.rand(len(positions), 32, 32).astype(np.float32)
    fn = {"gaussian": (blend.blend_tiles_gaussian, jax_blend.blend_tiles_gaussian),
          "linear": (blend.blend_tiles_linear, jax_blend.blend_tiles_linear)}[mode]
    got = fn[0](torch.from_numpy(tiles), positions, (100, 140)).numpy()
    want = np.asarray(fn[1](tiles, positions, (100, 140)))
    assert got.shape == (100, 140)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("overlap,blend_mode,shape", [
    (0.5, "gaussian", (100, 130)),
    (0.75, "gaussian", (100, 130)),
    (0.5, "linear", (100, 130)),
    (0.75, "none", (100, 130)),
    (0.5, "gaussian", (40, 50)),  # smaller than the tile: reflect-padded
])
def test_sliding_window_matches_jax(unet, overlap, blend_mode, shape):
    """The U-Net over the window, float32 maps: bound MAP_ATOL."""
    jax_params, params, jax_predict, torch_predict = unet
    img = (np.random.RandomState(8).rand(*shape) * 255).astype(np.float32)
    kw = dict(tile_size=N, overlap=overlap, blend_mode=blend_mode, batch_size=4)
    want = JaxSlidingWindow(**kw).predict(fast_jit(jax_predict), jax_params, img)
    got = SlidingWindowInference(**kw, device="cpu").predict(torch_predict, params, img)
    assert got.shape == shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= MAP_ATOL


@pytest.mark.parametrize("shape", [(100, 130), (40, 50)])
def test_sliding_window_float16_transfer_matches_jax(shape):
    """With float16 transfer the blended map is rounded once, on the device.
    A predict that both sides compute exactly (a scale by a power of two)
    and the linear blend (the Gaussian map's exp differs in its last bit
    between XLA and torch) make the float32 maps bit-equal, so the rounded
    maps are equal too: bound 0."""
    img = (np.random.RandomState(9).rand(*shape) * 255).astype(np.float32)
    kw = dict(tile_size=N, overlap=0.5, blend_mode="linear", batch_size=3,
              transfer_dtype="float16")
    want = JaxSlidingWindow(**kw).predict(jax.jit(lambda _, t: t * 2.0 ** -8), None, img)
    got = SlidingWindowInference(**kw, device="cpu").predict(lambda _, t: t * 2.0 ** -8,
                                                             None, img)
    f32 = SlidingWindowInference(**{**kw, "transfer_dtype": "float32"}, device="cpu").predict(
        lambda _, t: t * 2.0 ** -8, None, img)
    assert got.shape == shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, f32.astype(np.float16).astype(np.float32))
    assert np.abs(got - img * 2.0 ** -8).max() <= 2.0 ** -11  # reflect pad and blend exact
