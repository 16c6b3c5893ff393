"""The port's InceptionV3 classifier and its input path against the JAX
package's, on converted Flax variables. The JAX side is built with
``jax.eval_shape`` and run under one ``jax.jit``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.models.inception import InceptionV3Classifier as JaxInception
from adipose_tpu.train.trainer_classifier import (
    make_inception_preprocess as jax_make_inception_preprocess)
from adipose_tpu_torch.models.convert import (flax_inception_to_torch, load_flax_npz,
                                              save_flax_npz, torch_inception_to_flax)
from adipose_tpu_torch.models.inception import InceptionV3Classifier
from adipose_tpu_torch.train.trainer_classifier import make_inception_preprocess

TESTS = Path(__file__).parent


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU: a small intra-op
    pool keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle_variables():
    """The seeded InceptionV3 stream that golden_tf_oracle.npz was made with,
    in the Flax layout (numpy)."""
    from tf_oracle_util import fill_flax_inception, seeded_inception_weights

    shapes = jax.eval_shape(JaxInception(dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 75, 75, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return fill_flax_inception(zeros, seeded_inception_weights(321))


@pytest.fixture(scope="module")
def oracle_input():
    """tests/test_golden.py's classifier input (2, 299, 299, 3)."""
    return np.random.RandomState(11).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)


def torch_classify(variables, x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    model = InceptionV3Classifier(compute_dtype=dtype, device="meta").eval()
    with torch.inference_mode():
        out = torch.func.functional_call(model, flax_inception_to_torch(variables),
                                         (torch.from_numpy(x),), strict=True)
    return out.numpy()


def test_forward_matches_tf_reference_golden(oracle_variables, oracle_input):
    """f32 against the reference implementation's probabilities at
    tests/test_golden.py's bound (measured 1.2e-7)."""
    want = np.load(TESTS / "golden_tf_oracle.npz")["inception/probs"]
    got = torch_classify(oracle_variables, oracle_input, torch.float32)
    assert got.shape == (2,) and np.abs(got - want).max() <= 1e-5


def test_bf16_forward_matches_live_jax(oracle_variables, oracle_input):
    """bf16 compute on both sides, the serving configuration. The two round
    to bf16 at the same points (conv outputs, pool sums, ConvBN outputs);
    conv accumulation orders differ. Measured at this input: 6.2e-4."""
    want = np.asarray(jax.jit(JaxInception(dtype=jnp.bfloat16).apply)(
        oracle_variables, jnp.asarray(oracle_input)))
    got = torch_classify(oracle_variables, oracle_input, torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-3


def test_converter_round_trips_through_npz(oracle_variables, tmp_path):
    state = flax_inception_to_torch(oracle_variables)
    assert state["backbone.cbn_0.conv.weight"].shape == (32, 3, 3, 3)  # OIHW
    assert state["backbone.cbn_32.conv.weight"].shape == (128, 128, 1, 7)  # (kh, kw) kept
    assert state["backbone.cbn_33.conv.weight"].shape == (192, 128, 7, 1)
    assert state["adipose_score.weight"].shape == (1, 2048)
    model = InceptionV3Classifier(device="meta")
    assert set(state) == set(model.state_dict())
    back = load_flax_npz(save_flax_npz(torch_inception_to_flax(state), tmp_path / "p.npz"))
    want = jax.tree_util.tree_flatten_with_path(oracle_variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want) == 4 * 94 + 2
    for key, leaf in want:
        assert np.array_equal(got[key], leaf), key


def test_seeded_init_is_deterministic_and_fills_every_variable():
    a = InceptionV3Classifier().init_params(torch.Generator().manual_seed(3))
    b = InceptionV3Classifier().init_params(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y) and torch.isfinite(x).all(), name
    assert (a.backbone.cbn_5.bn.var >= 0.5).all()


@pytest.mark.parametrize("size", [64, 1024])
def test_preprocess_matches_jax(size):
    """Percentile stretch, antialiased bilinear resize to 299^2, 3 channels,
    x / 127.5 - 1. Without ``antialias=True`` a 1024^2 tile differs by up
    to 139 grey levels; with it the two agree to float32 rounding of the
    resize weights."""
    tiles = (np.random.RandomState(size).rand(2, size, size) * 255).astype(np.uint8)
    want = np.asarray(jax.jit(jax_make_inception_preprocess(True, 1.0, 99.0))(
        jnp.asarray(tiles)))
    got = make_inception_preprocess(True, 1.0, 99.0)(torch.from_numpy(tiles))
    assert got.shape == want.shape == (2, 299, 299, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-3

