"""The port's D4 transforms against the JAX package's ``ops/d4.py``.

A D4 transform is a permutation, so every comparison here is bit-equal.
``apply_transform_batch`` on a CPU tensor runs the D4 kernel's plain version
(the kernel itself is checked against it on the card by ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.ops import d4 as jax_d4
from adipose_tpu_torch.ops import d4
from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch, d4_transform_batch_plain


def _batch(n: int, b: int = 8) -> np.ndarray:
    return np.random.RandomState(n).rand(b, n, n).astype(np.float32)


@pytest.mark.parametrize("n", [64, 37])
def test_apply_and_invert_batch_match_jax_bit_equal(n):
    x = _batch(n)
    ids = np.random.RandomState(1).permutation(8).astype(np.int32)  # every id once
    got = d4.apply_transform_batch(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    back = d4.invert_transform_batch(torch.from_numpy(got), torch.from_numpy(ids)).numpy()

    def apply_then_invert(a, i):
        y = jax_d4.apply_transform_batch(a, i)
        return y, jax_d4.invert_transform_batch(y, i)

    want, want_back = jax.jit(apply_then_invert)(jnp.asarray(x), jnp.asarray(ids))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(back, np.asarray(want_back))
    assert np.array_equal(back, x)


def test_single_transforms_match_jax_and_the_batched_path():
    x = _batch(16, 1)[0]
    views = np.asarray(jax_d4.expand_tta(jnp.asarray(x), num=8))  # view t = apply_transform(x, t)
    for tid in range(8):
        got = d4.apply_transform(torch.from_numpy(x), tid).numpy()
        assert np.array_equal(got, views[tid]), tid
        batched = d4.apply_transform_batch(torch.from_numpy(x[None]), [tid])[0].numpy()
        assert np.array_equal(got, batched), tid
        inv = d4.invert_transform(torch.from_numpy(got), tid).numpy()
        assert np.array_equal(inv, x), tid


def test_non_square_raises_and_cpu_wrapper_is_the_plain_version():
    with pytest.raises(ValueError, match="needs \\(B, N, N\\)"):
        d4.apply_transform_batch(torch.zeros((2, 8, 9)), [0, 1])
    x = torch.from_numpy(_batch(12, 4))
    ids = torch.tensor([5, 0, 7, 2], dtype=torch.int32)
    before = d4_transform_batch.launches
    assert torch.equal(d4_transform_batch(x, ids), d4_transform_batch_plain(x, ids))
    assert d4_transform_batch.launches == before  # a CPU tensor launches nothing
