"""The port's percentile stretch on the CPU: the plain version of the CUDA
kernel against the JAX package's Pallas kernel in interpret mode, and the
port's sort path against ``jnp.percentile``. The CUDA kernel itself is held
bit-equal to the plain version on the GPU by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.ops.normalize import batched_percentile_unit as jax_batched_percentile_unit
from adipose_tpu.ops.pallas.preprocess import percentile_normalize_u8 as jax_percentile_u8
from adipose_tpu_torch.ops.cuda.percentile import (percentile_normalize_u8,
                                                   percentile_normalize_u8_plain)
from adipose_tpu_torch.ops.normalize import (batched_percentile_unit,
                                             batched_percentile_unit_fast, percentile_unit)


def _tiles(kind: str) -> np.ndarray:
    rs = np.random.RandomState(21)
    if kind == "constant":
        return np.full((3, 64, 64), 100, np.uint8)
    t = (rs.rand(3, 64, 64) * 255).astype(np.uint8)
    if kind == "70pct_one_value":  # a slide's background piles onto one bin
        t[rs.rand(*t.shape) < 0.7] = 240
    return t


@pytest.mark.parametrize("p", [(1.0, 99.0), (2.0, 98.0)])
@pytest.mark.parametrize("kind", ["uniform", "constant", "70pct_one_value"])
def test_plain_is_bit_equal_to_pallas(kind, p):
    tiles = _tiles(kind)
    want = np.asarray(jax_percentile_u8(jnp.asarray(tiles), *p, interpret=True))
    for x in (torch.from_numpy(tiles), torch.from_numpy(tiles.astype(np.float32))):
        got = percentile_normalize_u8_plain(x, *p)
        assert got.dtype == torch.float32 and got.shape == tiles.shape
        assert np.array_equal(got.numpy(), want)
    if kind == "constant":
        assert np.all(want == 0.0)  # zero range: (x - low) / 1e-3 = 0


def test_plain_rounds_fractional_input_first():
    """Fractional input is rounded half to even before binning, as
    ``batched_percentile_unit_fast`` rounds before the Pallas kernel
    (tests/test_pallas.py::test_percentile_fractional_input_rounds_to_bins)."""
    frac = (np.random.RandomState(4).rand(2, 64, 64) * 255).astype(np.float32)
    frac[0, 0, :4] = [0.5, 1.5, 2.5, 254.5]  # ties round to even
    want = np.asarray(jax_percentile_u8(jnp.round(jnp.asarray(frac)), 1.0, 99.0,
                                        interpret=True))
    assert np.array_equal(percentile_normalize_u8_plain(torch.from_numpy(frac)).numpy(), want)


def test_sort_path_is_bit_equal_to_jnp_percentile():
    """``batched_percentile_unit`` repeats jnp's f32 rank and its
    ``v[lo] * (1 - w) + v[hi] * w``: bit-equal on uint8-valued input. The
    histogram kernel interpolates as the Pallas kernel does,
    ``v[lo] + frac * (v[hi] - v[lo])`` with the fraction from a double
    rank, so it differs from this path by a few ulp (the two JAX functions
    differ from each other the same way)."""
    for kind in ("uniform", "70pct_one_value"):
        x = _tiles(kind).astype(np.float32)
        want = np.asarray(jax_batched_percentile_unit(jnp.asarray(x), 1.0, 99.0))
        got = batched_percentile_unit(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(percentile_unit(torch.from_numpy(x[0])).numpy(), want[0])
        hist = percentile_normalize_u8_plain(torch.from_numpy(x)).numpy()
        assert np.abs(hist - want).max() <= 1e-6


def test_fast_dispatch_grayscale_to_kernel_rgb_to_sort():
    tiles = torch.from_numpy(_tiles("uniform"))
    assert torch.equal(batched_percentile_unit_fast(tiles, 2.0, 98.0),
                       percentile_normalize_u8(tiles, 2.0, 98.0))
    rgb = (np.random.RandomState(8).rand(2, 32, 48, 3) * 255).astype(np.float32)
    want = np.asarray(jax_batched_percentile_unit(jnp.asarray(rgb), 1.0, 99.0))
    got = batched_percentile_unit_fast(torch.from_numpy(rgb)).numpy()
    # fractional RGB input: XLA's CPU division is not IEEE (a few ulp)
    assert got.shape == rgb.shape and np.abs(got - want).max() <= 1e-6


def test_wrapper_runs_plain_only_on_cpu_and_raises_elsewhere():
    percentile_normalize_u8(torch.zeros(2, 8, 8, dtype=torch.uint8))
    assert percentile_normalize_u8.launches == 0
    with pytest.raises(TypeError):
        percentile_normalize_u8(torch.empty(1, 8, 8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        percentile_normalize_u8(torch.empty(1, 8, 8, 3, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        percentile_normalize_u8(torch.empty(1, 8, 8, dtype=torch.uint8, device="meta"))
