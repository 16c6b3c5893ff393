"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas kernel run in interpret mode, as tests/test_pallas.py runs
it. The CUDA kernels themselves are compared with these plain versions on
the GPU by chip_smoke.py (pytest sees no GPU: conftest.py hides it)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.ops.normalize import zscore_dataset as jax_zscore_dataset
from adipose_tpu.ops.pallas.preprocess import fused_zscore_normalize as jax_fused_zscore
from adipose_tpu.ops.pallas.unet_kernels import diff_sigmoid_head as jax_diff_sigmoid_head
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.ops.cuda.unet_kernels import diff_sigmoid_head
from adipose_tpu_torch.ops.normalize import zscore_dataset

ROOT = Path(__file__).resolve().parents[1]


def _tiles(kind: str) -> np.ndarray:
    t = np.random.RandomState(11).rand(3, 64, 128) * 255
    if kind == "u8":
        return t.astype(np.uint8)
    return (np.floor(t) if kind == "f32_integral" else t).astype(np.float32)


def _exact_stats(tiles: np.ndarray) -> np.ndarray:
    f = tiles.astype(np.float64).reshape(tiles.shape[0], -1)
    return np.stack([f.mean(1), f.std(1), (f >= 235).mean(1)], 1)


@pytest.mark.parametrize("kind", ["u8", "f32_integral"])
def test_fused_zscore_plain_matches_pallas(kind):
    tiles = _tiles(kind)
    want_norm, want_stats = jax_fused_zscore(jnp.asarray(tiles), 127.0, 50.0, interpret=True)
    want_norm, want_stats = np.array(want_norm), np.array(want_stats)
    norm, stats = fused_zscore_normalize(torch.from_numpy(tiles), 127.0, 50.0)
    assert norm.shape == (3, 1, 64, 128) and norm.dtype == torch.float32
    # Same f32 operands and IEEE division on both sides.
    assert np.abs(norm[:, 0].numpy() - want_norm).max() <= 1e-6
    # The bf16 output is the f32 value rounded once, as the JAX model's
    # astype(bf16) of the kernel's f32 output.
    norm16, _ = fused_zscore_normalize(torch.from_numpy(tiles), 127.0, 50.0,
                                       out_dtype=torch.bfloat16)
    assert torch.equal(norm16[:, 0], torch.from_numpy(want_norm).to(torch.bfloat16))
    # Stats within tests/test_pallas.py's bounds (the TPU kernel sums in f32),
    # and within f32 rounding of the exact float64 statistics.
    stats = stats.numpy()
    assert np.abs(stats[:, :2] - want_stats[:, :2]).max() <= 1e-2
    assert np.abs(stats[:, 2] - want_stats[:, 2]).max() <= 1e-6
    np.testing.assert_allclose(stats, _exact_stats(tiles), rtol=1e-6, atol=0)


def test_fused_zscore_plain_keeps_fractional_input():
    """The Pallas kernel truncates float input to integers (its int32 hop,
    adipose_tpu/ops/pallas/preprocess.py:51). The port's kernel replaces the
    segment path's jnp z-score (adipose_tpu/cli/main.py:1251), which keeps
    the fractions of 16-bit-origin tiles, so fractional input is held to
    that expression and to exact statistics."""
    tiles = _tiles("f32_fractional")
    want = np.asarray((jnp.asarray(tiles) - 127.0) / (50.0 + 1e-10))
    norm, stats = fused_zscore_normalize(torch.from_numpy(tiles), 127.0, 50.0)
    assert np.abs(norm[:, 0].numpy() - want).max() <= 1e-6
    np.testing.assert_allclose(stats.numpy(), _exact_stats(tiles), rtol=1e-6, atol=0)


def test_zscore_dataset_matches_jax():
    x = _tiles("f32_fractional")
    want = np.asarray(jax_zscore_dataset(jnp.asarray(x), 200.99, 25.26))
    got = zscore_dataset(torch.from_numpy(x), 200.99, 25.26).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_diff_sigmoid_head_plain_matches_pallas(dtype):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 64, 96, 44).astype(np.float32)
    w = rs.randn(44).astype(np.float32)
    want = np.asarray(jax_diff_sigmoid_head(
        jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.float32(0.3), interpret=True))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)  # (B, C, H, W) channels-last
    assert xt.is_contiguous(memory_format=torch.channels_last)
    got = diff_sigmoid_head(xt, torch.from_numpy(w).to(tdt), 0.3)
    assert got.shape == (2, 64, 96) and got.dtype == torch.float32
    # Exact f32 products on both sides; only the f32 summation order differs.
    assert np.abs(got.numpy() - want).max() <= 1e-6


def test_cpu_calls_leave_launch_counts_at_zero():
    fused_zscore_normalize(torch.zeros(2, 8, 8, dtype=torch.uint8), 0.0, 1.0)
    x = torch.zeros(2, 4, 8, 8).to(memory_format=torch.channels_last)
    diff_sigmoid_head(x, torch.zeros(4), 0.0)
    assert fused_zscore_normalize.launches == 0
    assert diff_sigmoid_head.launches == 0


def test_non_cpu_tensors_never_run_the_plain_version():
    """Only a CPU tensor takes the plain version; anything else reaches the
    kernel's checks and raises (here: meta tensors, which are not CUDA)."""
    w = torch.empty(4, device="meta")
    x = torch.empty(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="channels-last"):
        diff_sigmoid_head(x, w, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        diff_sigmoid_head(x.to(memory_format=torch.channels_last), w, 0.0)
    with pytest.raises(TypeError):
        diff_sigmoid_head(x.to(memory_format=torch.channels_last), w.half(), 0.0)
    with pytest.raises(TypeError):
        fused_zscore_normalize(torch.empty(1, 8, 8, dtype=torch.int32, device="meta"), 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_zscore_normalize(torch.empty(1, 8, 8, dtype=torch.uint8, device="meta"), 0.0, 1.0)


def test_package_imports_without_triton_nvcc_or_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['triton'] = None\n"  # any import of these now raises
        "sys.modules['jax'] = None\n"
        "import adipose_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'adipose_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                           if not os.path.exists(os.path.join(d, "nvcc")))
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = path
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
