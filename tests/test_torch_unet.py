"""The port's U-Net against the JAX package's, on converted Flax params.

f32 forwards are held to the stored fixtures at the bounds tests/test_golden.py
uses for the JAX model; the bf16 forward is held to a live JAX forward.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu_torch.models.convert import (flax_unet_to_torch, load_flax_npz,
                                              save_flax_npz, torch_unet_to_flax)
from adipose_tpu_torch.models.unet import DilatedUNet, FusedUpsampleConv

TESTS = Path(__file__).parent
VARIANTS = {
    "default": dict(),
    "ds": dict(use_deep_supervision=True),
    "lane_pad0": dict(),  # lane padding is TPU-only: the port has one unpadded graph
    "slow_head": dict(fast_head=False),
}


@pytest.fixture(scope="module")
def jax_params():
    """Flax params of DilatedUNet(init_nb=4) at PRNGKey(42), with the
    deep-supervision heads: every other leaf equals the non-DS init's."""
    model = JaxUNet(init_nb=4, compute_dtype=jnp.float32, use_deep_supervision=True)
    variables = jax.jit(model.init)(jax.random.PRNGKey(42), jnp.zeros((2, 64, 64)))
    return jax.tree.map(np.asarray, variables)


def torch_apply(tree, x: np.ndarray, init_nb: int, **kw) -> dict[str, np.ndarray]:
    ds = kw.get("use_deep_supervision", False)
    state = {k: v for k, v in flax_unet_to_torch(tree).items()
             if ds or not k.startswith("aux_out")}
    model = DilatedUNet(init_nb=init_nb, device="meta", **kw).eval()
    with torch.inference_mode():
        out = torch.func.functional_call(model, state, (torch.from_numpy(x),), strict=True)
    out = out if isinstance(out, dict) else {"main_out": out}
    return {k: v.numpy() for k, v in out.items()}


def test_forward_matches_golden_unet(jax_params):
    data = np.load(TESTS / "golden_unet.npz")
    got = torch_apply(jax_params, data["input"], 4, compute_dtype=torch.float32)["main_out"]
    assert got.shape == data["output"].shape
    assert np.abs(got - data["output"]).max() < 1e-4


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forwards_match_golden(jax_params, name):
    data = np.load(TESTS / "golden_unet_variants.npz")
    out = torch_apply(jax_params, data["input"], 4, compute_dtype=torch.float32,
                      **VARIANTS[name])
    want_heads = {k.split(".", 1)[1] for k in data.files if k.startswith(name + ".")}
    assert set(out) == want_heads
    for head, got in out.items():
        want = data[f"{name}.{head}"]
        assert got.shape == want.shape, head
        assert np.abs(got - want).max() < 1e-4, head


@pytest.mark.parametrize("ds,tag,seed", [(False, "unet", 123), (True, "unet_ds", 124)])
def test_forward_vs_tf_reference_goldens(ds, tag, seed):
    """golden_tf_oracle.npz holds the reference implementation's outputs at
    1024^2 for seeded weights; the bounds are tests/test_golden.py's."""
    from tf_oracle_util import fill_flax_unet, seeded_unet_weights

    data = np.load(TESTS / "golden_tf_oracle.npz")
    shapes = jax.eval_shape(
        JaxUNet(init_nb=8, compute_dtype=jnp.float32, use_deep_supervision=ds).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tree = fill_flax_unet(zeros, seeded_unet_weights(8, ds, seed))
    x = np.random.RandomState(7).standard_normal((1, 1024, 1024)).astype(np.float32)
    out = torch_apply(tree, x, 8, compute_dtype=torch.float32, use_deep_supervision=ds)
    for head, got in out.items():
        assert np.abs(got[:, ::16, ::16] - data[f"{tag}/{head}/sub"]).max() <= 5e-5, head
        assert abs(got.mean() - data[f"{tag}/{head}/mean"]) <= 1e-5, head
        assert abs(got.max() - data[f"{tag}/{head}/max"]) <= 5e-5, head


def test_bf16_forward_matches_live_jax(jax_params):
    """bf16 compute on both sides: the production JAX config (lane-padded,
    fast head) against the port. Both fold the upsample-conv's 4x4 kernel in
    f32 before the cast; conv accumulation orders differ. Measured at this
    size: max 4.3e-4, mean 1.6e-6 (max 4.7e-4, mean 2.9e-5 while the port
    ran a bf16 3x3 conv over the upsampled map)."""
    params = {"params": {k: v for k, v in jax_params["params"].items()
                         if not k.startswith("aux_out")}}
    x = np.random.RandomState(0).randn(2, 64, 64).astype(np.float32)
    want = np.asarray(jax.jit(JaxUNet(init_nb=4).apply)(params, jnp.asarray(x)))
    got = torch_apply(params, x, 4)["main_out"]
    diff = np.abs(got - want)
    assert diff.max() <= 2e-3 and diff.mean() <= 1e-4


def test_converter_round_trips_through_npz(jax_params, tmp_path):
    state = flax_unet_to_torch(jax_params)
    assert state["down1_conv2.weight"].shape == (4, 4, 3, 3)  # OIHW
    path = save_flax_npz(torch_unet_to_flax(state), tmp_path / "params.npz")
    back = load_flax_npz(path)
    want = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for key, leaf in want:
        assert np.array_equal(got[key], leaf), key


def test_seeded_init_follows_flax(jax_params):
    """init_params draws Flax's lecun_normal (truncated at 2 std) and zero
    biases into the same tree layout as the JAX init."""
    model = DilatedUNet(init_nb=4, use_deep_supervision=True)
    model.init_params(torch.Generator().manual_seed(0))
    tree = torch_unet_to_flax(model.state_dict())
    assert (jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jax_params))
    w = model.dilate2.weight.detach()
    std = (1.0 / (9 * 32)) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not any(p.detach().any() for n, p in model.named_parameters()
                   if n.endswith(".bias"))
    again = DilatedUNet(init_nb=4, use_deep_supervision=True)
    again.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 3, 5, 7, 10), (1, 7, 1, 5, 3),
                                             (3, 1, 4, 2, 9)])
def test_fused_upsample_conv_equals_upsample_then_conv(b, cin, cout, h, w):
    """The transposed 4x4 conv against a nearest-x2 upsample and a SAME 3x3
    conv, in float32 channels-last with a bias: the outputs, and the
    gradients of x, the 3x3 weight and the bias through the fold, within
    1e-5 relative or absolute (the weight's gradients reach ~70 here, where
    float32 resolves ~1e-5, and each form is that far from a float64 run).
    Without autograd the module runs the transposed conv."""
    gen = torch.Generator().manual_seed(100 * cin + cout)
    conv = FusedUpsampleConv(cin, cout)
    conv.reset_parameters(gen)
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    x = torch.randn(b, cin, h, w, generator=gen).contiguous(memory_format=torch.channels_last)
    g = torch.randn(b, cout, 2 * h, 2 * w, generator=gen)

    def run(fn):
        xi = x.clone().requires_grad_()
        conv.zero_grad()
        y = fn(xi)
        (y * g).sum().backward()
        return [t.detach().clone() for t in (y, xi.grad, conv.weight.grad, conv.bias.grad)]

    got = run(conv.transposed)
    want = run(lambda t: F.conv2d(F.interpolate(t, scale_factor=2, mode="nearest"),
                                  conv.weight, conv.bias, padding=1))
    assert got[0].shape == (b, cout, 2 * h, 2 * w)
    with torch.no_grad():
        assert torch.equal(conv(x), got[0])
    for name, a, e in zip(("y", "dx", "dweight", "dbias"), got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5, msg=name)
