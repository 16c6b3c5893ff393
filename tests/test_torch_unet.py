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
from adipose_tpu_torch.models.unet import DilatedUNet, FusedUpsampleConv, fold_upsample_kernel
from adipose_tpu_torch.ops.cuda.unet_kernels import diff_sigmoid_head

TESTS = Path(__file__).parent
VARIANTS = {
    "default": dict(),
    "ds": dict(use_deep_supervision=True),
    "lane_pad0": dict(),  # the port has one graph: it pads by models/unet.py:lane, not lane_pad
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


# -- level-1 channels stored at lane() width -----------------------------------

CL = torch.channels_last


def plain_unet(p: dict, x: torch.Tensor, gen: torch.Generator | None = None,
               rate: float = 0.3) -> dict:
    """The U-Net with every activation at its params' channels, from a state
    dict ``p``, float32: the reference the padded model is held to. The
    up-convs run as the transposed 4x4 conv where autograd does not record,
    as two ops where it does; with ``gen`` dropout draws the model's
    (B, H, W, C) uniforms in its order."""
    def conv(name, t, dilation=1):
        w = p[name + ".weight"]
        return F.conv2d(t, w.to(memory_format=CL), p[name + ".bias"],
                        padding=dilation * (w.shape[-1] // 2), dilation=dilation)

    def up_conv(name, t):
        if torch.is_grad_enabled():
            return conv(name, F.interpolate(t, scale_factor=2, mode="nearest"))
        return F.conv_transpose2d(t, fold_upsample_kernel(p[name + ".weight"], t.dtype),
                                  p[name + ".bias"], stride=2, padding=1)

    def drop(t):
        if gen is None:
            return t
        b, c, h, w = t.shape
        keep = torch.rand((b, h, w, c), generator=gen).permute(0, 3, 1, 2) < 1.0 - rate
        return torch.where(keep, t / (1.0 - rate), torch.zeros(()))

    def block(names, t):
        for name in names:
            t = F.relu(conv(name, t))
        return t

    x = x.unsqueeze(1).contiguous(memory_format=CL)
    down1 = block(("down1_conv1", "down1_conv2"), x)
    down2 = block(("down2_conv1", "down2_conv2"), F.max_pool2d(down1, 2))
    down3 = block(("down3_conv1", "down3_conv2"), F.max_pool2d(down2, 2))
    d, taps = F.max_pool2d(down3, 2), []
    for i, rate_i in enumerate((1, 2, 4, 8, 16, 32)):
        d = F.relu(conv(f"dilate{i + 1}", d, rate_i))
        taps.append(drop(d) if i == 0 else d)
        d = taps[-1]
    y = sum(taps)
    ups = {}
    for level, skip in ((3, down3), (2, down2), (1, down1)):
        y = torch.cat([skip, F.relu(up_conv(f"up{level}_conv1", y))], dim=1)
        y = drop(block((f"up{level}_conv2", f"up{level}_conv3"), y))
        ups[level] = y
    w = p["output_softmax.weight"][:, :, 0, 0]
    out = {"main_out": diff_sigmoid_head(ups[1], w[1] - w[0],
                                         p["output_softmax.bias"][1] - p["output_softmax.bias"][0])}
    for name, level in (("aux_out1", 3), ("aux_out2", 2)):
        aux = diff_sigmoid_head(ups[level].contiguous(memory_format=CL),
                                p[name + ".weight"][0, :, 0, 0], p[name + ".bias"][0])
        out[name] = F.interpolate(aux[:, None], size=tuple(x.shape[-2:]), mode="bilinear",
                                  align_corners=False)[:, 0]
    return out


def seeded_unet(nb: int) -> DilatedUNet:
    model = DilatedUNet(init_nb=nb, compute_dtype=torch.float32, use_deep_supervision=True)
    gen = torch.Generator().manual_seed(nb)
    model.init_params(gen)
    with torch.no_grad():  # nonzero biases, so a padded channel that reads one shows
        for name, t in model.named_parameters():
            if name.endswith(".bias"):
                t.normal_(0.0, 0.1, generator=gen)
    return model


@pytest.mark.parametrize("nb", [4, 12, 8, 5])
def test_padded_channels_give_the_unpadded_function_bit_for_bit(nb):
    """Activations whose channels are not a multiple of 8 are stored at the
    next multiple (4 -> 8 and 12 -> 16 at level 1; 5 pads every level; 8
    pads none), zeros in the extra channels: the forward without autograd
    and the training forward with dropout and deep supervision equal the
    unpadded function's bit for bit. So do the parameter gradients, but for
    the order of the sums: the CPU's weight-gradient kernels block their
    reductions by channel count, so a padded conv may add the same products
    in another order. Each gradient is held to 16 float32 ulps of its
    leaf's largest (the reorderings read at most 6 here, in
    ``up1_conv1.weight`` at init_nb 5; 4.5 in ``up1_conv3.weight`` at 12;
    1.75 in ``up1_conv2.weight`` at 4; a misplaced block or a channel that
    leaks reads O(1)). ``plain_unet`` shares the port's upsample fold and
    head kernel; the check independent of the port is the JAX comparisons
    at init_nb 4, which now run padded: ``test_forward_matches_golden_unet``,
    ``test_variant_forwards_match_golden``, ``test_bf16_forward_matches_live_jax``
    and ``tests/test_torch_train.py::test_fused_train_step_matches_jax``."""
    model = seeded_unet(nb)
    params = {k: v.detach().clone().requires_grad_() for k, v in model.named_parameters()}
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(7))
    width = -(-nb // 8) * 8

    model.eval()
    with torch.no_grad():
        got, want = model(x), plain_unet(params, x)
        down1, up2, _ = model._to_level1(x, None)
        up1 = model._up1(down1, up2, None)
    for head in want:
        assert torch.equal(got[head], want[head]), head
    assert down1.shape[1] == up1.shape[1] == width
    assert not down1[:, nb:].any() and not up1[:, nb:].any()

    model.train()
    got = model(x, torch.Generator().manual_seed(9))
    want = plain_unet(params, x, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(11)
    cot = {k: torch.randn(v.shape, generator=g) for k, v in want.items()}
    sum((got[k] * cot[k]).sum() for k in cot).backward()
    sum((want[k] * cot[k]).sum() for k in cot).backward()
    for head in want:
        assert torch.equal(got[head], want[head]), head
    for name, t in model.named_parameters():
        want_grad = params[name].grad
        ulp = torch.finfo(torch.float32).eps * want_grad.abs().max()
        assert (t.grad - want_grad).abs().max() <= 16 * ulp, name
    down1, up2, _ = model._to_level1(x, torch.Generator().manual_seed(9))
    up1 = model._up1(down1, up2, model._up1_keep(down1, torch.Generator().manual_seed(9)))
    assert up1.shape[1] == width and not up1[:, nb:].any()


@pytest.mark.parametrize("nb,padded_convs", [(4, 6), (8, 0)])
def test_padding_keeps_param_shapes_and_counts_its_convs(jax_params, tmp_path, nb,
                                                          padded_convs):
    """The params, the state dict, the Flax round trip and a torch.export
    program's parameters keep their (..., init_nb) shapes; a forward counts
    ``conv.channel_pad`` once for each conv that runs on padded channels:
    level 1's six at init_nb 4 (stored at 8), none at 8. The exported
    program gives the eager forward's maps."""
    from torch.profiler import ProfilerActivity, profile

    from adipose_tpu_torch.core import tracing

    model = DilatedUNet(init_nb=nb, compute_dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(3)).eval()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["down1_conv1.weight"] == (nb, 1, 3, 3)
    assert shapes["up1_conv2.weight"] == (nb, 2 * nb, 3, 3)
    assert shapes["up1_conv1.bias"] == (nb,) and shapes["output_softmax.weight"] == (2, nb, 1, 1)
    path = save_flax_npz(torch_unet_to_flax(model.state_dict()), tmp_path / "params.npz")
    back = flax_unet_to_torch(load_flax_npz(path))
    assert {k: tuple(v.shape) for k, v in back.items()} == shapes
    x = torch.randn(1, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
        assert {k: tuple(v.shape) for k, v in program.state_dict.items()} == shapes
        want = model(x)
        assert torch.equal(program.module()(x), want)

    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
            model(x)
        counters = tracing.records()["counters"]
    finally:
        tracing.clear()
    assert counters.get("conv.channel_pad", 0) == padded_convs
    assert counters["upconv.transposed"] == 3
