"""The port's augmentation against the JAX package's ``data/augment.py``.

torch cannot reproduce ``jax.random``, so each test derives the draws from
the JAX keys with ``jax.random``, following the JAX package's split
discipline (``augment.py:393-428``: per sample ``k_geo, k_rest``, the D4 id
from ``k_geo``, one key per rest stage), and feeds them to the port's
deterministic ``apply_*`` functions and ``batched_tier``.

Tolerance: 1e-4 absolute on the 0-255 scale (a few float32 ulps at 255:
the two packages' exp and pow differ by an ulp, and XLA may contract the
shifted adds into fused multiply-adds); masks exact.

Each JAX function is compiled once, by ``fast_jit``, with XLA's CPU backend
optimizations off: compiling the elastic tiers dominates these tests'
time, and the optimization level changes no semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.data import augment as jaug
from adipose_tpu_torch.data import augment as aug
from adipose_tpu_torch.ops.cuda.d4 import d4_transform_batch

ATOL = 1e-4
B, N = 3, 48


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(7)
    yy, xx = np.mgrid[:N, :N]
    images = (rs.rand(B, N, N) * 150 + 60 + 40 * np.sin(xx / 5.0)).astype(np.float32)
    images[0, :8] = 255.0  # saturated rows exercise the clips
    masks = np.stack([((yy - 10 - 9 * i) ** 2 + (xx - 30 + 5 * i) ** 2 < 120).astype(np.float32)
                      for i in range(B)])
    return images, masks


def fast_jit(fn):
    """``jax.jit(fn)``, compiled on first call without LLVM's optimization
    passes."""
    compiled = {}

    def call(*args):
        if "c" not in compiled:
            compiled["c"] = jax.jit(fn).lower(*args).compile(compiler_options={
                "xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True})
        return compiled["c"](*args)

    return call


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _uniform(key, lo=None, hi=None):
    if lo is None:
        return jax.random.uniform(key)
    return jax.random.uniform(key, (), minval=lo, maxval=hi)


def _stage_draws(key, stage: aug.Stage, shape):
    """One sample's draws of one rest stage, as the JAX primitive makes them."""
    if stage.kind == "noise":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"gate": _uniform(k1), "value": _uniform(k2, stage.lo, stage.hi),
                "normal": jax.random.normal(k3, shape)}
    k1, k2 = jax.random.split(key)
    if stage.kind == "elastic":
        kx, ky = jax.random.split(k2)
        return {"gate": _uniform(k1), "ux": jax.random.uniform(kx, shape),
                "uy": jax.random.uniform(ky, shape)}
    return {"gate": _uniform(k1), "value": _uniform(k2, stage.lo, stage.hi)}


def jax_tier_draws(key, tier: str, shape):
    """The draws ``adipose_tpu.data.augment.batched_tier(key, ...)`` makes:
    ``(tid, [per-stage dicts])`` of JAX arrays."""
    keys = jax.random.split(key, shape[0])
    sub = jax.vmap(jax.random.split)(keys)
    geo, rest = sub[:, 0], sub[:, 1]
    tid = jax.vmap(lambda k: jax.random.randint(k, (), 0, 8))(geo)
    stages = aug.TIER_STAGES[tier]

    def per_sample(k):
        # _rest_light hands its key straight to _maybe; the others split it
        ks = [k] if tier == "light" else list(jax.random.split(k, len(stages)))
        return [_stage_draws(kk, st, shape[1:]) for kk, st in zip(ks, stages)]

    return tid, jax.vmap(per_sample)(rest)


TIERS = ("light", "moderate", "heavy", "tta_style")


@pytest.fixture(scope="module")
def jax_tiers(batch):
    """Every tier's ``batched_tier`` output and draws, in one compiled
    program."""
    images, masks = batch

    def tiers_and_draws(key, a, b):
        return {tier: (jaug.batched_tier(key, a, b, tier), jax_tier_draws(key, tier, a.shape))
                for tier in TIERS}

    return fast_jit(tiers_and_draws)(jax.random.PRNGKey(11), jnp.asarray(images),
                                     jnp.asarray(masks))


@pytest.mark.parametrize("tier", TIERS)
def test_batched_tier_matches_jax_on_its_draws(batch, jax_tiers, tier):
    images, masks = batch
    (want_i, want_m), (tid, drawn) = jax_tiers[tier]
    draws = {"tid": _t(tid).to(torch.int32),
             "stages": [{k: _t(v) for k, v in d.items()} for d in drawn]}
    got_i, got_m = aug.batched_tier(draws, _t(images), _t(masks), tier)
    assert np.abs(got_i.numpy() - np.asarray(want_i)).max() <= ATOL
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def _jax_primitives(keys, images, masks):
    """Every primitive per sample (vmapped), each applied for certain, and
    the draws each made from its key."""
    def one(k, im, m):
        ks = jax.random.split(k, 8)
        ex, ey = jax.random.split(ks[6])  # elastic_transform's two fields
        out = {
            "brightness": jaug.random_brightness(ks[0], im, (0.7, 1.3)),
            "contrast": jaug.random_contrast(ks[1], im, (0.7, 1.3)),
            "gamma": jaug.random_gamma(ks[2], im, (0.7, 1.3)),
            "blur": jaug.random_gaussian_blur(ks[3], im, (0.0, 1.5), prob=1.0),
            "noise": jaug.random_gaussian_noise(ks[4], im, (0.0, 10.0), prob=1.0),
            "scale": jaug.random_scale(ks[5], im, m, (0.8, 1.2), prob=1.0),
            "elastic": jaug.elastic_transform(ks[6], im, m, alpha=2.0, sigma=2.0),
        }
        draws = {  # the photometric primitives draw from their key unsplit
            **{name: {"value": _uniform(ks[i], 0.7, 1.3)}
               for i, name in enumerate(("brightness", "contrast", "gamma"))},
            "blur": _stage_draws(ks[3], aug.Stage("blur", 0.0, 1.5), im.shape),
            "noise": _stage_draws(ks[4], aug.Stage("noise", 0.0, 10.0), im.shape),
            "scale": _stage_draws(ks[5], aug.Stage("scale", 0.8, 1.2), im.shape),
            "elastic": {"ux": jax.random.uniform(ex, im.shape),
                        "uy": jax.random.uniform(ey, im.shape)},
        }
        return out, draws
    return fast_jit(jax.vmap(one))(keys, images, masks)


@pytest.fixture(scope="module")
def primitives(batch):
    images, masks = batch
    want, draws = _jax_primitives(jax.random.split(jax.random.PRNGKey(5), B),
                                  jnp.asarray(images), jnp.asarray(masks))
    return (jax.tree.map(np.asarray, want),
            {name: {k: _t(v) for k, v in d.items()} for name, d in draws.items()})


def test_photometric_primitives_match_jax(batch, primitives):
    images, _ = batch
    want, draws = primitives
    x = _t(images)
    for name, fn in (("brightness", aug.apply_brightness), ("contrast", aug.apply_contrast),
                     ("gamma", aug.apply_gamma)):
        assert np.abs(fn(x, draws[name]["value"]).numpy() - want[name]).max() <= ATOL, name
    got = aug.apply_gaussian_blur(x, torch.zeros(B), draws["blur"]["value"], prob=1.0)
    assert np.abs(got.numpy() - want["blur"]).max() <= ATOL
    d = draws["noise"]
    got = aug.apply_gaussian_noise(x, torch.zeros(B), d["value"], d["normal"], prob=1.0)
    assert np.abs(got.numpy() - want["noise"]).max() <= ATOL


def test_geometric_primitives_match_jax(batch, primitives):
    images, masks = batch
    want, draws = primitives
    scale = draws["scale"]["value"]
    assert (scale < 1).any() and (scale > 1).any()  # zoom out and in
    got_i, got_m = aug.apply_scale(_t(images), _t(masks), torch.zeros(B), scale, 1.0)
    assert np.abs(got_i.numpy() - want["scale"][0]).max() <= ATOL
    assert np.array_equal(got_m.numpy(), want["scale"][1])
    d = draws["elastic"]
    got_i, got_m = aug.apply_elastic(_t(images), _t(masks), torch.ones(B), d["ux"], d["uy"],
                                     prob=1.0, alpha=2.0, sigma=2.0)
    assert np.abs(got_i.numpy() - want["elastic"][0]).max() <= ATOL
    assert np.array_equal(got_m.numpy(), want["elastic"][1])


def test_draws_are_seeded_and_shaped_and_d4_runs_once_per_tensor(batch):
    images, masks = batch
    d1 = aug.draw_tier(torch.Generator().manual_seed(3), "heavy", B, N, N)
    d2 = aug.draw_tier(torch.Generator().manual_seed(3), "heavy", B, N, N)
    assert d1["tid"].dtype == torch.int32 and d1["tid"].shape == (B,)
    assert [sorted(d) for d in d1["stages"]] == [sorted(d) for d in d2["stages"]]
    for a, b in zip(d1["stages"], d2["stages"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for st, d in zip(aug.TIER_STAGES["heavy"], d1["stages"]):
        if "value" in d:
            assert ((d["value"] >= st.lo) & (d["value"] < st.hi)).all(), st.kind
    assert d1["stages"][1]["ux"].shape == (B, N, N)
    assert aug.draw_tier(torch.Generator(), "none", B, N, N) is None
    calls = []
    real = aug.apply_transform_batch
    aug.apply_transform_batch = lambda x, ids: calls.append(x.shape) or real(x, ids)
    try:
        out_i, out_m = aug.augment_batch(torch.Generator().manual_seed(0), _t(images),
                                         _t(masks), "moderate")
    finally:
        aug.apply_transform_batch = real
    assert calls == [(B, N, N), (B, N, N)]
    assert out_i.shape == out_m.shape == (B, N, N)
    assert out_i.min() >= 0 and out_i.max() <= 255
    assert set(out_m.unique().tolist()) <= {0.0, 1.0}
    assert d4_transform_batch.launches == 0  # CPU tensors run the plain version
    assert aug.select_tier(150) == "heavy" and aug.select_tier(300) == "moderate"
    assert aug.select_tier(600) == "light"
