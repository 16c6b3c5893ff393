"""The port's parallel package against the JAX package's, on the CPU.

The mesh planners' shapes against the JAX planners on the 8 virtual CPU
devices (``tests/conftest.py``), the per-process helpers, and one 4-rank
gloo spawn running the halo exchange, the H-sharded convolutions and max
pool (forward against JAX's ``sharded_conv_fn`` on a 4-device mesh and the
global ops; backward against autograd of the global conv) and
``spatial_unet_predict`` (against JAX's on the same converted params, and
against the port's ``DilatedUNet``). The JAX references run here while the
ranks run; the module's top level imports no JAX, so the ranks start fast.
Every tolerance is stated beside its check.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.parallel import mesh as pm
from adipose_tpu_torch.parallel import multihost as mh
from adipose_tpu_torch.parallel.collectives import all_reduce_sum, gather_rows
from adipose_tpu_torch.parallel.spatial import (halo_exchange, local_rows, sharded_conv_fn,
                                                spatial_max_pool2)
from adipose_tpu_torch.parallel.spatial_unet import spatial_unet_predict

RANKS = 4
DILATIONS = (1, 2, 4)
UNET_SIZE, UNET_BATCH = 64, 2
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- plans and per-process helpers ------------------------------------------------


@pytest.mark.parametrize("batch", range(1, 10))
def test_mesh_plans_match_the_jax_planners(batch):
    """``make_mesh_for_batch`` and ``make_mesh_spatial`` over 8 devices give
    the JAX planners' (data, model) shapes for every device limit 0-8 and H
    in 63, 64, 1024; ``make_mesh`` for every model axis that divides."""
    from adipose_tpu.parallel import mesh as jm

    for n in range(9):
        assert pm.make_mesh_for_batch(batch, n, 8).shape == dict(jm.make_mesh_for_batch(batch, n).shape)
        for h in (63, 64, 1024):
            want = dict(jm.make_mesh_spatial(batch, n, image_h=h).shape)
            assert pm.make_mesh_spatial(batch, n, h, 8).shape == want, (n, h)
    if batch <= 8:
        for model_axis in (m for m in range(1, 9) if batch % m == 0):
            assert pm.make_mesh(batch, model_axis, 8).shape == \
                dict(jm.make_mesh(batch, model_axis).shape)
        with pytest.raises(ValueError):
            pm.make_mesh(7, 2, 8)


@pytest.mark.parametrize("batch,h,want", [(2, 64, (2, 4)), (3, 64, (3, 2)), (8, 64, (8, 1)),
                                          (2, 63, (2, 1))])
def test_mesh_spatial_cases(batch, h, want):
    """The JAX package's ``TestMeshSpatial`` cases over 8 devices: batch 2
    uses all 8, the model axis is a power of two that divides H, a full
    batch is data parallel, an H with no power-of-two factor drops it."""
    plan = pm.make_mesh_spatial(batch, 8, h, 8)
    assert (plan.data, plan.model) == want
    assert plan.ranks.shape == want and plan.ranks.ravel().tolist() == list(range(plan.size))


def test_batch_helpers_match_jax(monkeypatch):
    """``pad_batch_to`` as the JAX function; one process: ``local_batch_slice``
    the whole batch, ``initialize_multihost`` a no-op (False, nothing
    started), ``make_global_mesh`` the local plan, ``make_global_array`` and
    ``replicate`` the identity; ``shard_batch`` a data index's rows."""
    from adipose_tpu.parallel.mesh import pad_batch_to as jax_pad

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = np.arange(3, dtype=np.int64)
    (pa, pb), n = pm.pad_batch_to(5, a, b)
    (wa, wb), wn = jax_pad(5, a, b)
    assert n == wn == 3 and np.array_equal(pa, wa) and np.array_equal(pb, wb)
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert mh.initialize_multihost() is False and not torch.distributed.is_initialized()
    assert mh.local_batch_slice(16) == (0, 16)
    assert mh.make_global_mesh().shape == {"data": 1, "model": 1}
    t = torch.arange(6.0)
    assert mh.make_global_array(t) is t and pm.replicate({"w": t})["w"] is t
    plan = pm.MeshPlan(2, 2)
    rows = pm.shard_batch(plan, {"x": torch.arange(8), "y": (np.arange(8),)}, rank=3)
    assert rows["x"].tolist() == [4, 5, 6, 7] and rows["y"][0].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_batch(plan, torch.arange(3), 0)


def _fail_on_rank_1(rank: int) -> int:
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def test_a_failing_rank_fails_the_launch():
    """``spawn_ranks`` stops the other ranks and raises when one fails."""
    with pytest.raises(Exception, match="rank 1 fails"):
        mh.spawn_ranks(_fail_on_rank_1, 2)


# ---- what each rank runs ----------------------------------------------------------


def _spatial_worker(rank: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    out = {}
    x = torch.from_numpy(inp["x"])  # (B, C, H, W), every rank holds the whole image
    slab = local_rows(x)
    h = slab.shape[-2]
    for halo in (1, 4):  # rows from both neighbours, zeros beyond the image
        want = F.pad(x, (0, 0, halo, halo))[..., rank * h:(rank + 1) * h + 2 * halo, :]
        out[f"halo{halo}_exact"] = bool(torch.equal(halo_exchange(slab, halo), want))
    conv = sharded_conv_fn()
    for d in DILATIONS:
        xg = x.clone().requires_grad_(True)
        w = torch.from_numpy(inp["w"]).requires_grad_(True)
        y = conv(xg, w, (d, d))
        (y * torch.from_numpy(inp["cot"][d])).sum().backward()
        # each rank holds its rows' share of the input gradient and its share
        # of the weight gradient: their sums are the global gradients
        out[f"conv{d}"] = (y.detach(), all_reduce_sum(xg.grad), all_reduce_sum(w.grad))
    out["pool"] = gather_rows(spatial_max_pool2(slab), -2)
    images = torch.from_numpy(inp["images"])
    out["predict_f32"] = spatial_unet_predict(inp["unet"], images,
                                              compute_dtype=torch.float32)
    out["predict_bf16"] = spatial_unet_predict(inp["unet"], images)
    try:
        spatial_unet_predict(inp["unet_ds"], images, compute_dtype=torch.float32)
        out["ds_error"] = None
    except ValueError as e:
        out["ds_error"] = str(e)
    return out


# ---- the spawn and the references ----------------------------------------------------


def _unet_state(deep_supervision: bool) -> dict:
    model = DilatedUNet(init_nb=4, use_deep_supervision=deep_supervision)
    model.init_params(torch.Generator().manual_seed(1))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(865)
    return {
        "x": rs.randn(2, 8, 64, 48).astype(np.float32),
        "w": (rs.randn(16, 8, 3, 3) * 0.1).astype(np.float32),
        "cot": {d: rs.randn(2, 16, 64, 48).astype(np.float32) for d in DILATIONS},
        "images": rs.randn(UNET_BATCH, UNET_SIZE, UNET_SIZE).astype(np.float32),
        "unet": _unet_state(False),
        "unet_ds": _unet_state(True),
    }


def _jax_references(inp: dict) -> dict:
    """JAX's ``sharded_conv_fn``, the shard_map max pool and
    ``spatial_unet_predict`` over a 4-device mesh (H sharded over 'data')."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from adipose_tpu.parallel.mesh import make_mesh
    from adipose_tpu.parallel.spatial import sharded_conv_fn as jax_conv
    from adipose_tpu.parallel.spatial import spatial_max_pool2 as jax_pool
    from adipose_tpu.parallel.spatial_unet import spatial_unet_predict as jax_predict
    from adipose_tpu_torch.models.convert import torch_unet_to_flax

    def fast(fn, *args):  # compiled once, XLA's CPU optimizations off
        return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)

    mesh = make_mesh(RANKS)
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1))  # NHWC
    k = jnp.asarray(inp["w"].transpose(2, 3, 1, 0))  # HWIO

    def convs_and_pool(x, k):
        pool = jax.shard_map(jax_pool, mesh=mesh, in_specs=P(None, "data", None, None),
                             out_specs=P(None, "data", None, None))
        return [jax_conv(mesh)(x, k, (d, d)) for d in DILATIONS] + [pool(x)]

    *convs, pooled = fast(convs_and_pool, x, k)
    out = {f"conv{d}": np.asarray(y).transpose(0, 3, 1, 2) for d, y in zip(DILATIONS, convs)}
    out["pool"] = np.asarray(pooled).transpose(0, 3, 1, 2)
    params = jax.tree.map(jnp.asarray, torch_unet_to_flax(inp["unet"]))
    out["predict"] = np.asarray(fast(lambda p, im: jax_predict(
        p, im, mesh, compute_dtype=jnp.float32), params, jnp.asarray(inp["images"])))
    return out


@pytest.fixture(scope="module")
def results(inputs):
    """Rank 0's results of the 4-rank spawn and the JAX references."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mh.spawn_ranks, _spatial_worker, RANKS, (inputs,), "gloo")
        want = _jax_references(inputs)
        return spawned.result(), want


def test_halo_exchange_gives_the_neighbours_rows(results):
    """A slab padded with 1 and 4 rows: its neighbours' rows, zeros beyond
    the global image, exactly."""
    got, _ = results
    assert got["halo1_exact"] and got["halo4_exact"]


@pytest.mark.parametrize("d", DILATIONS)
def test_sharded_conv_matches_jax_and_the_global_conv(results, inputs, d):
    """``sharded_conv_fn`` at dilation d over 4 ranks: the forward within
    1e-5 of JAX's ``sharded_conv_fn`` and of the global SAME conv; the
    input and weight gradients (the ranks' shares summed) within 1e-5 of
    autograd of the global conv, relative to their max."""
    got, want = results
    y, gx, gw = got[f"conv{d}"]
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["w"]).requires_grad_(True)
    ref = F.conv2d(x, w, padding=d, dilation=d)
    (ref * torch.from_numpy(inputs["cot"][d])).sum().backward()
    assert np.abs(y.numpy() - want[f"conv{d}"]).max() < 1e-5
    assert (y - ref.detach()).abs().max() < 1e-5
    assert (gx - x.grad).abs().max() <= 1e-5 * x.grad.abs().max()
    assert (gw - w.grad).abs().max() <= 1e-5 * w.grad.abs().max()


def test_sharded_max_pool_matches_jax_and_the_global_pool(results, inputs):
    """The slabs' 2x2 pools, gathered: equal to JAX's shard_map pool and to
    the global pool, exactly."""
    got, want = results
    ref = F.max_pool2d(torch.from_numpy(inputs["x"]), 2)
    assert torch.equal(got["pool"], ref) and np.array_equal(got["pool"].numpy(), want["pool"])


def test_spatial_unet_predict_matches_jax_and_the_model(results, inputs):
    """``spatial_unet_predict`` over 4 ranks (slabs of 16 rows at 64^2,
    init_nb 4): float32 within 1e-5 of JAX's ``spatial_unet_predict`` on the
    same converted params and of the port's ``DilatedUNet`` (the fast head,
    eval mode) on one device; bf16 within 5e-3 of the bf16 model (its
    rounding differs only where the slabs meet, as the JAX test bounds it)."""
    got, want = results
    images = torch.from_numpy(inputs["images"])
    assert got["predict_f32"].shape == (UNET_BATCH, UNET_SIZE, UNET_SIZE)
    assert np.abs(got["predict_f32"].numpy() - want["predict"]).max() < 1e-5
    for dtype, key, bound in ((torch.float32, "predict_f32", 1e-5),
                              (torch.bfloat16, "predict_bf16", 5e-3)):
        model = DilatedUNet(init_nb=4, compute_dtype=dtype, fast_head=True)
        model.load_state_dict(inputs["unet"])
        with torch.inference_mode():
            ref = model.eval()(images)
        assert (got[key] - ref).abs().max() < bound, key


def test_spatial_unet_predict_rejects_deep_supervision(results):
    got, _ = results
    assert got["ds_error"] is not None and "deep-supervision" in got["ds_error"]
