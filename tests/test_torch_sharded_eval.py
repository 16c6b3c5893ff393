"""Tile-stream sharding of the sliding window and the WSI cascade against one
process and against the JAX package's mesh runs, on the CPU.

The two cases of ``tests/test_sharded_eval.py`` (a smoothing predict in the
sliding window, a stub classifier and a sigmoid segmenter in the cascade)
run on the 2 ranks of one gloo spawn with ``group=``, against the port's
one-process run and JAX's run on a ``make_mesh(2)`` of the virtual CPU
devices (``tests/conftest.py``). The same spawn runs both paths again with
a seeded init_nb 4 U-Net behind the z-score (kernel A's plain version) and
the fast head (B's), and the cascade's gate behind the percentile stretch
(P's), against one process; and the batch rounding of both classes. A
second spawn, started at the same moment, shows that two spawns never
meet at each other's rendezvous.

The module's top level imports no JAX, so the spawned ranks start fast.
Every tolerance is stated beside its check.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from adipose_tpu_torch.eval.sliding_window import SlidingWindowInference
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
from adipose_tpu_torch.ops.normalize import batched_percentile_unit_fast
from adipose_tpu_torch.parallel.multihost import spawn_ranks
from adipose_tpu_torch.train.state import make_unet_predict
from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

RANKS = 2
MEAN, STD = 120.0, 50.0
SW = dict(tile_size=32, overlap=0.5, batch_size=8)
CASCADE = dict(tile_size=32, overlap=0.5, batch_size=8)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the predicts, as the JAX test writes them ------------------------------------


def smooth_predict(params, tiles):
    """A 3 x 3 mean over edge-padded tiles."""
    pad = F.pad(tiles[:, None], (1, 1, 1, 1), mode="replicate")
    return F.conv2d(pad, torch.full((1, 1, 3, 3), 1.0 / 9.0))[:, 0]


def cls_predict(variables, tiles):
    return torch.where(tiles.to(torch.float32).mean(dim=(1, 2)) > 0, 0.9, 0.1)


def seg_predict(params, tiles):
    return torch.sigmoid((tiles.to(torch.float32) - 120.0) / 40.0)


def _unet_predicts():
    """A seeded init_nb 4 U-Net with the fast head behind the z-score, and
    a gate behind the percentile stretch: the kernels' plain versions."""
    model = DilatedUNet(init_nb=4, compute_dtype=torch.float32, fast_head=True)
    model.init_params(torch.Generator().manual_seed(5))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    unet = make_unet_predict(model)

    def seg(p, tiles):
        return unet(p, fused_zscore_normalize(tiles, MEAN, STD)[0])

    def gate(v, tiles):
        stretched = batched_percentile_unit_fast(tiles.to(torch.float32), 1.0, 99.0)
        return (stretched[:, ::2, ::2].mean(dim=(1, 2)) * 4.0 - 1.5).sigmoid()

    return seg, gate, params


def _runs(inp: dict, group) -> dict:
    """Both paths on ``group`` (None: one process)."""
    out = {}
    sw = SlidingWindowInference(**SW, device="cpu", group=group)
    out["sw"] = sw.predict(smooth_predict, None, inp["image"])
    pipe = DualModelWSIPipeline(cls_predict, None, seg_predict, None, **CASCADE, device="cpu",
                                group=group)
    out["cascade"] = pipe.run(inp["slide"])
    seg, gate, params = _unet_predicts()
    sw = SlidingWindowInference(tile_size=32, overlap=0.25, batch_size=3, device="cpu",
                                group=group)
    out["sw_unet"] = sw.predict(seg, params, inp["image"] * 255.0)
    pipe = DualModelWSIPipeline(gate, None, seg, params, tile_size=32, overlap=0.25,
                                batch_size=3, classifier_threshold=0.5, device="cpu",
                                group=group)
    out["cascade_unet"] = pipe.run(inp["slide_qc"])
    return out


def _worker(rank: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    world = dist.group.WORLD
    out = _runs(inp, world)
    out["batches"] = {
        "sw": [SlidingWindowInference(tile_size=32, batch_size=b, device="cpu",
                                      group=world).batch_size for b in (1, 5, 8)],
        "cascade": [DualModelWSIPipeline(None, None, None, None, tile_size=32, batch_size=b,
                                         device="cpu", group=world).batch_size
                    for b in (1, 5, 8)],
    }
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: out[k] for k in ("sw", "sw_unet")} | {
        k: out[k].probability_map for k in ("cascade", "cascade_unet")})
    out["every"] = every
    return out


def _where(rank: int) -> tuple[int, int, int]:
    return rank, dist.get_rank(), dist.get_world_size()


# ---- the spawns and the references -----------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(865)
    slide_qc = (rs.rand(96, 160) * 200 + 20).astype(np.uint8)
    slide_qc[:48, :80] = 250  # QC-empty tiles
    slide_qc[48:, 80:] = 120  # QC-blurry tiles
    return {"image": rs.rand(96, 128).astype(np.float32),
            "slide": (rs.rand(96, 160) * 120 + 60).astype(np.uint8), "slide_qc": slide_qc}


def _jax_runs(inputs: dict) -> dict:
    """The JAX test's two cases on ``make_mesh(2)``, and its batch
    rounding for batches of 1, 5 and 8."""
    import jax
    import jax.numpy as jnp

    from adipose_tpu.eval.sliding_window import SlidingWindowInference as JaxSW
    from adipose_tpu.parallel.mesh import make_mesh
    from adipose_tpu.wsi.pipeline import DualModelWSIPipeline as JaxPipeline

    mesh = make_mesh(RANKS)
    assert dict(mesh.shape) == {"data": RANKS, "model": 1}

    def predict(params, tiles):
        k = jnp.ones((3, 3)) / 9.0
        pad = jnp.pad(tiles, ((0, 0), (1, 1), (1, 1)), mode="edge")
        return jax.lax.conv_general_dilated(pad[:, None], k[None, None], (1, 1),
                                            "VALID")[:, 0]

    def jcls(v, tiles):
        return jnp.where(jnp.mean(tiles, axis=(1, 2)) > 0, 0.9, 0.1)

    def jseg(p, tiles):
        return jax.nn.sigmoid((tiles - 120.0) / 40.0)

    return {
        "sw": JaxSW(**SW, mesh=mesh).predict(predict, None, inputs["image"]),
        "cascade": JaxPipeline(jcls, None, jseg, None, **CASCADE, mesh=mesh).run(
            inputs["slide"]),
        "batches": {
            "sw": [JaxSW(tile_size=32, batch_size=b, mesh=mesh).batch_size for b in (1, 5, 8)],
            "cascade": [JaxPipeline(None, None, None, None, tile_size=32, batch_size=b,
                                    mesh=mesh).batch_size for b in (1, 5, 8)],
        },
    }


@pytest.fixture(scope="module")
def results(inputs):
    """Rank 0's results of the spawn, the second spawn's ranks, the
    one-process runs and the JAX runs, the last two computed here while
    the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        spawned = pool.submit(spawn_ranks, _worker, RANKS, (inputs,), "gloo")
        other = pool.submit(spawn_ranks, _where, RANKS, (), "gloo")
        one = _runs(inputs, None)
        want = _jax_runs(inputs)
        return spawned.result(), other.result(), one, want


def test_sharded_sliding_window_matches_one_process_and_jax(results):
    """The smoothing predict over 2 ranks: within 1e-6 of the one-process
    map and of JAX's ``SlidingWindowInference(mesh=make_mesh(2))`` (the
    JAX test's bound), the same map on both ranks."""
    got, _, one, want = results
    assert got["sw"].shape == (96, 128)
    assert np.abs(got["sw"] - one["sw"]).max() < 1e-6
    assert np.abs(got["sw"] - want["sw"]).max() < 1e-6
    assert all(np.array_equal(e["sw"], got["sw"]) for e in got["every"])


def test_sharded_cascade_matches_one_process_and_jax(results):
    """The stub classifier and the sigmoid segmenter over 2 ranks: the
    tile, good and positive counts of the one-process run and of JAX's
    ``DualModelWSIPipeline(mesh=make_mesh(2))``, the probability map within
    1e-6 of both (the JAX test's bound) and the same on both ranks; host
    tiling and one finalize, as JAX's mesh path (``striped`` false)."""
    got, _, one, want = results
    a, b, j = got["cascade"], one["cascade"], want["cascade"]
    assert (a.n_tiles, a.n_good, a.n_positive) == (b.n_tiles, b.n_good, b.n_positive)
    assert (a.n_tiles, a.n_good, a.n_positive) == (j.n_tiles, j.n_good, j.n_positive)
    assert a.n_positive > 0
    assert np.abs(a.probability_map - b.probability_map).max() < 1e-6
    assert np.abs(a.probability_map - j.probability_map).max() < 1e-6
    assert all(np.array_equal(e["cascade"], a.probability_map) for e in got["every"])
    assert a.timings["striped"] is False and j.timings["striped"] is False
    assert b.timings["striped"] is True
    assert set(a.timings) == set(j.timings)


def test_sharded_unet_paths_equal_one_process(results):
    """A seeded U-Net behind the z-score and the fast head, and a gate
    behind the percentile stretch, each rank predicting its share of
    batches of 3 (rounded to 2 in the sliding window and to 4 in the
    cascade, whose slide has a white and a flat quarter that QC turns
    away): the sliding-window map within 1e-6 of the one-process map,
    the cascade's counts equal and its map within 1e-6 (one process
    predicts other batches, so a conv may round otherwise); the same maps
    on both ranks."""
    got, _, one, _ = results
    assert np.abs(got["sw_unet"] - one["sw_unet"]).max() < 1e-6
    a, b = got["cascade_unet"], one["cascade_unet"]
    assert (a.n_tiles, a.n_good, a.n_positive) == (b.n_tiles, b.n_good, b.n_positive)
    assert 0 < a.n_positive < a.n_tiles
    assert np.abs(a.probability_map - b.probability_map).max() < 1e-6
    for e in got["every"]:
        assert np.array_equal(e["sw_unet"], got["sw_unet"])
        assert np.array_equal(e["cascade_unet"], a.probability_map)


def test_sharded_batches_round_as_jax(results):
    """Batches of 1, 5 and 8 over 2 ranks: the sliding window rounds down
    to a multiple of the ranks, at least one tile a rank (2, 4, 8), the
    cascade rounds up (2, 6, 8), as JAX's classes round to the mesh's data
    axis."""
    got, _, _, want = results
    assert got["batches"] == want["batches"]
    assert got["batches"] == {"sw": [2, 4, 8], "cascade": [2, 6, 8]}


def test_two_spawns_started_at_once_both_succeed(results):
    """The spawn above and a second one started at the same moment each
    meet at their own file store: both finish, each with its own 2 ranks."""
    got, other, _, _ = results
    assert other == (0, 0, RANKS)
    assert len(got["every"]) == RANKS
