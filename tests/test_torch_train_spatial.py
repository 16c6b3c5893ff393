"""The port's spatially sharded U-Net training against its one-rank step and
the JAX package's spatially sharded step, on the CPU.

One 4-rank gloo spawn (``spawn_ranks``) lays the ranks out as the plan
``make_mesh_spatial(2, 4, 64)`` gives, data 2 x model 2: each rank holds
one tile of the batch of 2 and one 32-row slab of its rows. On each rank it
runs the subgroups of the plan (and of a 1 x 4 plan; a 1 x 2 plan refuses a
world of 4), the fused step of ``DilatedUNet(spatial=...)`` with deep
supervision, the fast head, dropout and augmentation drawn for the global
batch (two consecutive steps), the same step with ``remat`` and
``remat_level1``, a softmax-head step at other dilation rates, the step
with dropout 0 and tier none for the JAX comparison, and the CLI's rank
code of ``train-unet --shard-spatial --num-devices 4``. This process
meanwhile computes the one-rank references and JAX's step on a
``make_mesh_spatial(2, 4, image_h=64)`` mesh of the virtual CPU devices
(``tests/conftest.py``), compiled once with XLA's CPU optimizations off.

The module's top level imports no JAX, so the spawned ranks start fast.
Every tolerance is stated beside its check.
"""

import json
from argparse import Namespace
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import torch.distributed as dist

from adipose_tpu_torch.core.config import TrainConfig
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.parallel.mesh import MeshPlan, build_rank_grid, make_mesh_spatial
from adipose_tpu_torch.parallel.multihost import BatchShard, SlabShard, spawn_ranks
from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
from adipose_tpu_torch.train.trainer_unet import _make_fused_train_step, make_augment_step

SIZE, INIT_NB, BATCH, RANKS = 64, 4, 2, 4
PLAN = (2, 2)  # make_mesh_spatial(2, 4, 64): data 2 x model 2
RATES = (1, 3, 9)  # a non-default dilated bottleneck
CFG = TrainConfig(use_hard_mining=True)  # the CLI's loss: OHEM main, deep supervision
MEAN, STD = 120.0, 50.0
LR = 1e-4
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# name: (dropout, tier, fast head, dilation rates, model knobs, steps)
CASES = {
    "spatial": (0.3, "moderate", True, None, {}, 2),
    "remat": (0.3, "moderate", True, None, {"remat": True}, 1),
    "remat_level1": (0.3, "moderate", True, None, {"remat_level1": True}, 1),
    "rates": (0.3, "moderate", False, RATES, {}, 1),
    "jax": (0.0, "none", True, None, {}, 1),
}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_dataset(root: Path, size: int, n_train: int, n_val: int, seed: int = 0) -> Path:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("images", "masks"):
            (root / "dataset" / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            cy, cx = rng.integers(0, size, 2)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 < (size // 4) ** 2).astype(np.uint8)
            img = (rng.random((size, size)) * 60 + 80 + 80 * m).astype(np.uint8)
            cv2.imwrite(str(root / "dataset" / split / "images" / f"t{i}.jpg"), img)
            cv2.imwrite(str(root / "dataset" / split / "masks" / f"t{i}.tif"), m * 255)
    return root


# ---- what each rank runs ----------------------------------------------------------


def _steps(sd, imgs, masks, grid, dropout: float, tier: str, fast_head: bool, rates,
           model_kw: dict, steps: int):
    """``steps`` fused steps from ``sd`` on one batch, one generator: each
    step's (loss, Dice), each step's gradients by name, the params after the
    last Adam update and the generator's state after each step. With
    ``grid`` (a ``RankGrid``) the model is spatial and the batch this
    rank's rows."""
    model = DilatedUNet(init_nb=INIT_NB, compute_dtype=torch.float32, dropout_rate=dropout,
                        use_deep_supervision=True, fast_head=fast_head,
                        dilation_rates=rates or (1, 2, 4, 8, 16, 32), **model_kw)
    model.load_state_dict(sd)
    shard = None
    if grid is not None:
        size = BATCH // grid.plan.data
        shard = BatchShard(grid.data_index * size, size, BATCH, grid.data_group)
        model.batch_shard = shard
        model.spatial = SlabShard(grid.model_index, grid.plan.model, grid.model_group)
        imgs, masks = shard.rows(imgs), shard.rows(masks)
    params = dict(model.named_parameters())
    state = TrainState.create(params, "adam", LR, 0.01)
    grads, metrics, gens = [], [], []
    apply = state.apply_gradients

    def capture(g):
        grads.append({k: t.clone() for k, t in zip(state.trainable, g)})
        apply(g)

    state.apply_gradients = capture
    step = _make_fused_train_step(model, unet_loss_from_config(CFG), "zscore", 1.0, 99.0,
                                  shard)
    gen = torch.Generator().manual_seed(7)
    augment = make_augment_step(tier, shard)
    for _ in range(steps):
        aug = augment(gen, torch.from_numpy(imgs), torch.from_numpy(masks))
        m = step(state, *aug, gen, torch.tensor(MEAN), torch.tensor(STD))
        metrics.append((m["loss"].item(), m["dice_coef"].item()))
        gens.append(gen.get_state())
    return metrics, grads, {k: v.detach().clone() for k, v in params.items()}, gens


def _grid_layout(plan: MeshPlan) -> tuple:
    grid = build_rank_grid(plan)
    return (grid.data_index, grid.model_index,
            dist.get_process_group_ranks(grid.model_group),
            dist.get_process_group_ranks(grid.data_group),
            dist.get_rank(grid.model_group), dist.get_rank(grid.data_group))


def _worker(rank: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    out = {"grid": {p: _grid_layout(MeshPlan(*p)) for p in (PLAN, (1, 4))}}
    try:
        build_rank_grid(MeshPlan(1, 2))
        out["grid_error"] = None
    except ValueError as e:
        out["grid_error"] = str(e)
    grid = build_rank_grid(make_mesh_spatial(BATCH, RANKS, SIZE, RANKS))
    out["plan"] = (grid.plan.data, grid.plan.model)
    for name, (dropout, tier, fast_head, rates, kw, steps) in CASES.items():
        sd = inp["unet_rates"] if rates else inp["unet"]
        out[name] = _steps(sd, inp["imgs"], inp["masks"], grid, dropout, tier, fast_head, rates,
                           kw, steps)

    from adipose_tpu_torch.cli.main import _train_unet_rank

    _train_unet_rank(rank, Namespace(**inp["cli_args"]))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: out[k] for k in ("grid", "plan")})
    out["every"] = every
    return out


# ---- the spawn and the references ----------------------------------------------------


def _state(rates=None) -> dict:
    model = DilatedUNet(init_nb=INIT_NB, use_deep_supervision=True,
                        dilation_rates=rates or (1, 2, 4, 8, 16, 32))
    model.init_params(torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rs = np.random.RandomState(865)
    tmp = tmp_path_factory.mktemp("train_spatial")
    return {
        "imgs": rs.randint(0, 256, (BATCH, SIZE, SIZE)).astype(np.uint8),
        "masks": (rs.rand(BATCH, SIZE, SIZE) > 0.6).astype(np.uint8),
        "unet": _state(),
        "unet_rates": _state(RATES),
        "root": _write_dataset(tmp, SIZE, 4, 2),
        "tmp": tmp,
    }


def _cli_args(root: Path, ck: Path, num_devices: int) -> list[str]:
    return ["train-unet", "--data-root", str(root), "--epochs-phase1", "1",
            "--epochs-phase2", "1", "--device", "cpu", "--num-devices", str(num_devices),
            "--shard-spatial", "--checkpoint-root", str(ck), "--run-timestamp", "t0"]


def _jax_step(inputs):
    """JAX ``_make_fused_train_step`` (dropout 0, tier none, the fast head,
    deep supervision) on ``make_mesh_spatial(2, 4, image_h=64)``, the batch
    placed by ``shard_batch_spatial``: its metrics and gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from adipose_tpu.core.config import TrainConfig as JaxTrainConfig
    from adipose_tpu.models.unet import DilatedUNet as JaxUNet
    from adipose_tpu.parallel.mesh import make_mesh_spatial as jax_plan
    from adipose_tpu.parallel.mesh import replicate, shard_batch_spatial
    from adipose_tpu.train.state import TrainState as JaxTrainState
    from adipose_tpu.train.state import unet_loss_from_config as jax_loss
    from adipose_tpu.train.trainer_unet import _make_fused_train_step as jax_step
    from adipose_tpu_torch.models.convert import flax_unet_to_torch, torch_unet_to_flax

    mesh = jax_plan(BATCH, RANKS, image_h=SIZE)
    assert dict(mesh.shape) == {"data": PLAN[0], "model": PLAN[1]}
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    jmodel = JaxUNet(init_nb=INIT_NB, compute_dtype=jnp.float32, use_deep_supervision=True,
                     dropout_rate=0.0, fast_head=True, lane_pad=0)
    step = jax_step(jmodel, jax_loss(JaxTrainConfig(use_hard_mining=True)), "none", "zscore",
                    1.0, 99.0, mesh=mesh)
    tree = jax.tree.map(jnp.asarray, torch_unet_to_flax(inputs["unet"]))
    state = JaxTrainState.create(replicate(mesh, tree), capture)
    imgs, masks = shard_batch_spatial(mesh, (inputs["imgs"], inputs["masks"]))
    args = (state, imgs, masks, jax.random.PRNGKey(0), jnp.float32(MEAN), jnp.float32(STD))
    new_state, m = step.lower(*args).compile(compiler_options=FAST)(*args)
    return ({k: float(v) for k, v in m.items()},
            flax_unet_to_torch(jax.tree.map(np.asarray, new_state.opt_state)))


@pytest.fixture(scope="module")
def results(inputs):
    """Rank 0's results of the one spawn, and the references computed here
    while the ranks run: the one-rank steps, the one-rank CLI run and
    JAX's step."""
    from concurrent.futures import ThreadPoolExecutor

    from adipose_tpu_torch.cli import main as cli

    args = vars(cli.build_parser().parse_args(
        _cli_args(inputs["root"], inputs["tmp"] / "ck4", RANKS)))
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn_ranks, _worker, RANKS, ({**inputs, "cli_args": args},),
                              "gloo")
        one = {name: _steps(inputs["unet_rates"] if c[3] else inputs["unet"], inputs["imgs"],
                            inputs["masks"], None, *c[:4], {}, c[5])
               for name, c in CASES.items() if name in ("spatial", "rates")}
        cli.main(_cli_args(inputs["root"], inputs["tmp"] / "ck1", 1))
        want_jax = _jax_step(inputs)
        return spawned.result(), one, want_jax


def _worst(got: dict, want: dict) -> tuple[str, float]:
    """The leaf farthest from ``want``, as a share of that leaf's max."""
    assert got.keys() == want.keys()
    gaps = {k: (got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
            for k in want}
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def test_plan_layout_and_subgroups(results):
    """The rank grid of a plan: ``model_groups`` and ``data_groups`` are the
    rows and columns of ``MeshPlan.ranks`` for (1, 2), (2, 2) and (1, 4);
    on 4 ranks each rank's model and data groups hold exactly those ranks,
    in index order (so its group rank is its index on that axis); a plan of
    another size than the world raises; the trainer's plan is data 2 x
    model 2."""
    for plan in ((1, 2), (2, 2), (1, 4)):
        p = MeshPlan(*plan)
        assert p.model_groups() == p.ranks.tolist()
        assert p.data_groups() == p.ranks.T.tolist()
    assert MeshPlan(1, 2).model_groups() == [[0, 1]] and MeshPlan(1, 2).data_groups() == [[0], [1]]
    assert MeshPlan(2, 2).model_groups() == [[0, 1], [2, 3]]
    assert MeshPlan(2, 2).data_groups() == [[0, 2], [1, 3]]
    got, _, _ = results
    assert got["grid_error"] is not None and "needs 2 ranks" in got["grid_error"]
    for rank, every in enumerate(got["every"]):
        assert every["plan"] == PLAN
        for plan, layout in every["grid"].items():
            p = MeshPlan(*plan)
            d, m = p.data_index(rank), p.model_index(rank)
            model_ranks, data_ranks = p.ranks[d].tolist(), p.ranks[:, m].tolist()
            assert layout == (d, m, model_ranks, data_ranks, m, d), (rank, plan)
    assert make_mesh_spatial(BATCH, RANKS, SIZE, RANKS).shape == {"data": 2, "model": 2}


def test_spatial_steps_equal_one_rank(results):
    """Deep supervision, the fast head (kernels B and B' on each slab),
    dropout 0.3, tier moderate, OHEM, f32: two consecutive spatial steps on
    2 x 2 ranks against the same two steps of the whole batch on one rank.
    Each step's loss within 1e-5 relative and Dice within 1e-5, each
    gradient leaf within 1e-4 of its max (the bounds of the JAX
    comparisons; the ranks' shares sum in another order than one conv's
    batch and row sums), each param after the second update within 1e-5 lr
    plus 4 ulps of itself, the generator in the same state."""
    got, one, _ = results
    metrics, grads, params, gens = got["spatial"]
    metrics1, grads1, params1, gens1 = one["spatial"]
    assert len(metrics) == len(grads) == 2
    for (loss, dice), (loss1, dice1) in zip(metrics, metrics1):
        assert abs(loss - loss1) <= 1e-5 * abs(loss1)
        assert abs(dice - dice1) <= 1e-5
    for g, g1 in zip(grads, grads1):
        leaf, gap = _worst(g, g1)
        assert gap <= 1e-4, (leaf, gap)
    for k in params1:
        bound = 1e-5 * LR + 4 * torch.finfo(torch.float32).eps * params1[k].abs()
        assert ((params[k] - params1[k]).abs() <= bound).all(), k
    assert all(torch.equal(a, b) for a, b in zip(gens, gens1))


def test_spatial_step_at_other_dilation_rates_equals_one_rank(results):
    """The bottleneck at dilation rates (1, 3, 9) with the softmax head:
    the spatial step reads the config's rates. Loss within 1e-5 relative,
    Dice within 1e-5, each gradient leaf within 1e-4 of its max."""
    got, one, _ = results
    (metrics,), (grads,), _, _ = got["rates"]
    (metrics1,), (grads1,), _, _ = one["rates"]
    assert abs(metrics[0] - metrics1[0]) <= 1e-5 * abs(metrics1[0])
    assert abs(metrics[1] - metrics1[1]) <= 1e-5
    assert "dilate3.weight" in grads and "dilate4.weight" not in grads
    leaf, gap = _worst(grads, grads1)
    assert gap <= 1e-4, (leaf, gap)


@pytest.mark.parametrize("knob", ["remat", "remat_level1"])
def test_spatial_remat_bit_equal_to_the_plain_spatial_step(results, knob):
    """``remat`` and ``remat_level1`` under spatial sharding: the replayed
    regions repeat their halo exchanges on every rank in the same order,
    and the step's loss, Dice, gradients and the generator's state are the
    plain spatial step's, bit for bit."""
    got, _, _ = results
    (metrics,), (grads,), _, (gen,) = got[knob]
    metrics0, grads0, _, gens0 = got["spatial"]
    assert metrics == metrics0[0] and torch.equal(gen, gens0[0])
    assert grads.keys() == grads0[0].keys()
    for k, g in grads.items():
        assert torch.equal(g, grads0[0][k]), k


def test_spatial_step_matches_jax_spatial_mesh_step(results):
    """Dropout 0, tier none, the fast head, deep supervision: the 2 x 2-rank
    step against JAX's step on a ``make_mesh_spatial(2, 4, image_h=64)``
    mesh (GSPMD's halos): loss within 1e-5 relative, Dice within 1e-5,
    each gradient leaf within 1e-4 of its max."""
    got, _, (want_m, want_g) = results
    (metrics,), (grads,), _, _ = got["jax"]
    assert abs(metrics[0] - want_m["loss"]) <= 1e-5 * abs(want_m["loss"])
    assert abs(metrics[1] - want_m["dice_coef"]) <= 1e-5
    leaf, gap = _worst(grads, want_g)
    assert gap <= 1e-4, (leaf, gap)


def test_train_unet_cli_shard_spatial_on_four_ranks_matches_one_rank(results, inputs,
                                                                     monkeypatch):
    """``adipose-torch train-unet --shard-spatial --device cpu --num-devices
    4`` plans data 2 x model 2 (the JAX planner over the default 1024 tile)
    and spawns the CLI's rank code, which ran in the spawn above; against
    the same run in one process: the same artifacts, written by rank 0
    alone, and every logged loss, Dice and activation statistic within 1e-3
    relative (bf16 convs at init_nb 44 on slabs against whole tiles)."""
    from adipose_tpu_torch.cli import main as cli

    calls = []
    monkeypatch.setattr("adipose_tpu_torch.parallel.multihost.spawn_ranks",
                        lambda fn, n, args, backend: calls.append((fn, n, backend)))
    cli.main(_cli_args(inputs["root"], inputs["tmp"] / "unused", RANKS))
    assert calls == [(cli._train_unet_rank, RANKS, "gloo")]
    assert [cli._plan("cpu", b, n, True).size for b, n in ((2, 4), (1, 2), (3, 4), (4, 0))] == \
        [4, 2, 3, 1]
    assert cli._plan("cpu", 2, 8, True).shape == {"data": 2, "model": 4}
    monkeypatch.undo()

    runs = [ck / "t0_adipose_sybreosin_1024_finetune_v3"
            for ck in (inputs["tmp"] / "ck1", inputs["tmp"] / "ck4")]
    files = [sorted(p.relative_to(r) for p in r.rglob("*")) for r in runs]
    assert files[0] == files[1] and len(files[0]) > 10
    for phase in (1, 2):
        rows = [(r / f"phase{phase}_training.log").read_text().splitlines() for r in runs]
        assert len(rows[0]) == len(rows[1]) == 2 and rows[0][0] == rows[1][0]
        for name, a, b in zip(rows[0][0].split(","), rows[0][1].split(","),
                              rows[1][1].split(",")):
            if name not in ("epoch_time_s", "epoch", "lr"):
                assert abs(float(a) - float(b)) <= 1e-3 * max(abs(float(a)), 1e-3), name
    stats = [json.loads((r / "normalization_stats.json").read_text()) for r in runs]
    assert stats[0] == stats[1]
