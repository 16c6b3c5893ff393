"""The port's multi-rank training against its one-rank step and the JAX
package's mesh step, on the CPU.

One 2-rank gloo spawn (``spawn_ranks``, the launcher ``adipose-torch
train-unet --num-devices 2`` uses) runs, on each rank: the fused U-Net
step with dropout and augmentation drawn for the global batch, beside the
1-rank step of the whole batch; the same step with dropout 0 and tier none
for the JAX comparison; the classifier's phase-2 step (BatchNorm above
``mixed7`` on global-batch statistics) both ways; and the CLI's own rank
code of ``train-unet``. The JAX references run here on the 8 virtual CPU
devices (``tests/conftest.py``), each compiled once with XLA's CPU
optimizations off. Remat is held to the plain path in this process.

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

from adipose_tpu_torch.core.config import TrainConfig
from adipose_tpu_torch.models import inception as inc
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.parallel.collectives import gather_rows
from adipose_tpu_torch.parallel.multihost import BatchShard, process_index, spawn_ranks
from adipose_tpu_torch.train import trainer_classifier as tc
from adipose_tpu_torch.train.state import (TrainState, classifier_stats_mask,
                                           unet_loss_from_config)
from adipose_tpu_torch.train.trainer_unet import _make_fused_train_step, make_augment_step

SIZE, INIT_NB, BATCH = 64, 4, 2
CLS_BATCH, CLS_SIZE = 4, 139
CLS_W = np.array([1.0, 1.5], np.float32)
CLS_LABELS = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
CFG = TrainConfig(use_hard_mining=True)  # the CLI's loss: OHEM main, deep supervision
MEAN, STD = 120.0, 50.0
LR = 1e-4


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


def _unet_step(sd, imgs, masks, shard, dropout: float, tier: str, fast_head: bool = False):
    """One fused step from ``sd``: (loss, dice, grads by name, params after
    the Adam update, the generator's state after the step)."""
    model = DilatedUNet(init_nb=INIT_NB, compute_dtype=torch.float32, dropout_rate=dropout,
                        use_deep_supervision=True, fast_head=fast_head)
    model.load_state_dict(sd)
    model.batch_shard = shard
    params = dict(model.named_parameters())
    state = TrainState.create(params, "adam", LR, 0.01)
    grads = {}
    apply = state.apply_gradients

    def capture(g):
        grads.update((k, t.clone()) for k, t in zip(state.trainable, g))
        apply(g)

    state.apply_gradients = capture
    step = _make_fused_train_step(model, unet_loss_from_config(CFG), "zscore", 1.0, 99.0,
                                  shard)
    gen = torch.Generator().manual_seed(7)
    aug = make_augment_step(tier, shard)(gen, torch.from_numpy(imgs), torch.from_numpy(masks))
    m = step(state, *aug, gen, torch.tensor(MEAN), torch.tensor(STD))
    return (m["loss"].item(), m["dice_coef"].item(), grads,
            {k: v.detach().clone() for k, v in params.items()}, gen.get_state())


def _cls_step(sd, x, shard, dropout: float):
    """One phase-2 classifier step (mixed7 unfrozen, class weights 1 and
    1.5): (loss, acc, grads by name, updated running statistics)."""
    model = inc.InceptionV3Classifier(dropout_rate=dropout, compute_dtype=torch.float32)
    model.load_state_dict(sd)
    model.batch_shard = shard
    params = dict(model.named_parameters())
    mask = inc.backbone_param_mask(params, "mixed7")
    smask = classifier_stats_mask(dict(model.named_buffers()), mask)
    state = TrainState.create(params, "adam", 1e-4, 0.01, mask)
    grads = {}
    state.apply_gradients = lambda g: grads.update(
        (k, t.clone()) for k, t in zip(state.trainable, g))
    step = tc._make_train_step(model, 0.1, smask, inc.frozen_conv_boundary("mixed7"), shard)
    rows = slice(None) if shard is None else slice(shard.start, shard.start + x.shape[0] // 2)
    m = step(state, torch.from_numpy(x[rows]), torch.from_numpy(CLS_LABELS[rows]),
             torch.from_numpy(CLS_W), torch.Generator().manual_seed(3))
    stats = {k: v.clone() for k, v in model.named_buffers() if smask[k]}
    return m["loss"].item(), m["acc"].item(), grads, stats


def _same_on_every_rank(tensors: dict) -> bool:
    flat = torch.cat([t.reshape(-1) for _, t in sorted(tensors.items())])
    both = gather_rows(flat[None], 0)
    return bool(torch.equal(both[0], both[1]))


def _worker(rank: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    shard = BatchShard.of_process(BATCH)
    rows = slice(shard.start, shard.start + 1)
    imgs, masks = inp["imgs"], inp["masks"]
    out = {}
    for name, dropout, tier in (("global_draws", 0.3, "moderate"), ("jax", 0.0, "none")):
        got = _unet_step(inp["unet"], imgs[rows], masks[rows], shard, dropout, tier)
        out[name] = got
        out[name + "_same_on_ranks"] = _same_on_every_rank({**got[2], **got[3]})
    out["one_rank"] = _unet_step(inp["unet"], imgs, masks, None, 0.3, "moderate")
    cls_shard = BatchShard.of_process(CLS_BATCH)
    for name, dropout in (("cls_global", 0.4), ("cls_jax", 0.0)):
        got = _cls_step(inp["cls"], inp["x"], cls_shard, dropout)
        out[name] = got
        out[name + "_same_on_ranks"] = _same_on_every_rank({**got[2], **got[3]})
    out["cls_one_rank"] = _cls_step(inp["cls"], inp["x"], None, 0.4)

    from adipose_tpu_torch.cli.main import _train_unet_rank

    _train_unet_rank(rank, Namespace(**inp["cli_args"]))
    out["rank"] = process_index()
    return out


# ---- the spawn and the references ----------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rs = np.random.RandomState(8)
    unet = DilatedUNet(init_nb=INIT_NB, use_deep_supervision=True)
    unet.init_params(torch.Generator().manual_seed(0))
    cls = inc.InceptionV3Classifier(compute_dtype=torch.float32)
    cls.init_params(torch.Generator().manual_seed(0))
    tmp = tmp_path_factory.mktemp("train_parallel")
    root = _write_dataset(tmp, SIZE, 4, 2)
    return {
        "imgs": rs.randint(0, 256, (BATCH, SIZE, SIZE)).astype(np.uint8),
        "masks": (rs.rand(BATCH, SIZE, SIZE) > 0.5).astype(np.uint8),
        "unet": {k: v.detach().clone() for k, v in unet.state_dict().items()},
        "cls": {k: v.detach().clone() for k, v in cls.state_dict().items()},
        "x": (rs.rand(CLS_BATCH, CLS_SIZE, CLS_SIZE, 3) * 2 - 1).astype(np.float32),
        "root": root,
        "tmp": tmp,
    }


def _cli_args(root: Path, ck: Path, num_devices: int) -> list[str]:
    return ["train-unet", "--data-root", str(root), "--epochs-phase1", "1",
            "--epochs-phase2", "1", "--device", "cpu", "--num-devices", str(num_devices),
            "--checkpoint-root", str(ck), "--run-timestamp", "t0"]


@pytest.fixture(scope="module")
def results(inputs):
    """Rank 0's results of the one spawn, and the JAX references, computed
    here while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    from adipose_tpu_torch.cli.main import build_parser

    args = vars(build_parser().parse_args(_cli_args(inputs["root"], inputs["tmp"] / "ck2", 2)))
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn_ranks, _worker, 2, ({**inputs, "cli_args": args},), "gloo")
        jax_unet, jax_cls = _jax_unet_step(inputs), _jax_cls_step(inputs)
        return spawned.result(), jax_unet, jax_cls


@pytest.fixture(scope="module")
def ranks(results):
    return results[0]


@pytest.fixture(scope="module")
def jax_unet_step(results):
    return results[1]


@pytest.fixture(scope="module")
def jax_cls_step(results):
    return results[2]


def _worst(got: dict, want: dict) -> tuple[str, float]:
    """The leaf farthest from ``want``, as a share of that leaf's max."""
    assert got.keys() == want.keys()
    gaps = {k: (got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
            for k in want}
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def test_unet_step_on_two_ranks_equals_one_rank(ranks):
    """Dropout 0.3, tier moderate, deep supervision, OHEM, f32: the 2-rank
    step (draws for the global batch, sliced) against the 1-rank step of the
    whole batch. Loss and Dice within 1e-6 relative, each gradient leaf
    within 1e-5 of its max (the ranks' shares summed in another order than
    one conv's batch sum), each updated param within 1e-5 lr plus 4 ulps of
    itself (Adam's first step is lr * g / (|g| + eps): a summation-order gap
    in g barely moves it); the generator in the same state; gradients and params
    bit-equal on both ranks."""
    loss, dice, grads, params, gen = ranks["global_draws"]
    loss1, dice1, grads1, params1, gen1 = ranks["one_rank"]
    assert abs(loss - loss1) <= 1e-6 * abs(loss1)
    assert abs(dice - dice1) <= 1e-6 * abs(dice1)
    leaf, gap = _worst(grads, grads1)
    assert gap <= 1e-5, (leaf, gap)
    for k in params1:
        bound = 1e-5 * LR + 4 * torch.finfo(torch.float32).eps * params1[k].abs()
        assert ((params[k] - params1[k]).abs() <= bound).all(), k
    assert torch.equal(gen, gen1)
    assert ranks["global_draws_same_on_ranks"] and ranks["jax_same_on_ranks"]


def _jax_unet_step(inputs):
    """JAX ``_make_fused_train_step`` (dropout 0, tier none) on
    ``make_mesh_for_batch(2, 2)``, batch sharded over the data axis: its
    metrics and gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from adipose_tpu.core.config import TrainConfig as JaxTrainConfig
    from adipose_tpu.models.unet import DilatedUNet as JaxUNet
    from adipose_tpu.parallel.mesh import make_mesh_for_batch, replicate, shard_batch
    from adipose_tpu.train.state import TrainState as JaxTrainState
    from adipose_tpu.train.state import unet_loss_from_config as jax_loss
    from adipose_tpu.train.trainer_unet import _make_fused_train_step as jax_step
    from adipose_tpu_torch.models.convert import flax_unet_to_torch, torch_unet_to_flax

    mesh = make_mesh_for_batch(BATCH, 2)
    assert dict(mesh.shape) == {"data": 2, "model": 1}
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    jmodel = JaxUNet(init_nb=INIT_NB, compute_dtype=jnp.float32, use_deep_supervision=True,
                     dropout_rate=0.0, fast_head=False, lane_pad=0)
    step = jax_step(jmodel, jax_loss(JaxTrainConfig(use_hard_mining=True)), "none", "zscore",
                    1.0, 99.0, mesh=mesh)
    tree = jax.tree.map(jnp.asarray, torch_unet_to_flax(inputs["unet"]))
    state = JaxTrainState.create(replicate(mesh, tree), capture)
    imgs, masks = shard_batch(mesh, (inputs["imgs"], inputs["masks"]))
    args = (state, imgs, masks, jax.random.PRNGKey(0), jnp.float32(MEAN), jnp.float32(STD))
    compiled = step.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    new_state, m = compiled(*args)
    return ({k: float(v) for k, v in m.items()},
            flax_unet_to_torch(jax.tree.map(np.asarray, new_state.opt_state)))


def test_unet_step_on_two_ranks_matches_jax_mesh_step(ranks, jax_unet_step):
    """Dropout 0, tier none: the 2-rank step against JAX's step on a 2-device
    data mesh: loss within 1e-5 relative, Dice within 1e-5, each gradient
    leaf within 1e-4 of its max (``test_fused_train_step_matches_jax``'s
    bounds)."""
    loss, dice, grads, _, _ = ranks["jax"]
    want_m, want_g = jax_unet_step
    assert abs(loss - want_m["loss"]) <= 1e-5 * abs(want_m["loss"])
    assert abs(dice - want_m["dice_coef"]) <= 1e-5
    leaf, gap = _worst(grads, want_g)
    assert gap <= 1e-4, (leaf, gap)


def test_classifier_phase2_step_on_two_ranks_equals_one_rank(ranks):
    """Full-width InceptionV3, f32, 4 x 139^2, dropout 0.4, phase 2 (convs
    70.. and their BatchNorms on batch statistics): the 2-rank step
    (global-batch BatchNorm moments all-reduced, the global dropout mask)
    against the 1-rank step. Loss within 1e-5 relative, acc exact, each
    gradient leaf within 1e-3 of its max, the updated running statistics
    within 1e-5 of each leaf's max (measured: 4e-7, 2.2e-4 and 2.3e-7; the
    ranks sum their moments in another order); everything bit-equal on both
    ranks. At 139^2 the last stage is 3x3. At 107^2 (2x2) the 3x3 SAME
    average pool is constant over the map, so the pool branches' variance
    comes from four values a channel and E[x^2] - E[x]^2 cancels: the
    summation order then moves their outputs by 1e-3."""
    loss, acc, grads, stats = ranks["cls_global"]
    loss1, acc1, grads1, stats1 = ranks["cls_one_rank"]
    assert abs(loss - loss1) <= 1e-5 * abs(loss1) and acc == acc1
    leaf, gap = _worst(grads, grads1)
    assert gap <= 1e-3, (leaf, gap)
    leaf, gap = _worst(stats, stats1)
    assert gap <= 1e-5, (leaf, gap)
    assert len(grads) == 2 + 2 * 24  # the head and 24 ConvBNs (conv and bias)
    assert ranks["cls_global_same_on_ranks"] and ranks["cls_jax_same_on_ranks"]


def _jax_cls_step(inputs):
    """JAX ``_make_train_step`` of phase 2 (dropout 0) on a 2-device data
    mesh: its metrics, gradients and updated statistics."""
    import jax
    import jax.numpy as jnp
    import optax

    from adipose_tpu.models import inception as jinc
    from adipose_tpu.parallel.mesh import make_mesh_for_batch, replicate, shard_batch
    from adipose_tpu.train import trainer_classifier as jtc
    from adipose_tpu.train.state import TrainState as JaxTrainState
    from adipose_tpu.train.state import classifier_stats_mask as jax_stats_mask
    from adipose_tpu_torch.models.convert import flax_inception_to_torch, torch_inception_to_flax

    mesh = make_mesh_for_batch(CLS_BATCH, 2)
    variables = torch_inception_to_flax(inputs["cls"])
    jmodel = jinc.InceptionV3Classifier(dropout_rate=0.0, dtype=jnp.float32)
    jmask = jinc.backbone_param_mask(variables["params"], "mixed7")
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    state = JaxTrainState.create(replicate(mesh, jax.tree.map(jnp.asarray, variables["params"])),
                                 capture, replicate(mesh, jax.tree.map(
                                     jnp.asarray, variables["batch_stats"])))
    step = jtc._make_train_step(jmodel, 0.1, jax_stats_mask(variables["batch_stats"], jmask),
                                frozen_below=jinc.frozen_conv_boundary("mixed7"))
    x, labels = shard_batch(mesh, (inputs["x"], CLS_LABELS))
    args = (state, x, labels, jnp.asarray(CLS_W), jax.random.PRNGKey(0))
    compiled = step.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    new_state, m = compiled(*args)
    tree = jax.tree.map(np.asarray, {"params": new_state.opt_state,
                                     "batch_stats": new_state.batch_stats})
    return {k: float(v) for k, v in m.items()}, flax_inception_to_torch(tree)


def test_classifier_phase2_step_on_two_ranks_matches_jax_mesh_step(ranks, jax_cls_step):
    """Dropout 0: the 2-rank phase-2 step against JAX's on a 2-device data
    mesh (GSPMD computes the BatchNorm statistics over the global batch):
    loss within 1e-5 relative, acc exact, each trained gradient leaf within
    1e-3 of its max and each updated statistic within 1e-5 of its leaf's max
    (the bounds above; measured: 1.1e-6, 2.2e-4 and 2.7e-7)."""
    loss, acc, grads, stats = ranks["cls_jax"]
    want_m, want = jax_cls_step
    assert abs(loss - want_m["loss"]) <= 1e-5 * abs(want_m["loss"]) and acc == want_m["acc"]
    leaf, gap = _worst(grads, {k: want[k] for k in grads})
    assert gap <= 1e-3, (leaf, gap)
    leaf, gap = _worst(stats, {k: want[k] for k in stats})
    assert gap <= 1e-5, (leaf, gap)


def test_train_unet_cli_on_two_ranks_matches_one_rank(ranks, inputs, monkeypatch):
    """``adipose-torch train-unet --device cpu --num-devices 2`` plans two
    gloo ranks (the JAX planner's rule) and spawns the CLI's rank code, which
    ran in the spawn above; against the same run in one process: the same
    artifacts, written by rank 0 alone, and every logged loss, Dice and
    activation statistic within 1e-3 relative (bf16 convs at init_nb 44 over
    batches of 1 against 2; the worst measured, val_act_min, 3.9e-4)."""
    from adipose_tpu_torch.cli import main as cli

    calls = []
    monkeypatch.setattr("adipose_tpu_torch.parallel.multihost.spawn_ranks",
                        lambda fn, n, args, backend: calls.append((fn, n, backend)))
    cli.main(_cli_args(inputs["root"], inputs["tmp"] / "unused", 2))
    assert calls == [(cli._train_unet_rank, 2, "gloo")]
    assert [cli._plan("cpu", b, n).size for b, n in ((2, 2), (2, 4), (3, 2), (4, 0))] == \
        [2, 2, 1, 1]
    monkeypatch.undo()

    one = inputs["tmp"] / "ck1"
    cli.main(_cli_args(inputs["root"], one, 1))
    runs = [ck / "t0_adipose_sybreosin_1024_finetune_v3" for ck in (one, inputs["tmp"] / "ck2")]
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


# ---- remat ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob,fast_head", [("remat", False), ("remat_level1", False),
                                            ("remat_level1", True)])
def test_remat_gradients_bit_equal_to_the_plain_path(inputs, knob, fast_head):
    """One fused step (f32, dropout 0.3, tier moderate, deep supervision,
    OHEM) with ``remat`` or ``remat_level1`` against the plain model:
    loss, gradients and updated params bit-equal, and the dropout generator
    in the same state afterwards (the recompute reuses the masks drawn
    before its region, as the JAX regions replay their keys); with the fast
    head, the head's custom op runs again in the backward under
    ``remat_level1``."""
    from adipose_tpu_torch.ops.cuda import unet_kernels

    results, calls = [], []
    plain = unet_kernels.diff_sigmoid_head_plain

    def counting(*a):
        calls.append(1)
        return plain(*a)

    for remat in (False, True):
        calls.clear()
        try:
            unet_kernels.diff_sigmoid_head_plain = counting
            sd = inputs["unet"]
            model_kw = {knob: remat}
            results.append(_remat_step(sd, inputs["imgs"], inputs["masks"], fast_head, model_kw))
        finally:
            unet_kernels.diff_sigmoid_head_plain = plain
        results[-1] += (len(calls),)
    (loss0, grads0, params0, gen0, n0), (loss1, grads1, params1, gen1, n1) = results
    assert loss0 == loss1 and torch.equal(gen0, gen1)
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]) and torch.equal(params0[k], params1[k]), k
    # three heads forward; the main head once more in the recompute
    assert (n0, n1) == ((3, 4) if fast_head else (0, 0))


def _remat_step(sd, imgs, masks, fast_head: bool, model_kw: dict):
    model = DilatedUNet(init_nb=INIT_NB, compute_dtype=torch.float32, dropout_rate=0.3,
                        use_deep_supervision=True, fast_head=fast_head, **model_kw)
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    state = TrainState.create(params, "adam", LR, 0.01)
    grads = {}
    apply = state.apply_gradients

    def capture(g):
        grads.update((k, t.clone()) for k, t in zip(state.trainable, g))
        apply(g)

    state.apply_gradients = capture
    step = _make_fused_train_step(model, unet_loss_from_config(CFG), "zscore", 1.0, 99.0)
    gen = torch.Generator().manual_seed(7)
    aug = make_augment_step("moderate")(gen, torch.from_numpy(imgs), torch.from_numpy(masks))
    m = step(state, *aug, gen, torch.tensor(MEAN), torch.tensor(STD))
    return (m["loss"].item(), grads, {k: v.detach().clone() for k, v in params.items()},
            gen.get_state())
