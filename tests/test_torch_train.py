"""The port's U-Net training path against the JAX package's, on the CPU.

Heads, losses, the Keras Adam/AdamW update, one fused train step, the batch
order and a tiny ``adipose-torch train-unet`` run. Models run in float32
at init_nb 4 on 64^2 tiles; each JAX function is compiled once (with XLA's
CPU optimizations off: compile time dominates, the semantics do not
change). Every tolerance is stated beside its test.
"""

import dataclasses
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adipose_tpu.core.config import TrainConfig as JaxTrainConfig
from adipose_tpu.data.loader import TileDataset as JaxTileDataset
from adipose_tpu.models.unet import DilatedUNet as JaxUNet
from adipose_tpu.models.unet import encoder_param_mask as jax_encoder_mask
from adipose_tpu.ops import losses as JL
from adipose_tpu.ops.metrics import activation_stats as jax_activation_stats
from adipose_tpu.ops.pallas.unet_kernels import diff_sigmoid_head_vjp
from adipose_tpu.train.state import TrainState as JaxTrainState
from adipose_tpu.train.state import make_optimizer
from adipose_tpu.train.state import set_learning_rate as jax_set_learning_rate
from adipose_tpu.train.state import unet_loss_from_config as jax_loss_from_config
from adipose_tpu.train.trainer_unet import _make_fused_train_step as jax_fused_step
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.core.config import TrainConfig, UNetConfig
from adipose_tpu_torch.core.seeding import generator_for, seed_for
from adipose_tpu_torch.data.loader import TileDataset
from adipose_tpu_torch.models.convert import flax_unet_to_torch, torch_unet_to_flax
from adipose_tpu_torch.models.unet import DilatedUNet, encoder_param_mask
from adipose_tpu_torch.ops import losses as L
from adipose_tpu_torch.ops.cuda.unet_kernels import (diff_sigmoid_head,
                                                     diff_sigmoid_head_backward_plain,
                                                     diff_sigmoid_head_plain)
from adipose_tpu_torch.ops.metrics import activation_stats
from adipose_tpu_torch.train.state import TrainState, set_learning_rate, unet_loss_from_config
from adipose_tpu_torch.train.trainer_unet import (UNetTrainer, _make_fused_train_step,
                                                   init_unet_params)

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SIZE, INIT_NB = 64, 4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fast_jit(fn, *args, **jit_kwargs):
    """Compile ``fn`` (a function or a ``jax.jit`` object) for ``args`` once,
    without LLVM's optimization passes, and call it."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn, **jit_kwargs)
    return jitted.lower(*args).compile(compiler_options=FAST)(*args)


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


# ---- the head's backward ---------------------------------------------------


def test_head_backward_plain_matches_jax_vjp():
    """``_head_bwd`` through ``jax.vjp`` (the forward in Pallas interpret
    mode) vs the plain backward on the same p and cotangent: dx within 1e-6
    absolute, dw and dbias within 1e-5 relative (f32 sums in another
    order); f32 and bf16 activations."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randn(2, 12, 20, 8), 0).astype(np.float32)
    w = (rs.randn(8) / 3).astype(np.float32)
    g = rs.randn(2, 12, 20).astype(np.float32)

    def vjps(x32, w32, xb, wb, g):
        out = []
        for xx, ww in ((x32, w32), (xb, wb)):
            p, pull = jax.vjp(diff_sigmoid_head_vjp, xx, ww, jnp.float32(0.3))
            out.append((p, *pull(g)))
        return out

    results = fast_jit(vjps, x, w, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), g)
    for dtype, (p, dx, dw, db) in zip((torch.float32, torch.bfloat16), results):
        xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)  # channels-last (B, C, H, W)
        wt = torch.from_numpy(w).to(dtype)
        got = diff_sigmoid_head_backward_plain(xt, wt, torch.from_numpy(np.asarray(p)),
                                               torch.from_numpy(g))
        assert got[0].is_contiguous(memory_format=torch.channels_last)
        gdx = got[0].permute(0, 2, 3, 1).float().numpy()
        assert np.abs(gdx - np.asarray(dx, np.float32)).max() <= 1e-6, dtype
        dw = np.asarray(dw, np.float32)
        assert np.abs(got[1].float().numpy() - dw).max() <= 1e-5 * np.abs(dw).max(), dtype
        assert abs(got[2].item() - float(db)) <= 1e-5 * abs(float(db)), dtype


def test_head_function_gives_the_plain_backward_on_cpu():
    """On a CPU tensor the autograd Function runs both plain versions: its
    gradients equal the plain backward's exactly and plain autograd's to
    f32 rounding (torch's sigmoid backward multiplies in another order)."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 10, 14, 6).astype(np.float32)).permute(0, 3, 1, 2)
    w, bias = torch.from_numpy(rs.randn(6).astype(np.float32)), torch.tensor(-0.2)
    weights = torch.from_numpy(rs.randn(2, 10, 14).astype(np.float32))
    grads = []
    for fn in (diff_sigmoid_head, diff_sigmoid_head_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        (fn(*leaves) * weights).sum().backward()
        grads.append([t.grad for t in leaves])
    p = diff_sigmoid_head_plain(x, w, bias)
    exact = diff_sigmoid_head_backward_plain(x, w, p, weights)
    for a, b, c in zip(grads[0], grads[1], exact):
        assert torch.equal(a, c)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


# ---- losses and metrics ----------------------------------------------------

LOSS_CASES = {
    "binary_crossentropy": (L.binary_crossentropy, JL.binary_crossentropy),
    "dice_coef": (L.dice_coef, JL.dice_coef),
    "dice_loss": (L.dice_loss, JL.dice_loss),
    "combined_loss_standard": (L.combined_loss_standard, JL.combined_loss_standard),
    "smooth_labels": (lambda t, p: L.smooth_labels(t), lambda t, p: JL.smooth_labels(t)),
    "combined_loss_with_label_smoothing": (L.combined_loss_with_label_smoothing,
                                           JL.combined_loss_with_label_smoothing),
    "ohem_row": (L.ohem_loss, JL.ohem_loss),
    "ohem_pixel": (lambda t, p: L.ohem_loss(t, p, 0.5, "pixel"),
                   lambda t, p: JL.ohem_loss(t, p, 0.5, "pixel")),
    "ohem_loss_with_smoothing": (L.ohem_loss_with_smoothing, JL.ohem_loss_with_smoothing),
    "deep_supervision": (
        lambda t, p: unet_loss_from_config(TrainConfig(use_hard_mining=True))(t, p),
        lambda t, p: jax_loss_from_config(JaxTrainConfig(use_hard_mining=True))(t, p)),
    "activation_stats": (lambda t, p: activation_stats(p["main_out"]),
                         lambda t, p: jax_activation_stats(p["main_out"])),
}


@pytest.fixture(scope="module")
def loss_values():
    """Every JAX loss on one seeded batch, in one compiled program."""
    rs = np.random.RandomState(5)
    y = (rs.rand(2, 24, 32) > 0.6).astype(np.float32)
    preds = {k: rs.rand(2, 24, 32).astype(np.float32) for k in ("main_out", "aux_out1",
                                                                "aux_out2")}
    preds["main_out"][0, 0, :4] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # the clip bounds

    def all_losses(y, preds):
        return {name: (jfn(y, preds) if name in ("deep_supervision", "activation_stats")
                       else jfn(y, preds["main_out"]))
                for name, (_, jfn) in LOSS_CASES.items()}

    want = jax.tree.map(np.asarray, fast_jit(all_losses, y, preds))
    return y, preds, want


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_and_metrics_match_jax(loss_values, name):
    """1e-6 relative (f32 reductions in another order)."""
    y, preds, want = loss_values
    fn = LOSS_CASES[name][0]
    yt, pt = torch.from_numpy(y), {k: torch.from_numpy(v) for k, v in preds.items()}
    got = fn(yt, pt) if name in ("deep_supervision", "activation_stats") else fn(yt, pt["main_out"])
    got = {k: v.numpy() for k, v in got.items()} if isinstance(got, dict) else got.numpy()
    for key, w in (want[name].items() if isinstance(want[name], dict) else [(name, want[name])]):
        g = got[key] if isinstance(got, dict) else got
        assert np.allclose(g, w, rtol=1e-6, atol=1e-7 * np.abs(w).max()), key


# ---- the Keras Adam / AdamW update -----------------------------------------


@pytest.fixture(scope="module")
def seeded_tree():
    """A port-initialized init_nb=4 U-Net with deep supervision, as the
    Flax tree (numpy) the JAX package's model takes."""
    model = DilatedUNet(init_nb=INIT_NB, use_deep_supervision=True)
    model.init_params(torch.Generator().manual_seed(0))
    return torch_unet_to_flax(model.state_dict())


OPT_CASES = [("adam", False), ("adam", True), ("adamw", False), ("adamw", True)]
# Two updates, with set_learning_rate between them. From the third update
# on, XLA's float32 b2 ** t is an ulp or so off the correctly rounded power
# that the port takes on the host, and 1 - b2 ** t (0.003 at t = 3)
# magnifies that to ~1e-5 of alpha: a rounding of JAX's, not a formula gap.
LRS = (1e-3, 3e-4)


@pytest.fixture(scope="module")
def jax_updates(seeded_tree):
    """The updates of each optimizer case on the same grads, in one compiled
    program, over a few layers of the tree: two of the frozen encoder's and
    four that train."""
    keep = ("_ConvBlock_0", "_ConvBlock_1", "dilate1", "up1_conv3", "output_softmax", "aux_out1")
    tree = {"params": {k: v for k, v in seeded_tree["params"].items() if k in keep}}
    rs = np.random.RandomState(6)
    base = jax.tree.map(lambda a: rs.randn(*a.shape) * 1e-2, tree)
    # each element keeps its sign across the steps: with a sign flip, m
    # cancels and an ulp of it is amplified by 1 / sqrt(v), in any order
    grads = [jax.tree.map(lambda b: (b * (1 + 0.5 * rs.rand(*b.shape))).astype(np.float32),
                          base) for _ in LRS]

    def run(params, grads):
        out = []
        for opt, masked in OPT_CASES:
            mask = {"params": jax_encoder_mask(params["params"])} if masked else None
            tx = make_optimizer(opt, LRS[0], 0.01, mask)
            state, p = tx.init(params), params
            for g, lr in zip(grads, LRS):
                state = jax_set_learning_rate(state, lr)
                upd, state = tx.update(g, state, p)
                p = optax.apply_updates(p, upd)
            out.append(p)
        return out

    return tree, grads, jax.tree.map(np.asarray, fast_jit(run, tree, grads))


@pytest.mark.parametrize("case", range(len(OPT_CASES)))
def test_keras_adam_matches_make_optimizer(jax_updates, case):
    """Two Keras Adam/AdamW updates on identical grads, with and without
    the phase-1 encoder mask, vs the JAX package's ``make_optimizer``:
    1e-6 relative; frozen leaves exact (never touched)."""
    opt, masked = OPT_CASES[case]
    tree, grads, want = jax_updates
    params = {k: v.clone() for k, v in flax_unet_to_torch(tree).items()}
    start = {k: v.clone() for k, v in params.items()}
    state = TrainState.create(params, opt, LRS[0], 0.01,
                              encoder_param_mask(params) if masked else None)
    for g, lr in zip(grads, LRS):
        set_learning_rate(state.optimizer, lr)
        gt = flax_unet_to_torch(g)
        state.apply_gradients([gt[k] for k in state.trainable])
    want_t = flax_unet_to_torch(want[case])
    frozen = set(params) - set(state.trainable)
    assert (len(frozen) == 8) == masked  # down1_conv1/2, down2_conv1/2
    for k, v in params.items():
        if k in frozen:
            assert torch.equal(v, start[k]) and torch.equal(want_t[k], start[k]), k
        else:
            d = (v - want_t[k]).abs().max().item()
            assert d <= 1e-6 * max(want_t[k].abs().max().item(), 1e-3), (k, d)


# ---- one fused train step --------------------------------------------------


def _capture_grads():
    """An optax transformation that applies nothing and keeps the grads as
    its state, so a JAX train step hands back exactly its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


@pytest.mark.parametrize("fast_head,norm", [(False, "zscore"), (True, "percentile")])
def test_fused_train_step_matches_jax(seeded_tree, fast_head, norm):
    """One train step of the CLI's loss (deep supervision, OHEM) at f32, tier
    none, dropout 0, vs JAX ``_make_fused_train_step``: loss within 1e-5
    relative, each grad leaf within 1e-4 of that leaf's max |g|. Both heads;
    the percentile stretch on u8-valued input, where JAX's sort and the
    port's histogram are bit-equal."""
    rs = np.random.RandomState(8)
    imgs = rs.randint(0, 256, (2, SIZE, SIZE)).astype(np.uint8)
    masks = (rs.rand(2, SIZE, SIZE) > 0.5).astype(np.uint8)
    cfg_kw = dict(use_hard_mining=True)
    jmodel = JaxUNet(init_nb=INIT_NB, compute_dtype=jnp.float32, use_deep_supervision=True,
                     dropout_rate=0.0, fast_head=fast_head, lane_pad=0)
    jstep = jax_fused_step(jmodel, jax_loss_from_config(JaxTrainConfig(**cfg_kw)), "none", norm,
                           1.0, 99.0)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, seeded_tree), _capture_grads())
    args = (jstate, imgs, masks, jax.random.PRNGKey(0), jnp.float32(120.0), jnp.float32(50.0))
    new_state, metrics = fast_jit(jstep, *args)
    want_grads = flax_unet_to_torch(jax.tree.map(np.asarray, new_state.opt_state))

    model = DilatedUNet(init_nb=INIT_NB, compute_dtype=torch.float32, dropout_rate=0.0,
                        use_deep_supervision=True, fast_head=fast_head)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in flax_unet_to_torch(seeded_tree).items():
            params[k].copy_(v)
    state = TrainState.create(params, "adam", 1e-4, 0.01)
    captured = []
    state.apply_gradients = captured.extend
    step = _make_fused_train_step(model, unet_loss_from_config(TrainConfig(**cfg_kw)), norm,
                                  1.0, 99.0)
    got = step(state, torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator(),
               torch.tensor(120.0), torch.tensor(50.0))
    loss = float(metrics["loss"])
    assert abs(got["loss"].item() - loss) <= 1e-5 * abs(loss)
    assert abs(got["dice_coef"].item() - float(metrics["dice_coef"])) <= 1e-5
    assert len(captured) == len(want_grads) == len(state.trainable)
    for k, g in zip(state.trainable, captured):
        w = want_grads[k]
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), k


# ---- data, seeding, dropout ------------------------------------------------


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


def test_batch_order_matches_jax_tile_dataset(tmp_path):
    """Bit-identical uint8 batches, epoch by epoch, with the short final
    batch padded by repetition."""
    root = _write_dataset(tmp_path, 16, 7, 1)
    d = root / "dataset" / "train"
    ours = TileDataset(d / "images", d / "masks", 3, seed=865)
    theirs = JaxTileDataset(d / "images", d / "masks", 3, seed=865)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3
    for epoch in range(3):
        for shuffle in (True, False):
            a = list(ours.epoch_batches(epoch, shuffle))
            b = list(theirs.epoch_batches(epoch, shuffle))
            assert len(a) == len(b) == 3
            for (ia, ma), (ib, mb) in zip(a, b):
                assert np.array_equal(ia, ib) and np.array_equal(ma, mb)


def test_generators_and_dropout_are_seeded_and_flax_shaped():
    """generator_for streams are stable per (domain, seed, index) and apart
    across them; dropout keeps ~(1 - rate) of the values, scaled by
    1 / (1 - rate), only in training, and needs a generator there."""
    assert seed_for("unet.init", 865) == seed_for("unet.init", 865)
    assert len({seed_for("train.p1", 865, i) for i in range(4)} |
               {seed_for("train.p2", 865, 0), seed_for("train.p1", 866, 0)}) == 6
    a = torch.rand(8, generator=generator_for("x", 1, 2))
    assert torch.equal(a, torch.rand(8, generator=generator_for("x", 1, 2)))
    model = DilatedUNet(init_nb=2, dropout_rate=0.3, compute_dtype=torch.float32)
    x = torch.ones((1, 8, 32, 32)).contiguous(memory_format=torch.channels_last)
    model.eval()
    assert model._dropout(x, None) is x
    model.train()
    with pytest.raises(ValueError, match="needs a generator"):
        model._dropout(x, None)
    y = model._dropout(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_merge_matching_takes_matching_leaves_only():
    """The pretrained by-name merge, as the JAX package's ``merge_matching``:
    leaves whose path and shape match are taken, the rest keep the fresh
    init, and leaves only in the source are dropped."""
    from adipose_tpu.train.checkpoint import merge_matching as jax_merge
    from adipose_tpu_torch.train.checkpoint import merge_matching

    dst = {"params": {"a": {"kernel": np.zeros((3, 3)), "bias": np.zeros(3)},
                      "aux": {"bias": np.zeros(1)}}}
    src = {"params": {"a": {"kernel": np.ones((3, 3)), "bias": np.ones(4)},
                      "extra": {"bias": np.ones(2)}}}
    got = merge_matching(dst, src)
    want = jax.tree.map(np.asarray, jax_merge(dst, src))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    assert got["params"]["a"]["kernel"].sum() == 9 and got["params"]["a"]["bias"].sum() == 0


def test_trainer_raises_on_shard_spatial(tmp_path):
    """``shard_spatial`` does not raise: in one process its plan is 1 x 1,
    which is the plain trainer, and one epoch of it logs the plain epoch's
    losses, Dice and statistics bit for bit and saves the same params.
    Several ranks are held to one in tests/test_torch_train_spatial.py."""
    from adipose_tpu_torch.parallel.mesh import MeshPlan

    root = _write_dataset(tmp_path, 16, 2, 1)
    logs, params = [], []
    for spatial in (False, True):
        trainer = UNetTrainer(root, TrainConfig(shard_spatial=spatial, batch_size=2),
                              UNetConfig(init_nb=4, tile_size=16, compute_dtype="float32"),
                              checkpoint_root=tmp_path / f"ck{spatial}",
                              build_timestamp="t0", device="cpu")
        assert trainer.plan == MeshPlan(1, 1)
        assert trainer.shard is None and trainer.model.spatial is None
        trainer.train(epochs_phase1=1, epochs_phase2=0)
        rows = (trainer.ckpt_dir / "phase1_training.log").read_text().splitlines()
        names = rows[0].split(",")
        logs.append({n: v for n, v in zip(names, rows[1].split(",")) if n != "epoch_time_s"})
        params.append(np.load(trainer.ckpt_dir / "phase1_best" / "params.npz"))
    assert logs[0] == logs[1]
    assert params[0].files == params[1].files
    for k in params[0].files:
        assert np.array_equal(params[0][k], params[1][k]), k


# ---- adipose-torch train-unet ----------------------------------------------


def test_train_unet_cli_writes_the_artifact_contract(tmp_path):
    """A tiny run at the CLI defaults (init_nb 44, deep supervision, OHEM,
    EMA, cosine, moderate, percentile) on 64^2 tiles: every artifact, finite
    losses, an encoder untouched by phase 1, and weights whose tree has the
    JAX ``DilatedUNet.init`` keys and shapes."""
    root = _write_dataset(tmp_path, SIZE, 2, 2)
    torch_main(["train-unet", "--data-root", str(root), "--epochs-phase1", "1",
                "--epochs-phase2", "1", "--device", "cpu", "--checkpoint-root",
                str(tmp_path / "ck"), "--run-timestamp", "t0"])
    run = tmp_path / "ck" / "t0_adipose_sybreosin_1024_finetune_v3"
    stats = json.loads((run / "normalization_stats.json").read_text())
    assert stats["method"] == "percentile" and 80 < stats["mean"] < 220
    settings = (run / "training_settings.log").read_text()
    for line in ("use_deep_supervision: True", "init_nb: 44", "augment_level: moderate",
                 "use_hard_mining: True", "use_ema: True"):
        assert line in settings
    for phase in (1, 2):
        rows = (run / f"phase{phase}_training.log").read_text().splitlines()
        header, values = rows[0].split(","), [float(v) for v in rows[1].split(",")]
        assert len(rows) == 2 and header[:3] == ["epoch", "loss", "dice_coef"]
        assert "val_act_std" in header and np.isfinite(values).all()
    shapes = jax.eval_shape(JaxUNet(init_nb=44, use_deep_supervision=True).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE)))
    want = {k: v.shape for k, v in _flat(shapes).items()}
    trees = {}
    for entry in ("phase1_best", "phase2_best", "weights_best_overall", "weights_ema"):
        with np.load(run / entry / "params.npz") as z:
            trees[entry] = {tuple(k.split("/")): z[k] for k in z.files}
        assert {k: v.shape for k, v in trees[entry].items()} == want, entry
    init_tree = _flat(torch_unet_to_flax(init_unet_params(
        DilatedUNet(init_nb=44, use_deep_supervision=True, device="meta"), 865)))
    for k, v in trees["phase1_best"].items():
        if any(seg.startswith("down") for seg in k):
            assert np.array_equal(v, init_tree[k]), k  # frozen in phase 1
    assert not np.array_equal(trees["phase1_best"][("params", "dilate1", "kernel")],
                              init_tree[("params", "dilate1", "kernel")])
    assert dataclasses.asdict(TrainConfig()).keys() == dataclasses.asdict(
        JaxTrainConfig()).keys()


# ---- train-unet's resume, transfer and profiling flags ------------------------


def _train_unet(root: Path, ck: Path, timestamp: str, *flags: str) -> Path:
    torch_main(["train-unet", "--data-root", str(root), "--device", "cpu",
                "--checkpoint-root", str(ck), "--run-timestamp", timestamp, *flags])
    return ck / f"{timestamp}_adipose_sybreosin_1024_finetune_v3"


def _weights(run: Path, entry: str) -> dict:
    with np.load(run / entry / "params.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """A 1 + 1 epoch run with ``--auto-resume``: its rolling ``latest``
    state stands after phase 2's epoch 0."""
    tmp = tmp_path_factory.mktemp("unet_flags")
    root = _write_dataset(tmp, SIZE, 2, 2)
    run = _train_unet(root, tmp / "ck", "t0", "--epochs-phase1", "1", "--epochs-phase2", "1",
                      "--auto-resume")
    return root, run


def test_train_unet_auto_resume_continues_phase_2(first_run, capsys):
    """Restarted with ``--auto-resume`` and one more phase-2 epoch, the run
    skips phase 1, resumes phase 2 at epoch 1 and appends to its log."""
    root, run = first_run
    meta = json.loads((run / "latest_state.json").read_text())
    assert (meta["phase"], meta["epoch"]) == (2, 0)
    phase1_log = (run / "phase1_training.log").read_text()
    _train_unet(root, run.parent, "t0", "--epochs-phase1", "1", "--epochs-phase2", "2",
                "--auto-resume")
    out = capsys.readouterr().out
    assert "[resume] phase 1 already complete" in out and "[resume] phase 2 from epoch 1" in out
    assert (run / "phase1_training.log").read_text() == phase1_log
    rows = (run / "phase2_training.log").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["epoch", "0", "1"]
    assert json.loads((run / "latest_state.json").read_text())["epoch"] == 1


def test_train_unet_resume_from_skips_phase_1(first_run, tmp_path):
    """``--resume-from`` a run dir: no phase 1, and phase 2 starts from that
    run's best weights (with no phase-2 epoch, they are the final weights,
    bit for bit)."""
    root, run = first_run
    new = _train_unet(root, tmp_path, "t1", "--resume-from", str(run), "--epochs-phase2", "0")
    assert not (new / "phase1_training.log").exists() and not (new / "phase1_best").exists()
    want, got = _weights(run, "weights_best_overall"), _weights(new, "weights_best_overall")
    assert want.keys() == got.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_train_unet_pretrained_weights_and_profile_dir(first_run, tmp_path, capsys):
    """``--pretrained-weights`` a run dir merges its best weights by name
    into the fresh init, so the encoder, frozen in phase 1, stays the
    pretrained one; ``--profile-dir`` writes the run's torch.profiler trace."""
    root, run = first_run
    new = _train_unet(root, tmp_path, "t2", "--pretrained-weights", str(run),
                      "--epochs-phase1", "1", "--epochs-phase2", "0",
                      "--profile-dir", str(tmp_path / "prof"))
    assert f"[pretrained] merged by name from {run}" in capsys.readouterr().out
    want, got = _weights(run, "weights_best_overall"), _weights(new, "phase1_best")
    init = _flat(torch_unet_to_flax(init_unet_params(
        DilatedUNet(init_nb=44, use_deep_supervision=True, device="meta"), 865)))
    encoder = [k for k in got if "/down" in k]
    assert len(encoder) == 12
    for k in encoder:
        assert np.array_equal(got[k], want[k]), k
        assert not np.array_equal(got[k], init[tuple(k.split("/"))]), k
    trace = json.loads((tmp_path / "prof" / "train_unet_trace.json").read_text())
    assert any(e.get("name") == "aten::conv2d" for e in trace["traceEvents"])
