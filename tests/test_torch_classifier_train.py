"""The port's InceptionV3 classifier training against the JAX package's, on
the CPU.

The train-mode forward with frozen BatchNorms, the freeze masks, the train
step in each phase, the train prep on JAX's augmentation draws, the
metrics, the class weights, the dataset's batch order and a tiny
``adipose-torch train-classifier`` run. The model is the full-width
InceptionV3 in float32 at 107^2 (the smallest input whose last stage is
still 2x2, so the batch statistics there have four values per sample) and
batch 4, from the port's seeded init (random running statistics, so
the frozen BatchNorms do work). Each JAX function is compiled once with
XLA's CPU optimizations off. Every tolerance is stated beside its test.
"""

import dataclasses
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adipose_tpu.core.config import TrainConfig as JaxTrainConfig
from adipose_tpu.data.loader import ClassificationDataset as JaxClassificationDataset
from adipose_tpu.models import inception as jinc
from adipose_tpu.ops import metrics as jmetrics
from adipose_tpu.train import trainer_classifier as jtc
from adipose_tpu.train.state import TrainState as JaxTrainState
from adipose_tpu.train.state import classifier_stats_mask as jax_stats_mask
from adipose_tpu.train.state import make_optimizer
from adipose_tpu_torch.serving.predict import load_classifier
from adipose_tpu_torch.cli.main import main as torch_main
from adipose_tpu_torch.data.augment import (TIER_STAGES, augment_classification_batch,
                                            augment_grayscale_classification,
                                            batched_classification, draw_tier)
from adipose_tpu_torch.data.loader import ClassificationDataset
from adipose_tpu_torch.models import inception as inc
from adipose_tpu_torch.models.convert import flax_inception_to_torch, torch_inception_to_flax
from adipose_tpu_torch.ops.metrics import binary_accuracy, roc_auc
from adipose_tpu_torch.train import trainer_classifier as tc
from adipose_tpu_torch.train.state import TrainState, classifier_stats_mask
from test_torch_augment import jax_tier_draws

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
B, SIZE = 4, 107
FROZEN = (0, 70, 94)
CLASS_W = np.array([1.0, 1.5], np.float32)
LABELS = np.array([1.0, 0.0, 0.0, 1.0], np.float32)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Tier-1 runs six test processes on one shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fast_jit(fn, *args, **jit_kwargs):
    """Compile ``fn`` (a function or a ``jax.jit`` object) for ``args`` once,
    without LLVM's optimization passes; the compiled program."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn, **jit_kwargs)
    return jitted.lower(*args).compile(compiler_options=FAST)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    """The port's seeded classifier init as the Flax tree (numpy)."""
    model = inc.InceptionV3Classifier(compute_dtype=torch.float32)
    return torch_inception_to_flax(model.init_params(torch.Generator().manual_seed(0))
                                   .state_dict())


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(1).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)


def torch_model(variables) -> inc.InceptionV3Classifier:
    model = inc.InceptionV3Classifier(dropout_rate=0.0, compute_dtype=torch.float32)
    model.load_state_dict(flax_inception_to_torch(variables))
    return model


# ---- the train-mode forward --------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward(variables, x):
    """JAX ``apply(..., train=True, frozen_below=k, mutable=["batch_stats"])``
    for each k, in one compiled program."""
    model = jinc.InceptionV3Classifier(dropout_rate=0.0, dtype=jnp.float32)

    def forward(v, x):
        return [model.apply(v, x, train=True, frozen_below=k, mutable=["batch_stats"])
                for k in FROZEN]

    return _np(fast_jit(forward, variables, x)(variables, x))


@pytest.mark.parametrize("k", range(len(FROZEN)))
def test_train_forward_matches_jax(variables, x, jax_forward, k):
    """Probabilities within 2e-4 absolute and the updated running statistics
    within 1e-5 of each leaf's max: the f32 batch statistics are summed in
    another order (1e-7 relative at the first convs) and each batch-statistic
    normalization carries the gap on, to 3.5e-6 at the last convs and 5e-5
    in the probabilities at k = 0 (measured, with XLA's optimizations on or
    off). ConvBN i < k keeps its statistics bit for bit on both sides and the
    port reports no update for it."""
    frozen_below = FROZEN[k]
    want_probs, want_mut = jax_forward[k]
    model = torch_model(variables)
    before = {n: b.clone() for n, b in model.named_buffers()}
    probs, stats = model(torch.from_numpy(x), train=True, frozen_below=frozen_below)
    assert np.abs(probs.detach().numpy() - want_probs).max() <= 2e-4
    want = flax_inception_to_torch({"batch_stats": want_mut["batch_stats"]})
    assert set(stats) == {n for n in want if inc._conv_index(n) >= frozen_below}
    for name, w in want.items():
        assert torch.equal(dict(model.named_buffers())[name], before[name])  # never in place
        if inc._conv_index(name) < frozen_below:
            assert torch.equal(w, before[name]), name
        else:
            assert (stats[name] - w).abs().max() <= 1e-5 * w.abs().max(), name


def test_eval_forward_and_dropout():
    """Outside training the forward is the serving forward; in training the
    dropout keeps ~(1 - rate) of the pooled features, scaled by
    1 / (1 - rate), and needs a generator."""
    model = inc.InceptionV3Classifier(dropout_rate=0.4, compute_dtype=torch.float32)
    pooled = torch.ones(64, 2048)
    with pytest.raises(ValueError, match="needs a generator"):
        model._dropout(pooled, None)
    y = model._dropout(pooled, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.6))
    assert abs(kept.float().mean().item() - 0.6) < 0.01


# ---- the freeze masks ----------------------------------------------------------

UNFREEZE = [None] + [f"mixed{i}" for i in range(11)]


@pytest.mark.parametrize("unfreeze_from", UNFREEZE)
def test_freeze_masks_match_jax(variables, unfreeze_from):
    """The unfreeze boundary, the param mask and the statistics mask, leaf
    for leaf through the converter: exact."""
    assert inc.unfreeze_conv_start(unfreeze_from) == jinc.unfreeze_conv_start(unfreeze_from)
    assert inc.frozen_conv_boundary(unfreeze_from) == jinc.frozen_conv_boundary(unfreeze_from)
    jmask = jinc.backbone_param_mask(variables["params"], unfreeze_from)
    jsmask = jax_stats_mask(variables["batch_stats"], jmask)
    want = {k: bool(v) for k, v in flax_inception_to_torch(
        {"params": jmask, "batch_stats": jsmask}).items()}
    state = flax_inception_to_torch(variables)
    params = {k: v for k, v in state.items() if not k.endswith((".mean", ".var"))}
    mask = inc.backbone_param_mask(params, unfreeze_from)
    smask = classifier_stats_mask([k for k in state if k not in params], mask)
    assert {**mask, **smask} == want
    start = {None: 94, "mixed7": 70, "mixed10": 94}.get(unfreeze_from)
    if start is not None:
        assert sum(mask.values()) == 2 + 2 * (94 - start)  # head + conv and bn per ConvBN


# ---- the train step --------------------------------------------------------------

# (unfreeze_from, lr, bounds). Phase 1 trains the head alone on features
# both sides compute alike (loss 7e-7 relative, moves 3e-3 lr apart at most,
# measured). Phase 2 trains 24 convs through batch-statistic BatchNorms at
# batch 4: a conv's gradient there is the difference of nearly equal terms,
# and Adam moves a weight by about lr whatever its gradient's size (|step| <=
# lr at step 1), so a tiny gradient whose sign flips under another summation
# order moves it up to 2 lr the other way, each step. Measured after steps 1
# and 2: moves 2.0 and 3.9 lr apart at most, 1.3e-3 and 1.4e-2 lr on
# average; loss 3.7e-6 and 1.0e-4 relative; statistics 2.6e-6 and 1.1e-4
# of each leaf's max.
PHASES = {
    1: (None, 1e-3, {"loss": 1e-5, "move_max": 1e-2, "move_mean": 1e-4, "stats": 0.0}),
    2: ("mixed7", 1e-4, {"loss": 5e-4, "move_max": 2.05, "move_mean": 5e-2, "stats": 5e-4}),
}


def _count_leaves(opt_state) -> list[int]:
    return [int(v) for p, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]
            if p and "count" in jax.tree_util.keystr(p)]


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_train_steps_match_jax(variables, x, phase):
    """Two steps of each phase (dropout off, class weights 1 and 1.5)
    against JAX ``_make_train_step`` with the masked Keras Adam, after each
    step: loss within ``loss`` relative, acc exact; each trainable param
    within ``move_max`` lr of JAX's times the steps taken (2 lr a step in
    phase 2, see ``PHASES``) and all of them within ``move_mean`` lr on
    average; the updated running statistics within ``stats`` of each leaf's
    max. Frozen params and statistics bit-unchanged on both sides; Adam's
    count 2 on both."""
    unfreeze_from, lr, bounds = PHASES[phase]
    jmodel = jinc.InceptionV3Classifier(dropout_rate=0.0, dtype=jnp.float32)
    jmask = jinc.backbone_param_mask(variables["params"], unfreeze_from)
    jsmask = jax_stats_mask(variables["batch_stats"], jmask)
    tx = make_optimizer("adam", lr, 0.01, jmask)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables["params"]), tx,
                                  jax.tree.map(jnp.asarray, variables["batch_stats"]))
    jstep = jtc._make_train_step(jmodel, 0.1, jsmask,
                                 frozen_below=jinc.frozen_conv_boundary(unfreeze_from))
    args = (jnp.asarray(x), jnp.asarray(LABELS), jnp.asarray(CLASS_W), jax.random.PRNGKey(0))
    compiled = fast_jit(jstep, jstate, *args)
    want = []
    for _ in range(2):
        jstate, m = compiled(jstate, *args)
        want.append((flax_inception_to_torch(_np({"params": jstate.params,
                                                  "batch_stats": jstate.batch_stats})),
                     _np(m), _count_leaves(jstate.opt_state)))

    model = torch_model(variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    mask = inc.backbone_param_mask(params, unfreeze_from)
    smask = classifier_stats_mask(dict(model.named_buffers()), mask)
    state = TrainState.create(params, "adam", lr, 0.01, mask)
    step = tc._make_train_step(model, 0.1, smask, inc.frozen_conv_boundary(unfreeze_from))
    xt, yt, wt = (torch.from_numpy(a) for a in (x, LABELS, CLASS_W))
    for n, (want_state, want_m, want_counts) in enumerate(want, 1):
        got = step(state, xt, yt, wt, None)
        loss = float(want_m["loss"])
        assert abs(got["loss"].item() - loss) <= bounds["loss"] * abs(loss)
        assert got["acc"].item() == float(want_m["acc"])
        now = model.state_dict()
        moved = []
        for k, w in want_state.items():
            if not (mask[k] if k in mask else smask[k]):
                assert torch.equal(now[k], start[k]) and torch.equal(w, start[k]), k
            elif k in mask:
                gap = (now[k] - w).abs()
                assert gap.max() <= bounds["move_max"] * n * lr, (k, gap.max())
                moved.append(gap.reshape(-1))
            else:
                assert (now[k] - w).abs().max() <= bounds["stats"] * w.abs().max(), k
        assert torch.cat(moved).mean() <= bounds["move_mean"] * lr
    assert state.optimizer.count == 2 and set(want_counts) == {2}


# ---- the train prep ------------------------------------------------------------


@pytest.mark.parametrize("low_res", [False, True])
def test_preprocess_step_matches_jax_on_its_draws(low_res):
    """``_make_preprocess_step`` on uint8-valued 64^2 tiles against JAX's,
    fed JAX's classification draws: within 1e-5 on the [-1, 1] scale, a few
    float32 ulps (measured 1.3e-6: jnp.percentile's sort and the port's bins
    agree on uint8-valued tiles to 4.2e-7 of the unit scale, the
    augmentation's exp and pow and the resize weights to an ulp or so)."""
    rs = np.random.RandomState(5)
    yy, xx = np.mgrid[:64, :64]
    tiles = np.clip(rs.rand(4, 64, 64) * 120 + 60 + 50 * np.sin(xx / 6.0 + yy / 9.0),
                    0, 255).astype(np.uint8)
    key = jax.random.PRNGKey(0)  # every stage acts on some tile under this key
    size = tc.INCEPTION_SIZE if low_res else 64
    prep = jtc._make_preprocess_step(True, 1.0, 99.0, augment_low_res=low_res)

    def both(images, key):
        return prep(images, key), jax_tier_draws(key, "classification", (4, size, size))

    want, (tid, drawn) = _np(fast_jit(both, jnp.asarray(tiles), key)(jnp.asarray(tiles), key))
    draws = {"tid": torch.from_numpy(np.array(tid)).to(torch.int32),
             "stages": [{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in drawn]}
    stages = TIER_STAGES["classification"]
    acts = {st.kind: (d["gate"] > 1 - st.prob) if st.kind in ("brightness", "contrast", "gamma")
            else d["gate"] <= st.prob for st, d in zip(stages, drawn)}
    assert len(set(tid.tolist())) > 2 and all(a.any() for a in acts.values()), acts
    got = tc._make_preprocess_step(True, 1.0, 99.0, low_res)(torch.from_numpy(tiles), draws)
    assert got.shape == want.shape == (4, 299, 299, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_classification_draws_and_single_tile_entry_points():
    """``augment_classification_batch`` is ``batched_classification`` on the
    generator's ``draw_tier`` draws, and ``augment_grayscale_classification``
    a batch of one; the values stay in [0, 255]."""
    images = torch.from_numpy(np.random.RandomState(2).rand(3, 32, 32).astype(np.float32) * 255)
    got = augment_classification_batch(torch.Generator().manual_seed(4), images)
    draws = draw_tier(torch.Generator().manual_seed(4), "classification", 3, 32, 32)
    assert torch.equal(got, batched_classification(draws, images))
    assert got.shape == images.shape and got.min() >= 0 and got.max() <= 255
    one = augment_grayscale_classification(torch.Generator().manual_seed(4), images[0])
    first = batched_classification(draw_tier(torch.Generator().manual_seed(4),
                                             "classification", 1, 32, 32), images[:1])
    assert torch.equal(one, first[0])


# ---- metrics, class weights, dataset --------------------------------------------

AUC_CASES = {
    "ties": (np.round(np.random.RandomState(3).rand(40), 1), np.random.RandomState(4).rand(40)),
    "separable": (np.linspace(0, 1, 12), np.r_[np.zeros(6), np.ones(6)]),
    "one_class": (np.random.RandomState(5).rand(9), np.ones(9)),
}


@pytest.mark.parametrize("case", sorted(AUC_CASES))
def test_roc_auc_and_accuracy_match_jax(case):
    """Exact rank sums on these sizes; 1e-6 absolute covers float32 order.
    One class gives NaN on both sides."""
    pred, true = (a.astype(np.float32) for a in AUC_CASES[case])
    true = (true > 0.5).astype(np.float32)
    want_auc = float(jmetrics.roc_auc(jnp.asarray(pred), jnp.asarray(true)))
    got_auc = roc_auc(torch.from_numpy(pred), torch.from_numpy(true)).item()
    if case == "one_class":
        assert np.isnan(want_auc) and np.isnan(got_auc)
    else:
        assert abs(got_auc - want_auc) <= 1e-6
    assert binary_accuracy(torch.from_numpy(true), torch.from_numpy(pred)).item() == float(
        jmetrics.binary_accuracy(jnp.asarray(true), jnp.asarray(pred)))


SLIDE_NAMES = ["6 BEEF Shoulder -1_grid_5x5_r1_c2_r0_c1.jpg", "s1_r0_c0.jpg", "s1_r0_c1.jpg",
               "s2_r0_c0.jpg", "slide0_r3_c0.jpg", "nosuffix.jpg", "a_b_r1.jpg",
               "dir/x_rr_cc_r10_c20.jpg"]


def test_slide_base_and_class_weights_match_jax():
    for name in SLIDE_NAMES:
        assert tc.extract_slide_base(name) == jtc.extract_slide_base(name), name
    labels = [1, 1, 0, 0, 1, 0, 1, 0]
    for mult in (1.0, 2.5):
        assert tc.compute_image_level_class_weights(SLIDE_NAMES, labels, mult) == \
            jtc.compute_image_level_class_weights(SLIDE_NAMES, labels, mult)
    assert tc.compute_image_level_class_weights(SLIDE_NAMES[:2], [1, 1]) == {0: 0.0, 1: 0.5}


def _write_class_dataset(root, size, n_per_class, seed=0):
    """``<split>/{adipose,not_adipose}/*.jpg``: bright and dark noisy tiles
    from two slides each."""
    rng = np.random.RandomState(seed)
    for split, n in n_per_class.items():
        for cls, base in (("adipose", 190), ("not_adipose", 70)):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                img = np.clip(base + rng.randint(-40, 40, (size, size)), 0, 255).astype(np.uint8)
                cv2.imwrite(str(d / f"s{i % 2}_r{i}_c0.jpg"), img)
    return root


def test_classification_batches_match_jax(tmp_path):
    """Files, labels and uint8 batches bit-identical, epoch by epoch, the
    short final batch padded by repeating its last index."""
    root = _write_class_dataset(tmp_path, 12, {"train": 5})
    ours = ClassificationDataset(root / "train", 4, seed=865)
    theirs = JaxClassificationDataset(root / "train", 4, seed=865)
    assert ours.files == theirs.files and np.array_equal(ours.labels, theirs.labels)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3
    assert ours.class_counts() == theirs.class_counts() == (5, 5)
    for epoch in range(3):
        for shuffle in (True, False):
            a = list(ours.epoch_batches(epoch, shuffle))
            b = list(theirs.epoch_batches(epoch, shuffle))
            assert len(a) == len(b) == 3
            for (ia, la), (ib, lb) in zip(a, b):
                assert np.array_equal(ia, ib) and np.array_equal(la, lb)


# ---- adipose-torch train-classifier ----------------------------------------------


def test_train_classifier_cli_writes_the_artifact_contract(tmp_path):
    """1 + 1 epochs at batch 2 on 4 + 4 tiny tiles at the CLI defaults
    (bf16, percentile, mixed7, label smoothing, dropout, class weights on):
    config.json with the JAX keys, the CSV columns, ``weights_best`` and
    ``weights_final`` with the JAX tree's keys and shapes, convs 0-69 and
    their statistics bit-unchanged from the seeded init through both
    phases; ``weights_best`` then serves through ``load_classifier``."""
    root = _write_class_dataset(tmp_path, 48, {"train": 2, "val": 2})
    torch_main(["train-classifier", "--dataset-root", str(root), "--warmup-epochs", "1",
                "--finetune-epochs", "1", "--batch-size", "2", "--use-class-weights",
                "--device", "cpu", "--checkpoint-dir", str(tmp_path / "runs"),
                "--suffix", "_t"])
    (run,) = (tmp_path / "runs").iterdir()
    assert run.name.endswith("_classifier_adipose_sybreosin_percentile_t")
    config = json.loads((run / "config.json").read_text())
    assert set(config) == {"label_smoothing", "percentile_norm", "augment_low_res",
                           "class_weights"} | set(dataclasses.asdict(JaxTrainConfig()))
    assert config["batch_size"] == 2 and config["class_weights"] == {"0": 0.5, "1": 0.5}
    rows = (run / "training.log").read_text().splitlines()
    assert rows[0].split(",") == ["epoch", "loss", "acc", "val_auc", "val_acc", "lr",
                                  "epoch_time_s"]
    assert len(rows) == 2 and np.isfinite([float(v) for v in rows[1].split(",")]).all()

    shapes = jax.eval_shape(jinc.InceptionV3Classifier().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 75, 75, 3)))
    want = {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    init = inc.InceptionV3Classifier().init_flax(
        tc.generator_for("classifier.init", 865)).state_dict()
    for entry in ("weights_best", "weights_final"):
        tree = tc.ckpt.load_params(run / entry)
        assert {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]} == want
    final = flax_inception_to_torch(tc.ckpt.load_params(run / "weights_final"))
    for k, v in final.items():
        idx = inc._conv_index(k)
        if idx is not None and idx < 70:
            assert torch.equal(v, init[k]), k
    assert not torch.equal(final["adipose_score.weight"], init["adipose_score.weight"])

    predict, state = load_classifier(run, device="cpu")
    tiles = torch.from_numpy(np.stack([cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) for p in
                                       sorted((root / "val").rglob("*.jpg"))]))
    probs = predict(state, tiles)
    assert probs.shape == (4,) and torch.isfinite(probs).all()
    assert ((probs >= 0) & (probs <= 1)).all()

