"""The plain references against the port on the CPU, at small widths and
tiles, the port in float32 with its kernels' plain versions. The tests may
import the port; the references may not (``test_bench_guard.py``)."""

import pytest
import torch

from bench_h100 import common, weights
from bench_h100.reference import augment, inception, train, unet

CONFIG = {"init_nb": 6, "dilation_rates": [1, 2, 4, 8, 16, 32], "dropout_rate": 0.3}
SIZE = 64


def port_unet(params, deep_supervision=False, fast_head=False):
    from adipose_tpu_torch.models.unet import DilatedUNet

    model = DilatedUNet(init_nb=CONFIG["init_nb"], use_deep_supervision=deep_supervision,
                        compute_dtype=torch.float32, fast_head=fast_head)
    model.load_state_dict(params)
    return model


def seeded(seed, domain):
    return common.generator(seed, domain, "cpu")


@pytest.fixture
def tiles_u8():
    from bench_h100.tiles import blob_tiles

    return blob_tiles(3, SIZE, seeded(3, "traffic"), blobs=(0, 8))


@pytest.mark.parametrize("fast_head", [False, True])
def test_unet_inference(tiles_u8, fast_head):
    params = weights.unet(CONFIG, seeded(1, "weights"))
    x = unet.zscore(tiles_u8[0], 120.0, 45.0)
    model = port_unet(params, fast_head=fast_head).eval()
    with torch.no_grad():
        want = model(x)
        got = unet.forward(params, x, CONFIG["dilation_rates"])
    assert got.shape == (3, SIZE, SIZE)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_d4_members_match_the_port():
    from adipose_tpu_torch.ops.d4 import apply_transform_batch

    x = torch.arange(2 * 5 * 5, dtype=torch.float32).view(2, 5, 5)
    for k in range(8):
        want = apply_transform_batch(x, torch.full((2,), k, dtype=torch.int32))
        assert torch.equal(inception.d4(x, k), want), k


def test_augment_matches_the_port(tiles_u8):
    from adipose_tpu_torch.data.augment import augment_batch

    images, masks = (t.to(torch.float32) for t in tiles_u8)
    for seed in range(4):  # gates differ by seed: zoom, warp and blur all show up
        want = augment_batch(seeded(seed, "steps"), images, masks, "moderate")
        got = augment.apply(augment.draw(seeded(seed, "steps"), "moderate", 3, SIZE, SIZE),
                            images, masks, "moderate")
        torch.testing.assert_close(got[0], want[0], atol=2e-3, rtol=0)
        assert torch.equal(got[1], want[1])


def test_percentile_matches_the_kernel_plain_version(tiles_u8):
    from adipose_tpu_torch.ops.cuda.percentile import percentile_normalize_u8_plain

    x = tiles_u8[0].to(torch.float32) + 0.3
    assert torch.equal(inception.percentile_unit(x, 1.0, 99.0),
                       percentile_normalize_u8_plain(x, 1.0, 99.0))


def test_training_step_matches_the_port(tiles_u8):
    from adipose_tpu_torch.core.config import TrainConfig
    from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
    from adipose_tpu_torch.train.trainer_unet import _make_fused_train_step, make_augment_step

    traffic = common.load_json(common.BENCH_DIR / "traffic" / "train-b8.json")
    params = weights.unet(CONFIG, seeded(1, "weights"), deep_supervision=True)
    model = port_unet({k: v.clone() for k, v in params.items()}, deep_supervision=True)
    cfg = TrainConfig(use_hard_mining=True, normalization_method="percentile")
    state = TrainState.create(dict(model.named_parameters()), "adam", 1e-5, 0.01, None)
    step = _make_fused_train_step(model, unet_loss_from_config(cfg), "percentile", 1.0, 99.0)
    gen = seeded(2, "steps")
    ref_params = {k: v.clone() for k, v in params.items()}
    opt = train.KerasAdam(ref_params, 1e-5)
    ref_gen = seeded(2, "steps")
    zero = torch.tensor(0.0)
    for _ in range(2):
        images, masks = make_augment_step("moderate")(gen, *tiles_u8)
        loss = step(state, images, masks, gen, zero, zero)["loss"]
        ref_loss, _ = train.step(ref_params, opt, ref_gen, *tiles_u8, CONFIG, traffic)
        assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for k, p in state.params.items():
        torch.testing.assert_close(ref_params[k], p.detach(), atol=1e-7, rtol=1e-5)


@pytest.fixture(scope="module")
def inception_params():
    return weights.inception(seeded(4, "weights"))


def test_inception_classify(inception_params):
    from adipose_tpu_torch.models.inception import InceptionV3Classifier

    model = InceptionV3Classifier(compute_dtype=torch.float32)
    model.load_state_dict(inception_params)
    x = torch.randn((2, 107, 107, 3), generator=seeded(5, "x"))
    with torch.no_grad():
        want = model.eval()(x)
        got = inception.classify(inception_params, x.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_inception_tta_predict(inception_params, tiles_u8):
    from adipose_tpu_torch.eval.classifier_eval import make_classifier_tta_predict
    from adipose_tpu_torch.models.inception import InceptionV3Classifier
    from adipose_tpu_torch.train.trainer_classifier import _make_val_step

    model = InceptionV3Classifier(compute_dtype=torch.float32, device="meta")
    predict = make_classifier_tta_predict(_make_val_step(model, True, 1.0, 99.0), "full")
    tiles = tiles_u8[0][:2]
    want = predict(inception_params, tiles)
    got = inception.tta_probabilities(inception_params, tiles)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
