"""The cascade's reference, traffic and check on the CPU at small sizes:
``DualModelWSIPipeline.run_many`` in float32 with its kernels' plain
versions against ``reference/cascade.py``, and the cell's entry, whose
check finds planted faults."""

import numpy as np
import pytest
import torch

from bench_h100 import common, run, slides, weights
from bench_h100.reference import cascade as ref

TILE = 64
CHUNKS = [(186, 256), (128, 320)]  # the first cut with clamped origins, 6 rows shared
SEG = dict(common.load_json(common.BENCH_DIR / "configs" / "dilated-unet-nb44.json"),
           init_nb=6, tile_size=TILE)
MEAN, STD = 120.0, 45.0
# Both sides in float32: the gate's probabilities differ by the order of
# the convs' sums (tests/test_bench_reference.py holds classify to 1e-5),
# a map's pixel by the U-Net's (2e-6 there) through the blend's quotient.
GATE_ATOL = 1e-5
MAP_ATOL = 1e-5


def seeded(seed, domain):
    return common.generator(seed, domain, "cpu")


def entry_module():
    return run.load_file("entries", "cascade")


def small_spec():
    spec = common.cell_spec("cascade-3chunks")
    spec["config"].update(chunks=[list(c) for c in CHUNKS], tile_size=TILE, segmenter=SEG)
    return spec


@pytest.mark.parametrize("shape,tile,overlap", [((6144, 6144), 1024, 0.0),
                                                ((3000, 5000), 1024, 0.0),
                                                ((200, 256), 64, 0.0), ((200, 256), 64, 0.25),
                                                ((64, 300), 64, 0.5)])
def test_tile_origins_are_the_programs(shape, tile, overlap):
    from adipose_tpu_torch.ops.blend import sliding_window_positions

    got = ref.tile_origins(shape, tile, overlap)
    np.testing.assert_array_equal(got, sliding_window_positions(shape, tile, overlap))


def test_the_cells_slides_are_cut_into_75_tiles():
    cfg = common.load_json(common.BENCH_DIR / "configs" / "adipose-cascade-6144.json")
    assert [len(ref.tile_origins(c, 1024)) for c in cfg["chunks"]] == [36, 24, 15]


@pytest.mark.parametrize("seed", [2**31 + 1, 7])
def test_the_traffics_tiles_keep_clear_of_the_qc_thresholds(seed):
    gen = seeded(seed, "traffic")
    for c in [slides.chunk(shape, TILE, gen) for shape in CHUNKS]:
        verdict = ref.qc(ref.cut(torch.from_numpy(c.image), c.origins, TILE))
        assert ref.margins(verdict) > 0.3
        good = np.isin(c.kind, (slides.COARSE, slides.FINE))
        np.testing.assert_array_equal(verdict["good"].numpy(), good)
        counts = np.bincount(c.kind, minlength=4)
        assert abs(counts[slides.FINE] - counts[slides.COARSE]) <= 1
        assert counts[slides.WHITE] >= 1 and counts[slides.BLURRY] >= 1


def test_the_threshold_lies_in_the_widest_gap_of_the_middle_band():
    probs = np.array([0.1, 0.12, 0.2, 0.3, 0.31, 0.6, 0.62, 0.9, 0.95, 0.97])
    thr, margin = entry_module().threshold_between(probs, [40, 60])
    assert thr == pytest.approx(0.455) and margin == pytest.approx(0.145)


def test_the_fit_head_puts_the_textures_at_their_logits():
    gen = seeded(3, "x")
    pooled = torch.randn(8, 16, generator=gen)
    kind = np.array([0, 1] * 4, dtype=np.int8)
    w, b = entry_module().fit_head(pooled, kind, 2.0)
    logits = (pooled @ w.T + b)[:, 0]
    assert float(logits[kind == 1].mean()) == pytest.approx(2.0, abs=1e-5)
    assert float(logits[kind == 0].mean()) == pytest.approx(-2.0, abs=1e-5)


@pytest.fixture(scope="module")
def models():
    """The U-Net's seeded weights at init_nb 6, and InceptionV3's at its own
    widths with the head fit as the entry fits it, on the traffic's tiles."""
    gen = seeded(5, "traffic")
    chunks = [slides.chunk(shape, TILE, gen) for shape in CHUNKS]
    seg = weights.unet(SEG, seeded(5, "weights.segmenter"))
    gate = weights.inception(seeded(5, "weights.gate"))
    with torch.no_grad():
        pooled = torch.cat([ref.gate_features(gate, ref.cut(torch.from_numpy(c.image),
                                                            c.origins, TILE))
                            for c in chunks])
    gate["adipose_score.weight"], gate["adipose_score.bias"] = entry_module().fit_head(
        pooled, np.concatenate([c.kind for c in chunks]), 2.0)
    return chunks, seg, gate


def test_the_pipeline_in_float32_is_the_reference(models):
    from adipose_tpu_torch.models.inception import InceptionV3Classifier
    from adipose_tpu_torch.models.unet import DilatedUNet
    from adipose_tpu_torch.ops.cuda.preprocess import fused_zscore_normalize
    from adipose_tpu_torch.train.state import make_unet_predict
    from adipose_tpu_torch.train.trainer_classifier import _make_val_step
    from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

    chunks, seg, gate = models
    unet = make_unet_predict(DilatedUNet(init_nb=6, compute_dtype=torch.float32, device="meta"))
    pipe = DualModelWSIPipeline(
        _make_val_step(InceptionV3Classifier(compute_dtype=torch.float32, device="meta"),
                       True, 1.0, 99.0), gate,
        lambda p, t: unet(p, fused_zscore_normalize(t, MEAN, STD)[0]), seg,
        tile_size=TILE, batch_size=4, transfer_dtype="float32", device="cpu")
    with torch.no_grad():
        want = []
        for c in chunks:
            tiles = ref.cut(torch.from_numpy(c.image), c.origins, TILE)
            good = ref.qc(tiles)["good"].numpy()
            prob = ref.gate_head(gate, ref.gate_features(gate, tiles)).numpy()
            want.append((tiles, good, prob))
    probs = np.concatenate([p[g] for _, g, p in want])
    pipe.classifier_threshold, margin = entry_module().threshold_between(probs, [40, 60])
    assert margin > 0.05
    wmap = ref.weight_map(TILE)
    for c, r, (tiles, good, prob) in zip(chunks, pipe.run_many([c.image for c in chunks]),
                                         want):
        positive = good & (prob >= pipe.classifier_threshold)
        with torch.no_grad():
            maps = ref.segment(seg, tiles[torch.from_numpy(positive)], MEAN, STD,
                               SEG["dilation_rates"])
        expected = ref.blend(c.image.shape, c.origins, positive, maps, wmap).numpy()
        assert (r.n_tiles, r.n_good, r.n_positive) == (len(c.origins), good.sum(),
                                                       positive.sum())
        assert 0 < r.n_positive < r.n_good < r.n_tiles
        np.testing.assert_array_equal(r.positions, c.origins)
        np.testing.assert_array_equal(r.is_good, good)
        np.testing.assert_allclose(r.gate_prob, prob, atol=GATE_ATOL, rtol=0)
        np.testing.assert_allclose(r.probability_map, expected, atol=MAP_ATOL, rtol=0)


def zero_gate(entry):
    entry.pipe.classifier_predict = lambda state, tiles: torch.zeros(
        tiles.shape[0], dtype=torch.float32, device=tiles.device)


def altered_map(entry):
    predict = entry.predict

    def broken(params, tiles):
        out = predict(params, tiles).clone()
        out[0] = 1.0 - out[0]
        return out

    entry.predict = broken


@pytest.mark.parametrize("fault,breaks", [(None, None), (zero_gate, "route_flips"),
                                          (altered_map, "prob_gap_max")])
def test_the_check_finds_a_planted_fault(fault, breaks):
    result, lines = run.run_cell(small_spec(), 2**31 + 41, 0.3, False, torch.device("cpu"),
                                 entry_hook=fault)
    checks = result["checks"]
    assert set(checks) == {"prob_gap_max", "gate_gap_max", "route_flips"}
    if fault is None:
        assert result["correct"] is True, checks
        assert checks["route_flips"]["value"] == 0
    else:
        assert result["correct"] is False
        assert checks[breaks]["value"] > checks[breaks]["limit"], checks


def test_either_model_in_float8_reads_far_above_the_program():
    """The control with both models in float8, as ``control.py`` runs it,
    and with each alone: each reads its own model's number at over 3x the
    program's."""
    from bench_h100 import control

    spec = small_spec()
    r = control.readings(spec, 2**31 + 43, 0.3, torch.device("cpu"), control=True)
    assert r["control"]["prob_gap_max"] > 3 * r["program"]["prob_gap_max"], r
    assert r["control"]["gate_gap_max"] > 3 * r["program"]["gate_gap_max"], r
    entry = entry_module().build(spec, 2**31 + 43, torch.device("cpu"))
    entry.warm()
    samples = [(i, entry.request(i)) for i in range(2)]
    gate, segmenter = (entry.check(samples, control=m) for m in ("gate", "segmenter"))
    assert gate["gate_gap_max"] > 3 * r["program"]["gate_gap_max"], gate
    assert segmenter["prob_gap_max"] > 3 * r["program"]["prob_gap_max"], segmenter


def test_the_cascade_is_a_configuration_of_its_own():
    keys = [(c["source"], tuple(c["reduced"])) for c in common.load_json(
        common.ROOT / "BENCHMARK.json")["configs"]]
    assert len(set(keys)) == len(keys), keys
