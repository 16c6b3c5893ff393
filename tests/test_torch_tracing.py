"""Program spans and counters (``adipose_tpu_torch.core.tracing``) on the
CPU: off they cost a flag read; under a profiler session the request and
step paths record their span trees on the profiler's clock, and nothing of
them reaches the session's own events. Tests marked ``card`` need a CUDA GPU
and skip without one; on a card run them without the JAX test harness:
``python -m pytest --noconftest -m card tests/test_torch_tracing.py``."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from adipose_tpu_torch.cli import main as cli
from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.core.config import EvalConfig, TrainConfig
from adipose_tpu_torch.core.host_copy import HostCopy, copy_in_pinned, predict_batch
from adipose_tpu_torch.eval.evaluator import PublicationEvaluator
from adipose_tpu_torch.eval.tta import make_classifier_tta_predict
from adipose_tpu_torch.models.convert import torch_unet_to_flax
from adipose_tpu_torch.models.unet import DilatedUNet, FusedUpsampleConv
from adipose_tpu_torch.serving.export import export_model
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
from adipose_tpu_torch.train.trainer_classifier import _make_val_step
from adipose_tpu_torch.train.trainer_unet import _make_fused_train_step, make_augment_step

SIZE = 64
CLOCK_SLACK_US = 100.0  # a span against the profiler's events of its work
BF16_EPS = 2.0 ** -7  # bfloat16's machine epsilon: 8 significant bits


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A segmenter run dir: a seeded init_nb 4 U-Net at 64^2."""
    run = tmp_path_factory.mktemp("tracing") / "run"
    run.mkdir()
    model = DilatedUNet(init_nb=4).init_params(torch.Generator().manual_seed(3))
    ckpt.save_params(run, "weights_best_overall",
                     torch_unet_to_flax({k: v.detach() for k, v in model.state_dict().items()}))
    ckpt.save_normalization_stats(run, 127.0, 60.0)
    (run / "training_settings.log").write_text(f"init_nb: 4\ntile_size: {SIZE}\n")
    return run


def tiles(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE), dtype=np.uint8)


def session():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def tree(spans):
    """(name, [children's names in start order]) of each outermost span."""
    kids = {}
    for s in sorted(spans, key=lambda s: s["start_ns"]):
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append(s["name"])
    return [(s["name"], kids.get(s["id"], [])) for s in sorted(spans, key=lambda s: s["start_ns"])
            if s["parent"] is None]


def check_records(spans):
    """Parents, request ids and self times of a set of spans."""
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is None:
            assert s["request"] == s["id"]
        else:
            parent = ids[s["parent"]]
            assert s["request"] == parent["request"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        assert 0.0 <= s["host_self_ms"] <= s["host_ms"]
        assert s["device_ms"] is None and s["device_self_ms"] is None  # no CUDA here


def enclosed(spans, events, span_name, op_name, start_ns):
    """Each ``op_name`` event lies in a ``span_name`` span shifted by the
    session's start, within the slack; each such span holds one."""
    ops = [(e.time_range.start, e.time_range.end) for e in events if e.name == op_name]
    windows = [((s["start_ns"] - start_ns) / 1e3, (s["end_ns"] - start_ns) / 1e3)
               for s in spans if s["name"] == span_name]
    assert ops and windows
    for a, b in ops:
        assert any(lo - CLOCK_SLACK_US <= a and b <= hi + CLOCK_SLACK_US for lo, hi in windows), \
            (op_name, a, b, windows)
    for lo, hi in windows:
        assert any(lo - CLOCK_SLACK_US <= a and b <= hi + CLOCK_SLACK_US for a, b in ops)


def no_span_in_session(prof, spans):
    names = {s["name"] for s in spans}
    assert names and not names & {e.name for e in prof.events()}


# -- off ---------------------------------------------------------------------

def test_off_records_nothing_and_returns_the_shared_object():
    assert tracing.span("a") is tracing.span("b") is tracing.OFF
    with tracing.span("a") as s:
        assert s is tracing.OFF
    tracing.count("h2d_bytes", 10)
    assert tracing.records() == {"spans": [], "counters": {}, "dropped": 0}


def test_off_is_one_flag_read_on_the_hot_path(run, monkeypatch):
    """With the profiler off, the request path never reaches past the flag:
    the span class, the clock and the lock all raise."""
    def boom(*a, **k):
        raise AssertionError("tracing off went past the flag read")

    predict, params, _, _ = cli._load_segmenter(run, device="cpu")
    monkeypatch.setattr(tracing, "_Span", boom)
    monkeypatch.setattr(tracing, "time", None)
    monkeypatch.setattr(tracing, "_STATE", None)
    out = cli.segment_batch(predict, params, tiles(2), 2, "cpu")
    assert out.shape == (2, SIZE, SIZE)
    step = make_augment_step("moderate")
    images, _ = step(torch.Generator().manual_seed(0), torch.from_numpy(tiles(2)),
                     torch.from_numpy(tiles(2) > 127).to(torch.uint8))
    assert images.shape == (2, SIZE, SIZE)


# -- on: the module ----------------------------------------------------------

def test_on_spans_nest_by_thread_and_count():
    with session():
        with tracing.span("outer") as outer:
            with tracing.span("inner"):
                tracing.count("h2d_bytes", 3)
            tracing.count("h2d_bytes", 4)
        with tracing.span("next"):
            pass
    rec = tracing.records()
    assert outer is not tracing.OFF
    assert tree(rec["spans"]) == [("outer", ["inner"]), ("next", [])]
    assert rec["counters"] == {"h2d_bytes": 7} and rec["dropped"] == 0
    check_records(rec["spans"])
    assert len({s["request"] for s in rec["spans"]}) == 2


class FakeEvent:
    """A CUDA timing event on the CPU: its time is the host's at record."""

    made = 0

    def __init__(self, device, enable_timing):
        assert enable_timing
        FakeEvent.made += 1

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_only_spans_opened_for_the_device_hold_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch, "Event", FakeEvent)
    FakeEvent.made = 0
    with session():
        with tracing.span("request"):
            with tracing.span("work", device=True):
                time.sleep(0.002)
            with tracing.span("host"):
                pass
    spans = {s["name"]: s for s in tracing.records()["spans"]}
    assert FakeEvent.made == 2
    assert spans["request"]["device_ms"] is None and spans["host"]["device_ms"] is None
    assert spans["work"]["device_ms"] >= 2.0
    assert spans["work"]["device_self_ms"] == spans["work"]["device_ms"]
    FakeEvent.made = 0
    with tracing.span("work", device=True):  # off: no event either
        pass
    assert FakeEvent.made == 0


def test_the_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 2)
    with session():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    rec = tracing.records()
    assert [s["name"] for s in rec["spans"]] == ["s0", "s1"] and rec["dropped"] == 3


def test_records_since_a_mark():
    with session():
        with tracing.span("before"):
            pass
        mark = tracing.mark()
        with tracing.span("after"):
            pass
    assert [s["name"] for s in tracing.records(mark)["spans"]] == ["after"]


def test_threads_keep_their_own_parents_and_counts_add_up():
    """More threads than cores, a short switch interval: every span's parent
    is its own thread's outer span and no count is lost."""
    threads, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("n", 1)

        with session():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    rec = tracing.records()
    assert rec["counters"] == {"n": threads * rounds}
    spans = {s["id"]: s for s in rec["spans"]}
    assert len(spans) == 2 * threads * rounds
    for s in spans.values():
        if s["name"] == "inner":
            parent = spans[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"]
        else:
            assert s["parent"] is None and s["request"] == s["id"]


def test_spans_share_the_profilers_clock():
    """Two spans 20 ms apart each enclose their own ``aten::mm``."""
    a = torch.randn(128, 128)
    with session() as prof:
        with tracing.span("first"):
            a @ a
        time.sleep(0.02)
        with tracing.span("second"):
            a @ a
    start = prof.profiler.kineto_results.trace_start_ns()
    spans = tracing.records()["spans"]
    mms = sorted(e.time_range.start for e in prof.events() if e.name == "aten::mm")
    assert len(mms) == 2
    for s, t in zip(sorted(spans, key=lambda s: s["start_ns"]), mms):
        assert (s["start_ns"] - start) / 1e3 - CLOCK_SLACK_US <= t <= (s["end_ns"] - start) / 1e3
    no_span_in_session(prof, spans)


# -- on: the request and step paths -----------------------------------------

def test_segment_batch_records_its_tree_and_bytes(run):
    predict, params, _, _ = cli._load_segmenter(run, device="cpu")
    batch = tiles(3)
    with session() as prof:
        out = cli.segment_batch(predict, params, batch, 4, "cpu")
        cli.segment_batch(predict, params, tiles(4, 1), 4, "cpu")
    rec = tracing.records()
    spans = rec["spans"]
    assert tree(spans) == [("segment.batch", ["entry.h2d", "model.prep", "model.forward"])] * 2
    check_records(spans)
    assert len({s["request"] for s in spans}) == 2
    assert rec["counters"] == {"h2d_bytes": 2 * 4 * SIZE * SIZE,  # padded to the batch
                               "d2h_bytes": out.nbytes + 4 * SIZE * SIZE * 4,
                               "upconv.transposed": 2 * 3,
                               "conv.channel_pad": 2 * 6}  # init_nb 4: level 1 at 8
    start = prof.profiler.kineto_results.trace_start_ns()
    enclosed(spans, prof.events(), "model.forward", "aten::convolution", start)
    no_span_in_session(prof, spans)


def test_the_evaluators_direct_loop_records_the_request_steps_spans_and_bytes(run, tmp_path):
    """``PublicationEvaluator.predict_tiles`` runs its batches through the
    request step: the copy in, the z-score and the forward, each batch's
    bytes each way (padded in, float16 maps back)."""
    import cv2

    paths = []
    for i, tile in enumerate(tiles(3)):
        paths.append(str(tmp_path / f"s_r0_c{i}.png"))
        cv2.imwrite(paths[-1], tile)
    ev = PublicationEvaluator(run, EvalConfig(batch_size=4), device="cpu")
    with session():
        _, preds = ev.predict_tiles(paths)
    rec = tracing.records()
    assert tree(rec["spans"]) == [("entry.h2d", []), ("model.prep", []), ("model.forward", [])]
    check_records(rec["spans"])
    assert rec["counters"] == {"h2d_bytes": 4 * SIZE * SIZE * 4,  # float32, padded to 4
                               "d2h_bytes": 3 * SIZE * SIZE * 2,  # float16, the 3 real maps
                               "upconv.transposed": 3, "conv.channel_pad": 6}
    assert [p.dtype for p in preds] == [np.float32] * 3


def scaled(params, t):
    """A stand-in predict: a fresh float32 map of each tile."""
    return t.to(torch.float32) / 255


def test_held_segment_batch_results_keep_their_values():
    a = cli.segment_batch(scaled, {}, tiles(4, 1), 4, "cpu")
    kept = a.copy()
    b = cli.segment_batch(scaled, {}, tiles(4, 2), 4, "cpu")
    assert not np.shares_memory(a, b)
    np.testing.assert_array_equal(a, kept)
    assert not np.array_equal(a, b)


def test_the_cpu_path_pins_nothing_and_counts_no_pinned_bytes():
    t = torch.ones(2, 3)
    copy = HostCopy.start(t)
    assert copy.tensor is t and copy.ready is None
    with session():
        out = cli.segment_batch(scaled, {}, tiles(3), 4, "cpu")
    assert tracing.records()["counters"] == {"h2d_bytes": 4 * SIZE * SIZE,
                                             "d2h_bytes": out.nbytes}
    assert not torch.from_numpy(out).is_pinned()


@pytest.fixture
def card_segmenter(run, card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    predict, params, _, _ = cli._load_segmenter(run, device=card)
    return predict, params, card


@pytest.mark.card
@pytest.mark.parametrize("step", [cli.segment_batch, predict_batch],
                         ids=["segment_batch", "predict_batch"])
def test_segment_batch_from_the_card_is_the_old_copys_bytes_in_pinned_memory(card_segmenter,
                                                                             step):
    predict, params, card = card_segmenter
    batch = tiles(3)
    out = step(predict, params, batch, 4, card)
    padded = torch.from_numpy(np.concatenate([batch, batch[-1:]])).to(card)
    old = predict(params, padded)[:3].cpu().numpy()
    assert out.dtype == np.float32 and out.shape == (3, SIZE, SIZE)
    np.testing.assert_array_equal(out.view(np.uint32), old.view(np.uint32))
    assert torch.from_numpy(out).is_pinned()


@pytest.mark.card
def test_held_results_from_the_card_keep_their_values(card_segmenter):
    predict, params, card = card_segmenter
    outs, kept = [], []
    for seed in range(4):
        outs.append(cli.segment_batch(predict, params, tiles(4, seed), 4, card))
        kept.append(outs[-1].copy())
    del outs[0], kept[0]  # its block goes back to the cache for the next call
    outs.append(cli.segment_batch(predict, params, tiles(4, 9), 4, card))
    kept.append(outs[-1].copy())
    for i, (a, k) in enumerate(zip(outs, kept)):
        np.testing.assert_array_equal(a, k)
        for b in outs[i + 1:]:
            assert not np.shares_memory(a, b) and not np.array_equal(a, b)


@pytest.mark.card
def test_segment_batch_from_the_card_counts_its_pinned_bytes(card_segmenter):
    predict, params, card = card_segmenter
    with session():
        out = cli.segment_batch(predict, params, tiles(3), 4, card)
    counters = tracing.records()["counters"]
    assert counters["d2h_pinned_bytes"] == counters["d2h_bytes"] == out.nbytes


def test_the_fused_train_step_records_its_tree():
    model = DilatedUNet(init_nb=4, use_deep_supervision=True, compute_dtype=torch.float32,
                        fast_head=False).init_params(torch.Generator().manual_seed(1))
    cfg = TrainConfig(batch_size=2, use_hard_mining=True, ohem_ratio=0.7,
                      normalization_method="percentile")
    state = TrainState.create(dict(model.named_parameters()), cfg.optimizer, 1e-5,
                              cfg.weight_decay, None)
    step = _make_fused_train_step(model, unet_loss_from_config(cfg), cfg.normalization_method,
                                  cfg.percentile_low, cfg.percentile_high)
    augment = make_augment_step("moderate")
    gen = torch.Generator().manual_seed(2)
    zero, one = torch.tensor(0.0), torch.tensor(1.0)
    images, masks = tiles(2), (tiles(2, 1) > 127).astype(np.uint8)
    with session() as prof:
        for _ in range(2):
            x, m = augment(gen, copy_in_pinned(images, torch.device("cpu")),
                           copy_in_pinned(masks, torch.device("cpu")))
            step(state, x, m, gen, zero, one)
    rec = tracing.records()
    spans = rec["spans"]
    children = ["train.forward", "train.loss", "train.backward", "train.optimizer"]
    assert tree(spans) == [("entry.h2d", []), ("entry.h2d", []), ("train.augment", []),
                           ("train.step", children)] * 2
    check_records(spans)
    # level 1's six convs and the softmax head's 1x1 conv read 4 channels stored at 8
    assert rec["counters"] == {"h2d_bytes": 2 * (images.nbytes + masks.nbytes),
                               "conv.channel_pad": 2 * 7}
    start = prof.profiler.kineto_results.trace_start_ns()
    enclosed(spans, prof.events(), "train.forward", "aten::convolution", start)
    enclosed(spans, prof.events(), "train.backward", "aten::convolution_backward", start)
    no_span_in_session(prof, spans)


def upconv_ops(prof) -> list[str]:
    return [e.name for e in prof.events()
            if e.name in ("aten::conv_transpose2d", "aten::upsample_nearest2d")]


def test_a_unet_forward_runs_three_transposed_upconvs_and_counts_them():
    model = DilatedUNet(init_nb=4).init_params(torch.Generator().manual_seed(4)).eval()
    with session() as prof, torch.inference_mode():
        model(torch.from_numpy(tiles(2)).float())
    assert tracing.records()["counters"] == {"upconv.transposed": 3, "conv.channel_pad": 6}
    assert upconv_ops(prof) == ["aten::conv_transpose2d"] * 3


class TinyClassifier(torch.nn.Module):
    """(B, 299, 299, 3) -> (B,) probabilities through one linear layer."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(3, 1)

    def forward(self, x):
        return torch.sigmoid(self.head(x.mean((1, 2)))[:, 0])


def test_the_classifier_tta_predict_records_its_tree():
    model = TinyClassifier()
    state = {k: v.detach() for k, v in model.state_dict().items()}
    predict = make_classifier_tta_predict(_make_val_step(model, True, 1.0, 99.0), "full")
    images = torch.from_numpy(tiles(2))
    with session() as prof:
        probs = predict(state, images)
    assert probs.shape == (2,)
    spans = tracing.records()["spans"]
    assert tree(spans) == [("tta.predict", ["tta.views", "model.prep", "model.forward",
                                            "tta.collapse"])]
    check_records(spans)
    start = prof.profiler.kineto_results.trace_start_ns()
    enclosed(spans, prof.events(), "model.forward", "aten::linear", start)
    no_span_in_session(prof, spans)


def mean_gate(state, t):
    """A stand-in gate: each tile's mean brightness over 255."""
    return t.to(torch.float32).mean(dim=(1, 2)) / 255


def cascade_chunk(shape, seed):
    """A textured uint8 chunk whose tiles' brightness steps from tile to
    tile, with one near-white tile (QC: empty) and one flat one (blurry)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.integers(60, 140, (h, w)).astype(np.int32)
    img += (np.arange(h)[:, None] // SIZE + np.arange(w)[None, :] // SIZE) % 3 * 20
    img[:SIZE, :SIZE] = 250
    img[:SIZE, SIZE:2 * SIZE] = 120
    return img.astype(np.uint8)


def test_the_cascade_records_its_spans_and_counts():
    from adipose_tpu_torch.wsi.pipeline import DualModelWSIPipeline

    pipe = DualModelWSIPipeline(mean_gate, {}, scaled, {}, tile_size=SIZE, batch_size=4,
                                classifier_threshold=0.45, device="cpu")
    chunks = [cascade_chunk((3 * SIZE, 4 * SIZE), 0), cascade_chunk((2 * SIZE + 16, 3 * SIZE), 1)]
    with session():
        results = pipe.run_many(chunks)
    rec = tracing.records()
    spans = rec["spans"]
    check_records(spans)
    n_tiles = sum(r.n_tiles for r in results)
    n_good = sum(r.n_good for r in results)
    n_positive = sum(r.n_positive for r in results)
    rejected = sum(int((~r.is_good).sum()) for r in results)
    batches = sum(-(-r.n_positive // 4) for r in results)
    assert 0 < n_positive < n_good < n_tiles and rejected == n_tiles - n_good == 4
    stacked = sum(2 * 4 * -(-r.n_tiles // 4) * 4 for r in results)  # (2, padded n) float32
    stripes = sum(3 * SIZE * c.shape[1] * 2 for c in chunks)  # 3 float16 stripes a chunk
    c = rec["counters"]
    assert c == {"h2d_bytes": sum(x.nbytes for x in chunks), "d2h_bytes": stacked + stripes,
                 "cascade.tiles": n_tiles, "cascade.good_tiles": n_good,
                 "cascade.positive_tiles": n_positive, "cascade.segment_slots": 4 * batches,
                 "cascade.canvas_builds": 2}
    assert c["cascade.segment_slots"] >= c["cascade.positive_tiles"]
    names = [s["name"] for s in spans]
    for name in ("cascade.gate", "cascade.gate_wait", "cascade.segment", "cascade.finish",
                 "entry.h2d"):
        assert names.count(name) == 2, name
    # the canvases, the stripes with no positive tile above them, and each batch
    assert names.count("cascade.blend") == 2 * 2 + batches
    ids = {s["id"]: s["name"] for s in spans}
    assert {ids[s["parent"]] for s in spans if s["name"] == "cascade.blend"
            and s["parent"] is not None} == {"cascade.segment"}
    tracing.clear()
    again = pipe.run_many(chunks)
    assert tracing.records() == {"spans": [], "counters": {}, "dropped": 0}
    for a, b in zip(again, results):
        np.testing.assert_array_equal(a.probability_map, b.probability_map)


def test_export_is_the_same_graph_under_a_profiler(run, tmp_path):
    """No span sits inside a module's forward: the exported program is the
    same with a session recording, and exporting records no span."""
    def graph(out):
        path = export_model(run, "unet", out, batch_size=2, tile_size=SIZE,
                            platforms=("cpu",), device="cpu")
        return [(n.op, str(n.target)) for n in
                torch.export.load(path / "model.cpu.pt2").graph.nodes]

    plain = graph(tmp_path / "plain")
    with session():
        traced = graph(tmp_path / "traced")
    assert traced == plain
    assert tracing.records()["spans"] == []


def test_profile_dir_trace_holds_the_spans_around_their_ops(run, tmp_path):
    predict, params, _, _ = cli._load_segmenter(run, device="cpu")
    with tracing.span("outside"):  # off: not in the trace
        pass
    with cli._profiled(str(tmp_path), "segment_trace.json"):
        cli.segment_batch(predict, params, tiles(2), 2, "cpu")
    trace = json.loads((tmp_path / "segment_trace.json").read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("pid") == tracing.TRACK and e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["entry.h2d", "model.forward", "model.prep",
                                                "segment.batch"]
    convs = [e for e in events if e.get("name") == "aten::convolution" and e["ph"] == "X"]
    forward = next(e for e in spans if e["name"] == "model.forward")
    assert convs
    for c in convs:
        assert forward["ts"] - CLOCK_SLACK_US <= c["ts"]
        assert c["ts"] + c["dur"] <= forward["ts"] + forward["dur"] + CLOCK_SLACK_US
    outer = next(e for e in spans if e["name"] == "segment.batch")
    assert all(e["args"]["request"] == outer["args"]["id"] for e in spans)


@pytest.mark.parametrize("events", ["", '{"ph": "i", "name": "x", "ts": 1.0}'])
def test_the_exporter_copies_the_rest_of_the_trace_as_it_is(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text('{"schemaVersion": 1, "baseTimeNanoseconds": 1000000,\n'
                    f'"traceEvents": [ {events} ], "traceName": "t" }}')
    with session():
        with tracing.span("a"):
            pass
    assert tracing.add_to_chrome_trace(path) == 1
    trace = json.loads(path.read_text())
    assert trace["traceName"] == "t" and trace["baseTimeNanoseconds"] == 1000000
    names = [e["name"] for e in trace["traceEvents"]]
    assert names == ["process_name", "a"] + (["x"] if events else [])
    span = trace["traceEvents"][1]
    assert span["ts"] == (tracing.records()["spans"][0]["start_ns"] - 1000000) / 1e3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace.json"]


def test_the_exporter_leaves_a_file_it_cannot_read_whole(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text('{"traceEvents": []}')  # no baseTimeNanoseconds
    with pytest.raises(ValueError):
        tracing.add_to_chrome_trace(path)
    assert path.read_text() == '{"traceEvents": []}'


@pytest.mark.card
def test_the_transposed_upconv_on_the_card_is_the_two_op_form(card):
    """Level 1 of a b16 request, bf16 channels-last, (16, 88, 512^2) ->
    (16, 44, 1024^2): the transposed 4x4 conv against a nearest-x2 upsample
    and a 3x3 conv, both against the float32 function (TF32 off)."""
    gen = torch.Generator(device=card).manual_seed(5)
    conv = FusedUpsampleConv(88, 44, device=card)
    with torch.no_grad():
        conv.weight.normal_(0.0, (88 * 9) ** -0.5, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(16, 88, 512, 512, device=card, generator=gen)
    x16 = x.to(torch.bfloat16, memory_format=torch.channels_last)
    with torch.inference_mode():
        folded = conv(x16).float()
        two_op = F.conv2d(F.interpolate(x16, scale_factor=2, mode="nearest"),
                          conv.weight.to(torch.bfloat16, memory_format=torch.channels_last),
                          conv.bias.to(torch.bfloat16), padding=1).float()
        del x16
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), conv.weight,
                            conv.bias, padding=1)
        finally:
            torch.backends.cudnn.allow_tf32 = saved

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    assert folded.shape == want.shape == (16, 44, 1024, 1024)
    assert folded.is_contiguous(memory_format=torch.channels_last)
    assert rel(folded, two_op) <= BF16_EPS
    assert rel(folded, want) <= BF16_EPS and rel(two_op, want) <= BF16_EPS
    assert (folded - two_op).abs().max().item() <= 4 * BF16_EPS * want.abs().max().item()


@pytest.mark.card
def test_a_full_width_unet_forward_on_the_card_launches_no_upsample(card):
    model = DilatedUNet(init_nb=44, device=card).init_params(
        torch.Generator(device=card).manual_seed(6)).eval()
    images = torch.rand(2, 1024, 1024, device=card)
    with torch.inference_mode():
        model(images)  # cuDNN's plans, outside the session
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(images)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("dgrad" in k or "fprop" in k or "conv" in k.lower() for k in kernels), kernels
    assert not [k for k in kernels if "upsample" in k]
    # level 1 stored at 48 channels: cuDNN pads no map to a multiple of 8
    assert not [k for k in kernels if "AddPadding" in k]
    assert tracing.records()["counters"] == {"upconv.transposed": 3, "conv.channel_pad": 6}
    assert upconv_ops(prof) == ["aten::conv_transpose2d"] * 3
