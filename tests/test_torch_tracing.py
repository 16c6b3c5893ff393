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
from torch.profiler import ProfilerActivity, profile

from adipose_tpu_torch.cli import main as cli
from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.core.config import TrainConfig
from adipose_tpu_torch.core.host_copy import HostCopy
from adipose_tpu_torch.eval.tta import make_classifier_tta_predict
from adipose_tpu_torch.models.convert import torch_unet_to_flax
from adipose_tpu_torch.models.unet import DilatedUNet
from adipose_tpu_torch.serving.export import export_model
from adipose_tpu_torch.train import checkpoint as ckpt
from adipose_tpu_torch.train.state import TrainState, unet_loss_from_config
from adipose_tpu_torch.train.trainer_classifier import _make_val_step
from adipose_tpu_torch.train.trainer_unet import (_make_fused_train_step, _to_device,
                                                   make_augment_step)

SIZE = 64
CLOCK_SLACK_US = 100.0  # a span against the profiler's events of its work


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
                               "d2h_bytes": out.nbytes + 4 * SIZE * SIZE * 4}
    start = prof.profiler.kineto_results.trace_start_ns()
    enclosed(spans, prof.events(), "model.forward", "aten::convolution", start)
    no_span_in_session(prof, spans)


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
def test_segment_batch_from_the_card_is_the_old_copys_bytes_in_pinned_memory(card_segmenter):
    predict, params, card = card_segmenter
    batch = tiles(3)
    out = cli.segment_batch(predict, params, batch, 4, card)
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
            x, m = augment(gen, _to_device(images, torch.device("cpu")),
                           _to_device(masks, torch.device("cpu")))
            step(state, x, m, gen, zero, one)
    rec = tracing.records()
    spans = rec["spans"]
    children = ["train.forward", "train.loss", "train.backward", "train.optimizer"]
    assert tree(spans) == [("entry.h2d", []), ("entry.h2d", []), ("train.augment", []),
                           ("train.step", children)] * 2
    check_records(spans)
    assert rec["counters"] == {"h2d_bytes": 2 * (images.nbytes + masks.nbytes)}
    start = prof.profiler.kineto_results.trace_start_ns()
    enclosed(spans, prof.events(), "train.forward", "aten::convolution", start)
    enclosed(spans, prof.events(), "train.backward", "aten::convolution_backward", start)
    no_span_in_session(prof, spans)


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
