"""The reader of the program's spans (``bench_h100/spans.py``) and the
metric files that use it, on synthetic records and in traced runs on the
CPU at small sizes."""

import sys
from types import SimpleNamespace

import pytest
import torch

import adipose_tpu_torch.core
from adipose_tpu_torch.core import tracing
from bench_h100 import run, spans
from bench_h100.tests.test_bench_run import small

INFER = ("stage_ms.infer", "copy_mb.infer", "launch_ms.infer", "forward_ms.infer",
         "prep_ms.infer", "host_self_ms.infer")
TRAIN = ("forward_ms.train", "backward_ms.train", "loss_ms.train", "optimizer_ms.train")


def span(id, name, parent, host, device, request=None, host_self=None):
    return {"id": id, "name": name, "parent": parent, "request": request or id,
            "host_ms": host, "host_self_ms": host if host_self is None else host_self,
            "device_ms": device}


# Two requests: a segment request (prep and forward under the call) and a
# TTA request whose views, prep, forward and collapse lie under its predict.
RECORDS = {
    "spans": [
        span(2, "entry.h2d", 1, 0.5, 0.1, 1),
        span(3, "model.prep", 1, 0.25, 0.125, 1),
        span(4, "model.forward", 1, 3.0, 8.0, 1),
        span(1, "segment.batch", None, 10.0, 9.0, host_self=6.25),
        span(6, "tta.views", 5, 0.5, 1.0, 5),
        span(7, "model.prep", 5, 0.25, 2.0, 5),
        span(8, "model.forward", 5, 4.0, 16.0, 5),
        span(9, "tta.collapse", 5, 0.25, 0.5, 5),
        span(5, "tta.predict", None, 6.0, 20.0, host_self=1.0),
    ],
    "counters": {"h2d_bytes": 3_000_000, "d2h_bytes": 1_000_000},
    "dropped": 0,
}
TRAIN_RECORDS = {
    "spans": [s for i in range(2) for s in (
        span(10 * i + 2, "train.forward", 10 * i + 1, 1.0, 60.0, 10 * i + 1),
        span(10 * i + 3, "train.loss", 10 * i + 1, 1.0, 10.0, 10 * i + 1),
        span(10 * i + 4, "train.backward", 10 * i + 1, 1.0, 140.0, 10 * i + 1),
        span(10 * i + 5, "train.optimizer", 10 * i + 1, 1.0, 12.0, 10 * i + 1),
        span(10 * i + 1, "train.step", None, 5.0, 230.0))],
    "counters": {},
    "dropped": 0,
}


def read(name, ctx):
    return run.load_file("metrics", name).read(ctx)


@pytest.fixture
def records(monkeypatch):
    def use(value):
        monkeypatch.setattr(tracing, "records", lambda since=0: value)

    return use


def test_the_inference_metrics_from_records(records):
    records(RECORDS)
    ctx = SimpleNamespace(requests=2)
    assert read("stage_ms.infer", ctx) == pytest.approx(0.25)
    assert read("copy_mb.infer", ctx) == pytest.approx(2.0)
    # prep, forward, views and collapse, each once: 0.25 + 3 + 0.5 + 0.25 + 4 + 0.25
    assert read("launch_ms.infer", ctx) == pytest.approx(8.25 / 2)
    assert read("forward_ms.infer", ctx) == pytest.approx(12.0)
    assert read("prep_ms.infer", ctx) == pytest.approx((0.125 + 1.0 + 2.0) / 2)
    # the calls' own host time: 10 - 3.75 and 6 - 5
    assert read("host_self_ms.infer", ctx) == pytest.approx((6.25 + 1.0) / 2)


def test_the_training_metrics_from_records(records):
    records(TRAIN_RECORDS)
    ctx = SimpleNamespace(steps=2)
    assert [read(n, ctx) for n in TRAIN] == pytest.approx([60.0, 140.0, 10.0, 12.0])
    assert read("forward_ms.infer", SimpleNamespace(requests=2)) is None
    assert read("host_self_ms.infer", SimpleNamespace(requests=2)) is None


def test_a_span_inside_another_of_the_set_counts_once():
    s = spans.Spans({"spans": [span(1, "tta.views", None, 2.0, 4.0),
                               span(2, "x", 1, 1.0, 1.0, 1),
                               span(3, "model.prep", 2, 1.0, 3.0, 1)], "counters": {}})
    assert s.host_ms("tta.views", "model.prep") == 2.0
    assert s.device_ms("model.prep") == 3.0
    assert s.counter("h2d_bytes") is None


def test_nothing_to_read_is_none(records, monkeypatch):
    ctx = SimpleNamespace(requests=3)
    records({"spans": [], "counters": {}, "dropped": 0})
    assert all(read(n, ctx) is None for n in INFER + TRAIN)
    no_events = {"spans": [dict(s, device_ms=None) for s in RECORDS["spans"]],
                 "counters": {}, "dropped": 0}
    records(no_events)  # the CPU: no CUDA events, and no copy counted
    for n in ("forward_ms.infer", "prep_ms.infer", "copy_mb.infer"):
        assert read(n, ctx) is None
    assert read("stage_ms.infer", ctx) == pytest.approx(0.5 / 3)
    assert read("host_self_ms.infer", ctx) == pytest.approx((6.25 + 1.0) / 3)
    assert read("forward_ms.infer", SimpleNamespace(requests=0)) is None
    # a program without the module
    monkeypatch.setitem(sys.modules, "adipose_tpu_torch.core.tracing", None)
    monkeypatch.delattr(adipose_tpu_torch.core, "tracing")
    assert spans.load() is None
    assert all(read(n, ctx) is None for n in INFER + TRAIN)


CELLS = {  # cell -> bytes a request from its small shapes (h2d, d2h)
    "unet44-segment-b16": 4 * 64 * 64 * (1 + 4),
    "unet44-segment-b1": 64 * 64 * (1 + 4),
    "inception-tta-full-b64": 4 * 96 * 96,  # the copy back is the benchmark's
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_inference_run_reads_the_host_metrics(cell):
    """On the CPU the spans hold no CUDA events: the device metrics read
    nothing and are left out, the host ones read the window."""
    tracing.clear()
    result, _ = run.run_cell(small(cell), 2**31 + 23, 0.3, True, torch.device("cpu"))
    tracing.clear()
    got = result["metrics"]
    assert {"stage_ms.infer", "copy_mb.infer", "launch_ms.infer",
            "host_self_ms.infer"} <= set(got)
    assert not {"forward_ms.infer", "prep_ms.infer"} & set(got)
    assert got["copy_mb.infer"]["value"] == pytest.approx(CELLS[cell] / 1e6)
    assert got["copy_mb.infer"]["unit"] == "MB"
    assert 0 < got["launch_ms.infer"]["value"]
    assert 0 < got["host_self_ms.infer"]["value"]


def test_a_traced_training_run_reads_no_device_time_on_the_cpu():
    tracing.clear()
    result, _ = run.run_cell(small("unet44-train-b8"), 2**31 + 29, 0.3, True,
                             torch.device("cpu"))
    assert tracing.records()["spans"]
    tracing.clear()
    assert not set(TRAIN) & set(result["metrics"])
