"""Program spans and counters, kept in memory while a profiler records.

A span names a stretch of the host's work in the request and step paths
(``with span("model.forward"): ...``); a counter adds up a quantity such
as bytes copied (``count("h2d_bytes", n)``). Both are on exactly while a
``torch.profiler`` session records (``torch.autograd.profiler.
_is_profiler_enabled``): the CLI's ``--profile-dir`` and any other
profiler session turn them on, and nothing else does. Off, a span costs
one flag read and returns one shared no-op object; a counter costs the
same read.

A span that is on appends one record: its name, its id, its parent's id
(the span open around it in the same thread), the id of the outermost
span around it (the request it belongs to) and its host start and end in
``time.time_ns()``. ``time.time_ns()`` is the clock the profiler stamps
its events with, so a span less the session's ``kineto_results.
trace_start_ns()`` lies on the session's timeline, around the operators
issued inside it. A span opened with ``device=True`` on an initialized
CUDA device also records two timing events on the current stream at its
edges: the stream time between them is read by :func:`records`, after the
work, so the hot path never waits for the device. Where the device keeps
ahead of the host that time is the device's work; where it waits for the
host's launches, the waits are in it too.

Spans are never profiler ranges (``record_function``): those are copied
onto the device's timeline, where they would read as device work.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 18  # spans kept; later ones are dropped and counted
TRACK = "program spans"  # the process track of the spans in a chrome trace
_CUDA = torch.device("cuda")  # the current CUDA device


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _State:
    """What the spans and counters of the process have recorded."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list[_Span] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()  # .stack: the open spans of a thread

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_STATE = _State()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "thread", "start_ns", "end_ns", "events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.id = next(_STATE.ids)
        self.thread = threading.get_ident()
        self.events = None
        if device and torch.cuda.is_initialized():
            # torch.Event finds the current stream in C++; torch.cuda.Event
            # builds a Python Stream a record, twice the cost on the card
            self.events = (torch.Event(_CUDA, enable_timing=True),
                           torch.Event(_CUDA, enable_timing=True))

    def __enter__(self):
        stack = _STATE.stack()
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _STATE.stack().pop()
        with _STATE.lock:
            if len(_STATE.spans) < MAX_RECORDS:
                _STATE.spans.append(self)
            else:
                _STATE.dropped += 1
        return False


def span(name: str, device: bool = False):
    """A context manager that records the block as the span ``name`` while
    tracing is on; with ``device``, also the stream time across it."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _profiler._is_profiler_enabled:
        return
    with _STATE.lock:
        _STATE.counters[name] = _STATE.counters.get(name, 0) + int(n)


def mark() -> int:
    """The number of spans recorded so far: ``records(since=mark())``
    after a block gives the block's spans."""
    with _STATE.lock:
        return len(_STATE.spans)


def records(since: int = 0) -> dict:
    """The recorded spans from index ``since`` (in the order they ended),
    the counters and the count of dropped spans::

        {"spans": [{"name", "id", "parent", "request", "thread",
                    "start_ns", "end_ns", "host_ms", "host_self_ms",
                    "device_ms", "device_self_ms"}, ...],
         "counters": {name: total}, "dropped": n}

    A self time is the duration less the part its child spans cover.
    ``device_ms`` is the time between the span's two CUDA events on its
    stream (None for a span without them); reading it waits for the
    second."""
    with _STATE.lock:
        spans = list(_STATE.spans[since:])
        counters = dict(_STATE.counters)
        dropped = _STATE.dropped
    out = []
    for s in spans:
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
                    "thread": s.thread, "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": device_ms})
    host_in_children: dict[int, float] = {}
    device_in_children: dict[int, float] = {}
    for r in out:
        if r["parent"] is not None:
            host_in_children[r["parent"]] = host_in_children.get(r["parent"], 0.0) + r["host_ms"]
            if r["device_ms"] is not None:
                device_in_children[r["parent"]] = (device_in_children.get(r["parent"], 0.0)
                                                   + r["device_ms"])
    for r in out:
        r["host_self_ms"] = max(0.0, r["host_ms"] - host_in_children.get(r["id"], 0.0))
        r["device_self_ms"] = (None if r["device_ms"] is None else
                               max(0.0, r["device_ms"] - device_in_children.get(r["id"], 0.0)))
    return {"spans": out, "counters": counters, "dropped": dropped}


def clear() -> None:
    """Forget every span, counter and dropped count."""
    with _STATE.lock:
        _STATE.spans = []
        _STATE.counters = {}
        _STATE.dropped = 0


def add_to_chrome_trace(path: str | Path, since: int = 0) -> int:
    """Add the spans recorded from index ``since`` to the chrome trace that
    ``torch.profiler``'s ``export_chrome_trace`` wrote at ``path``: on a
    track of their own (:data:`TRACK`, a row per thread), on the trace's
    timeline (its ``ts`` are microseconds after ``baseTimeNanoseconds``).
    The spans go first in ``traceEvents``; the rest of the file is copied
    as it is, into a new file that then replaces the old one, so a trace
    of any size is never parsed and a failed write leaves it whole.
    Returns the number of spans added."""
    path = Path(path)
    spans = records(since)["spans"]
    with path.open("rb") as src:
        head = src.read(1 << 20)
        marker = re.search(rb'"traceEvents"\s*:\s*\[', head)
        base = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
        if marker is None or base is None:
            raise ValueError(f"{path}: no traceEvents or baseTimeNanoseconds in its head")
        base = int(base.group(1))
        events = [{"ph": "M", "name": "process_name", "pid": TRACK, "tid": 0,
                   "args": {"name": TRACK}}]
        for s in spans:
            events.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": TRACK,
                           "tid": s["thread"], "ts": (s["start_ns"] - base) / 1e3,
                           "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                           "args": {k: s[k] for k in ("id", "parent", "request", "host_self_ms",
                                                      "device_ms", "device_self_ms")}})
        rest = head[marker.end():]
        tmp = path.with_name(path.name + ".tmp")
        with tmp.open("wb") as dst:
            dst.write(head[:marker.end()])
            dst.write(",\n".join(json.dumps(e) for e in events).encode())
            if not rest.lstrip().startswith(b"]"):
                dst.write(b",")
            dst.write(rest)
            shutil.copyfileobj(src, dst)
    os.replace(tmp, path)
    return len(spans)
