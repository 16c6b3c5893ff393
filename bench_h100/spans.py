"""What the metric files read of the program's own spans and counters:
``adipose_tpu_torch.core.tracing.records()`` after a traced window.

Tracing is on only while a profiler session records, and a run opens one
session, around the window, so the records are the window's. A program
without that module, or a window that recorded nothing, gives None; so
does a device time where the spans hold no CUDA events. A span's device
time is the stream time between its two events: the device's work where
the device keeps ahead of the host, its waits for the host's launches
too where it does not.
"""

from __future__ import annotations


class Spans:
    """Sums of one run's span records and counters."""

    def __init__(self, records: dict):
        self.spans = records["spans"]
        self.counters = records["counters"]
        self.ids = {s["id"]: s for s in self.spans}

    def _outermost(self, names) -> list[dict]:
        """The spans named in ``names`` that no span of ``names`` encloses,
        so that each stretch of time is counted once."""
        names = set(names)
        out = []
        for s in self.spans:
            if s["name"] not in names:
                continue
            parent = self.ids.get(s["parent"])
            while parent is not None and parent["name"] not in names:
                parent = self.ids.get(parent["parent"])
            if parent is None:
                out.append(s)
        return out

    def host_ms(self, *names: str) -> float | None:
        spans = self._outermost(names)
        return sum(s["host_ms"] for s in spans) if spans else None

    def host_self_ms(self, *names: str) -> float | None:
        """Host ms of the spans named in ``names`` outside their child
        spans."""
        spans = [s for s in self.spans if s["name"] in names]
        return sum(s["host_self_ms"] for s in spans) if spans else None

    def device_ms(self, *names: str) -> float | None:
        spans = self._outermost(names)
        if not spans or any(s["device_ms"] is None for s in spans):
            return None
        return sum(s["device_ms"] for s in spans)

    def counter(self, *names: str) -> int | None:
        found = [self.counters[n] for n in names if n in self.counters]
        return sum(found) if found else None


def load() -> Spans | None:
    """The program's records of this process, or None where the program has
    no tracing module or it recorded nothing."""
    try:
        from adipose_tpu_torch.core import tracing
    except ImportError:
        return None
    records = tracing.records()
    if not records["spans"] and not records["counters"]:
        return None
    return Spans(records)


def per_unit(ctx, total: float | None) -> float | None:
    """``total`` over the window's requests, or its steps."""
    units = getattr(ctx, "requests", None) or getattr(ctx, "steps", None)
    return None if total is None or not units else total / units
