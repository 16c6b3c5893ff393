"""Reading a ``torch.profiler`` session of the measured window: device busy
time, time by device function, copies, and the idle gaps labelled by the
benchmark's own host spans.

The window is the benchmark's ``bench.window`` span; device activities
(kernels, copies, sets) are clipped to it. Spans the benchmark opens
around its calls are ``bench.<label>``; an idle gap takes the label of the
innermost span open when it starts, and inside a request the direction of
the copy the device waits for, when the next activity is a copy.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

SPAN_PREFIX = "bench."
LABELS = {"window": "between requests", "request": "call into entry", "step": "call into entry",
          "h2d": "h2d copy", "d2h": "d2h copy"}


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Trace:
    """One traced window. Times are in seconds."""

    def __init__(self, events):
        """``events``: ``torch.profiler.profile.events()`` of the session.
        Device events are kernels, copies and sets; the benchmark's spans on
        the device's timeline are not activities and are left out."""
        spans, device = [], []
        for e in events:
            start, end = e.time_range.start * 1e3, e.time_range.end * 1e3  # us -> ns
            on_device = str(e.device_type).endswith("CUDA")
            if on_device and not e.name.startswith(SPAN_PREFIX):
                kind = "gpu_memcpy" if e.name.startswith("Memcpy") else (
                    "gpu_memset" if e.name.startswith("Memset") else "kernel")
                device.append((e.name, kind, start, end))
            elif not on_device and e.name.startswith(SPAN_PREFIX):
                spans.append((e.name[len(SPAN_PREFIX):], start, end))
        windows = [s for s in spans if s[0] == "window"]
        if not windows:
            raise ValueError("the trace holds no bench.window span")
        _, self.t0, self.t1 = windows[0]
        self.spans = sorted((s for s in spans if s[0] != "window" and s[2] > self.t0
                             and s[1] < self.t1), key=lambda s: s[1])
        self.span_starts = [s[1] for s in self.spans]
        self.device = sorted(((n, k, max(s, self.t0), min(e, self.t1)) for n, k, s, e in device
                              if e > self.t0 and s < self.t1), key=lambda d: d[2])
        self.busy = _union((s, e) for _, _, s, e in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def time_by_name(self) -> dict[str, tuple[float, int]]:
        """Device function or copy name -> (seconds, launches)."""
        out: dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, _, s, e in self.device:
            out[name][0] += (e - s) / 1e9
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def matching(self, functions) -> tuple[float, dict[str, int]]:
        """(seconds, launches by function) of the device functions named in
        ``functions``: ``__global__`` functions of the top-level anonymous
        namespace of a CUDA source, as the profiler demangles them (a
        template with its return type, a plain function without)."""
        pattern = re.compile(r"^(?:void )?\(anonymous namespace\)::(%s)[<(]"
                             % "|".join(map(re.escape, functions)))
        seconds, counts = 0.0, {f: 0 for f in functions}
        for name, (t, n) in self.time_by_name().items():
            hit = pattern.match(name)
            if hit:
                seconds += t
                counts[hit.group(1)] += n
        return seconds, counts

    def copy_s(self) -> float:
        """Device time of host-device copies (either direction)."""
        return sum((e - s) / 1e9 for n, k, s, e in self.device
                   if k == "gpu_memcpy" and ("HtoD" in n or "DtoH" in n))

    def _label(self, t: float, next_device) -> str:
        """What the host was doing at ``t``: the innermost benchmark span open
        then, or between requests; inside a span, the direction of the copy
        the device waits for when its next activity is a copy in that span."""
        last = bisect.bisect_right(self.span_starts, t)  # spans starting by t
        inner = [s for s in self.spans[max(0, last - 8):last] if t < s[2]]
        if not inner:
            return LABELS["window"]
        name, _, end = min(inner, key=lambda s: s[2] - s[1])
        if next_device is not None and next_device[1] == "gpu_memcpy" and next_device[2] < end:
            if "HtoD" in next_device[0]:
                return LABELS["h2d"]
            if "DtoH" in next_device[0]:
                return LABELS["d2h"]
        return LABELS.get(name, name)

    def idle_gaps(self) -> dict[str, float]:
        """Idle seconds of the window by label, most first. Each idle
        interval is cut where a benchmark span opens or closes, and each
        piece labelled by :meth:`_label` at its start."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        starts = [d[2] for d in self.device]
        cuts = sorted({x for _, a, b in self.spans for x in (a, b)})
        out: dict[str, float] = defaultdict(float)
        for i in range(0, len(edges), 2):
            start, end = edges[i], edges[i + 1]
            if end <= start:
                continue
            nxt = bisect.bisect_left(starts, end)
            following = self.device[nxt] if nxt < len(self.device) else None
            inside = cuts[bisect.bisect_right(cuts, start):bisect.bisect_left(cuts, end)]
            points = [start, *inside, end]
            for a, b in zip(points, points[1:]):
                out[self._label(a, following)] += (b - a) / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[name[:160], t] for name, (t, _) in ops],
                "idle_gaps": [[label, t] for label, t in list(self.idle_gaps().items())[:top]]}
