"""What the metric files under ``metrics/`` read from a run: each is one
``read(ctx)`` that returns a number, or None where its run holds nothing
to read. ``ctx`` holds the window's record (``window_s``, ``latencies_s``,
``tiles``, ``requests`` or ``steps``), ``setup_s``, the ``entry`` and, in a
traced run, ``trace`` (a :class:`bench_h100.trace.Trace`) and the wrappers'
``launches``.
"""

from __future__ import annotations

import numpy as np

from bench_h100.work import BF16_FLOP_PER_S
from bench_h100.work.kernels import FUNCTIONS

# Device functions of the convolutions: cuDNN's and CUTLASS's implicit-GEMM
# kernels for the forward (fprop) and the two backward convs (dgrad, wgrad).
CONV_PATTERNS = ("fprop", "dgrad", "wgrad", "implicit_gemm", "conv2d", "convolve")
NOT_CONV = ("Padding", "nchwToNhwc", "nhwcToNchw")


def is_conv(name: str) -> bool:
    return any(p in name for p in CONV_PATTERNS) and not any(p in name for p in NOT_CONV)


def device_trace(ctx):
    """The run's trace where it recorded device activity; None otherwise
    (an untraced run, or one on a machine without a card)."""
    trace = ctx.trace
    return trace if trace is not None and trace.busy_s > 0 else None


def p95_ms(ctx) -> float:
    return float(np.percentile(np.asarray(ctx.latencies_s), 95) * 1e3)


def mfu(ctx, flops: float) -> float | None:
    """Percent of the bf16 peak that ``flops`` over the traced window are."""
    trace = device_trace(ctx)
    return None if trace is None else 100.0 * flops / trace.window_s / BF16_FLOP_PER_S


def conv_share(ctx) -> float | None:
    trace = device_trace(ctx)
    if trace is None:
        return None
    conv = sum(t for name, (t, _) in trace.time_by_name().items() if is_conv(name))
    return 100.0 * conv / trace.busy_s if conv > 0 else None


def kernel_roofline(ctx) -> float | None:
    """The least time of the port's kernels' recorded launches over their
    device time, in percent: each kernel's bound from its shapes times the
    launches the profiler recorded (the fewest of its functions'), summed
    over the kernels the entry launches."""
    trace = device_trace(ctx)
    if trace is None:
        return None
    bound, spent = 0.0, 0.0
    for kernel, work in ctx.entry.kernel_work.items():
        seconds, counts = trace.matching(FUNCTIONS[kernel])
        recorded = min(counts.values())
        if recorded == 0 or seconds <= 0:
            continue
        bound += work["bound_s"] * recorded
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None


def idle_pct(ctx) -> float | None:
    trace = device_trace(ctx)
    return None if trace is None else 100.0 * (1.0 - trace.busy_s / trace.window_s)
