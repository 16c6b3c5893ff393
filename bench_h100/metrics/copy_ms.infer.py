"""copy_ms.infer: device time of host-device copies a request, from the
profiler's memcpy activities."""

from bench_h100.readers import device_trace


def read(ctx):
    trace = device_trace(ctx)
    return None if trace is None else 1e3 * trace.copy_s() / ctx.requests
