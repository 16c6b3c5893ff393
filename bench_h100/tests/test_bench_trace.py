"""Reading a profiler session: busy time, device functions, idle gaps."""

from types import SimpleNamespace

import pytest

from bench_h100.trace import Trace


def event(name, start_us, end_us, device):
    return SimpleNamespace(name=name, device_type="DeviceType.CUDA" if device else
                           "DeviceType.CPU", time_range=SimpleNamespace(start=start_us,
                                                                       end=end_us))


EVENTS = [
    event("bench.window", 0, 100, False),
    event("bench.request", 0, 45, False), event("bench.request", 50, 100, False),
    event("bench.request", 0, 45, True),  # the span on the device's timeline: not work
    event("Memcpy HtoD (Pageable -> Device)", 5, 10, True),
    event("void (anonymous namespace)::hist_kernel<float>(float const*)", 10, 20, True),
    event("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<x>()", 15, 25,
          True),
    event("void (anonymous namespace)::apply_kernel<float>(float const*)", 30, 40, True),
    event("(anonymous namespace)::percentile_kernel(int const*, float*)", 40, 40, True),
    event("Memcpy DtoH (Device -> Pageable)", 60, 90, True),
    event("void (anonymous namespace)::zscore_kernel<unsigned char>()", 120, 130, True),
]


def test_busy_window_and_functions():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(60e-6)  # 5-25, 30-40, 60-90; the last is outside
    seconds, counts = t.matching(("hist_kernel", "percentile_kernel", "apply_kernel"))
    assert counts == {"hist_kernel": 1, "percentile_kernel": 1, "apply_kernel": 1}
    assert seconds == pytest.approx(20e-6)
    assert t.copy_s() == pytest.approx(35e-6)


def test_idle_gaps_by_what_the_host_was_doing():
    gaps = Trace(EVENTS).idle_gaps()
    assert gaps == pytest.approx({
        "h2d copy": 5e-6,  # 0-5: the host stages the first copy
        "call into entry": 20e-6,  # 25-30, 40-45 (after the request's work), 90-100
        "between requests": 5e-6,  # 45-50
        "d2h copy": 10e-6,  # 50-60: the second request waits for its copy back
    })
