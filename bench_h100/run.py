#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, seeded weights and traffic made on the card, the entry
built and warmed on the cell's own shapes) is ``setup_s``. Then a window of
``--seconds`` drives the port's entry: a closed loop of requests with one
client, or training steps. ``--trace 1`` traces at most the first
``TRACE_SECONDS`` of the window with ``torch.profiler`` and reports the
cell's per-layer metrics; ``--trace 0`` reports its end-to-end metrics.
After the window the peak memory is read, the program's state freed, and
a seeded sample of what the window produced is compared with the plain
reference; ``correct`` says whether every number compared is within its
limit (``limits/<cell>.json``). The last line of standard output is the
result, as JSON; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of the result.

Exits 2 without a result when the card is missing, and 3 when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the port and this package

import torch  # noqa: E402

from bench_h100 import common  # noqa: E402
from bench_h100.work.kernels import FUNCTIONS, WRAPPERS  # noqa: E402

TRACE_SECONDS = 10.0


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this benchmark (names may hold dots)."""
    path = common.BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(f"bench_h100.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def span(name: str):
    return torch.profiler.record_function(f"bench.{name}")


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def wrapper_launches(entry) -> dict[str, int]:
    """Calls of each of the entry's kernels so far, by the port's counters."""
    out = {}
    for kernel in entry.kernel_work:
        module, fn = WRAPPERS[kernel]
        out[kernel] = getattr(importlib.import_module(module), fn).launches
    return out


def request_window(entry, seconds: float, sampler: Reservoir, log: dict) -> dict:
    """The closed loop of one client: each request is sent when the one
    before has its result on the host. The window closes with the first
    request that ends after ``seconds``; it holds all the requests sent."""
    latencies, units, failed = [], 0, 0
    i = 0
    t0 = time.perf_counter()
    with span("window"):
        while True:
            ts = time.perf_counter()
            try:
                with span("request"):
                    out = entry.request(i)
            except Exception:  # noqa: BLE001 - a failed request is counted, then the run ends
                failed += 1
                log["error"] = traceback.format_exc()
                out = None
            te = time.perf_counter()
            latencies.append(te - ts)
            if out is not None:
                units += entry.per_request
                sampler.offer((i, out))
            i += 1
            if te - t0 >= seconds or out is None:
                break
    return {"window_s": te - t0, "latencies_s": latencies, "tiles": units, "requests": i,
            "attempted": i, "failed": failed}


def step_window(entry, seconds: float, log: dict) -> dict:
    """Training steps enqueued until ``seconds`` have passed on the host
    clock, then a synchronize: the window is all the steps' work."""
    steps, failed = 0, 0
    t0 = time.perf_counter()
    with span("window"):
        try:
            while time.perf_counter() - t0 < seconds:
                with span("step"):
                    entry.step()
                steps += 1
            entry.synchronize()
        except Exception:  # noqa: BLE001
            failed += 1
            log["error"] = traceback.format_exc()
    t1 = time.perf_counter()
    failed += entry.failed_steps()
    return {"window_s": t1 - t0, "steps": steps, "tiles": steps * entry.per_request,
            "attempted": steps + (1 if log.get("error") else 0), "failed": failed}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             entry_hook=None) -> tuple[dict, list[str]]:
    """Set up, measure and check one cell; returns (result, lines for
    standard error). ``entry_hook(entry)``, for tests, may break the entry
    before it is warmed up."""
    log: dict = {}
    traffic = spec["traffic"]
    t_imported = time.perf_counter()
    entry = load_file("entries", traffic["entry"]).build(spec, seed, device)
    if entry_hook is not None:
        entry_hook(entry)
    t_built = time.perf_counter()
    entry.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    sampler = Reservoir(traffic.get("sample_requests", 0),
                        random.Random(common.sub_seed(seed, "sample")))
    window = min(seconds, TRACE_SECONDS) if trace else seconds
    before = wrapper_launches(entry)
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
    with prof as session:
        if entry.kind == "requests":
            rec = request_window(entry, window, sampler, log)
        else:
            rec = step_window(entry, window, log)
    launches = {k: v - before[k] for k, v in wrapper_launches(entry).items()}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    card = smi() if device.type == "cuda" else "cpu"

    ctx = SimpleNamespace(setup_s=setup_s, entry=entry, launches=launches, trace=None, **rec)
    lines = [f"card: {card}; cell {spec['cell']['name']} seed {seed}; window "
             f"{rec['window_s']:.3f} s, {rec.get('requests', rec.get('steps'))} "
             f"{entry.kind}; set-up {setup_s:.3f} s (imports {t_imported - T_START:.3f}, build "
             f"{t_built - t_imported:.3f}, warm-up {setup_s - (t_built - T_START):.3f}); peak "
             f"{peak} bytes; wrapper launches {launches}"]
    if trace:
        from bench_h100.trace import Trace

        ctx.trace = Trace(session.events())
        for kernel, fns in FUNCTIONS.items():
            if kernel in entry.kernel_work:
                lines.append(f"kernel {kernel}: profiler launches "
                             f"{ctx.trace.matching(fns)[1]}, wrapper launches "
                             f"{launches[kernel]}")
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = load_file("metrics", m["name"]).read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if log.get("error"):
        lines.append("window error:\n" + log["error"])
    numbers = {}
    if not log.get("error"):
        numbers = entry.check(sampler.items)
    limits = common.load_json(common.BENCH_DIR / "limits" / f"{spec['cell']['name']}.json")
    checks = {name: {"value": numbers.get(name, math.nan), "limit": lim["limit"]}
              for name, lim in limits.items()}
    correct = (rec["failed"] == 0 and not log.get("error")
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, lines


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    spec = common.cell_spec(args.workload)
    try:
        device = common.require_cards(spec["cell"]["chips"])
    except common.NoCard as e:
        print(f"bench_h100: {e}; no result", file=sys.stderr)
        return 2
    result, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    found = common.forbidden_loaded()
    if found:
        print(f"bench_h100: modules loaded that the benchmark may not load: {found}; "
              "no result", file=sys.stderr)
        return 3
    for line in lines:  # the numbers compared come last
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
