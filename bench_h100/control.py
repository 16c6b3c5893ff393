#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, several seeds in one process:

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 --seconds 2 \\
        [--fault altered|half_batch|unchanged] [--control 1]

For each seed the cell is set up as ``run.py`` sets it up (with ``--fault``
planted under its timed path), a short window is driven and its sample
checked as a run checks it: the program's readings. With ``--control 1``
the same sample is then checked with the reference in float8 standing in
for the program: the control's readings. One JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from bench_h100 import common, faults  # noqa: E402
from bench_h100.run import Reservoir, load_file, request_window, step_window  # noqa: E402


def readings(spec: dict, seed: int, seconds: float, device, fault: str | None = None,
             control: bool = False) -> dict:
    entry = load_file("entries", spec["traffic"]["entry"]).build(spec, seed, device)
    if fault:
        faults.FAULTS[fault](entry)
    entry.warm()
    sampler = Reservoir(spec["traffic"].get("sample_requests", 0),
                        random.Random(common.sub_seed(seed, "sample")))
    log: dict = {}
    if entry.kind == "requests":
        rec = request_window(entry, seconds, sampler, log)
    else:
        rec = step_window(entry, seconds, log)
    out = {"seed": seed, "fault": fault, "units": rec.get("requests", rec.get("steps")),
           "program": entry.check(sampler.items)}
    if control:
        out["control"] = entry.check(sampler.items, control=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = common.cell_spec(args.workload)
    try:
        device = common.require_cards(spec["cell"]["chips"])
    except common.NoCard as e:
        print(f"bench_h100: {e}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(spec, seed, args.seconds, device, args.fault, bool(args.control))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
