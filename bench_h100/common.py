"""Seeds, the look for a card, and the check that no JAX was loaded."""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that may not be loaded by a run, compared whole:
# ``adipose_tpu_torch`` starts with ``adipose_tpu`` and is the program.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "adipose_tpu")


class NoCard(RuntimeError):
    """The run needs more CUDA devices than the machine has."""


def sub_seed(seed: int, domain: str) -> int:
    """A 63-bit seed for one stream of a run: sha256 of (domain, seed), so
    streams are independent and any seed, however large, is accepted."""
    digest = hashlib.sha256(f"{domain}:{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, domain: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, domain))


def require_cards(count: int) -> torch.device:
    """The first CUDA device, or :class:`NoCard` naming what is missing.
    There is no fallback to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs only on a CUDA "
                     "GPU")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell asks for {count} CUDA devices and "
                     f"torch.cuda.device_count() is {have}")
    return torch.device("cuda", 0)


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), each compared whole."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest(path: Path | None = None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration and traffic files read:
    ``{"cell", "config", "traffic", "end_to_end", "per_layer"}``, the
    metrics being those of ``BENCHMARK.json`` that this cell reports."""
    bench = bench or manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def reported(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reported(m) and ("workloads" in m or m["moves"] in e2e_names)]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}
