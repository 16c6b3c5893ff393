"""BENCHMARK.json against the contract it is written to, and the files
each of its names leads to."""

import json
import re

from bench_h100 import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/") and (common.ROOT / c["file"]).exists()
        assert json.loads((common.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and cell["config"] in configs
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        used.add(cell["config"])
        assert (common.BENCH_DIR / "traffic" / f"{cell['traffic']}.json").exists()
        assert (common.BENCH_DIR / "limits" / f"{cell['name']}.json").exists()
        traffic = common.load_json(common.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
        assert (common.BENCH_DIR / "entries" / f"{traffic['entry']}.py").exists()
    assert used == set(configs)


def test_metrics_reported_and_bounded():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [c["name"] for c in BENCH["workloads"]]
    for name in cells:
        spec = common.cell_spec(name)
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in reported, (name, m["name"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert set(by_layer) == {"entry", "step", "model", "model ops", "kernels", "device"}
