"""Runs of the harness at small sizes on the CPU: without a card it
refuses; the control and the planted faults come out as not correct.
The look for a card is skipped by calling ``run_cell`` directly."""

import pytest
import torch

from bench_h100 import common, control, faults, run

CPU = torch.device("cpu")
SMALL = {  # a cell's configuration and traffic cut to a CPU test's size
    "unet44-segment-b16": ({"init_nb": 4}, {"tile_size": 64, "tiles_per_request": 4,
                                            "pool_tiles": 8}),
    "unet44-segment-b1": ({"init_nb": 4}, {"tile_size": 64, "pool_tiles": 4,
                                           "sample_requests": 2}),
    "unet44-train-b8": ({"init_nb": 4}, {"tile_size": 64, "batch": 4, "pool_tiles": 16}),
    "inception-tta-full-b64": ({}, {"tile_size": 96, "tiles_per_request": 4,
                                    "pool_tiles": 8}),
}


def small(cell):
    spec = common.cell_spec(cell)
    config, traffic = SMALL[cell]
    spec["config"].update(config)
    spec["traffic"].update(traffic)
    return spec


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "unet44-segment-b16", "--seed", str(2**31 + 9),
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is false" in out.err


def test_a_cell_needing_more_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(common.NoCard, match="asks for 4"):
        common.require_cards(4)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_reports_its_metrics(cell):
    result, lines = run.run_cell(small(cell), 2**31 + 11, 0.3, False, CPU)
    spec = common.cell_spec(cell)
    assert set(result["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    limits = common.load_json(common.BENCH_DIR / "limits" / f"{cell}.json")
    assert set(result["checks"]) == set(limits)
    assert lines[-len(limits):] == [f"check {n}: {c['value']!r} limit {c['limit']!r}"
                                    for n, c in result["checks"].items()]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_reads_far_above_the_program(cell):
    r = control.readings(small(cell), 2**31 + 13, 0.3, CPU, control=True)
    compared = common.load_json(common.BENCH_DIR / "limits" / f"{cell}.json")
    assert any(r["control"][n] > 3 * r["program"][n] for n in compared), r


CASES = [(cell, fault) for cell in sorted(SMALL) for fault in ("altered", "half_batch",
                                                               "unchanged")
         if not (fault == "unchanged" and "train" not in cell)
         and not (fault == "half_batch" and cell == "unet44-segment-b1")
         and not (fault == "altered" and "train" in cell)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    result, _ = run.run_cell(small(cell), 2**31 + 17, 0.3, False, CPU,
                             entry_hook=faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.card
def test_a_cell_on_the_card(card):
    result, _ = run.run_cell(common.cell_spec("unet44-segment-b16"), 2**31 + 19, 2.0, False,
                             card)
    assert result["correct"] and result["device"]["platform"] == "gpu"
