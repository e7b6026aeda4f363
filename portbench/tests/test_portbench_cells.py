"""Every cell of BENCHMARK.json resolves its files by name, and the file
keeps to the benchmark's contract where a test can see it."""

from __future__ import annotations

import json

import pytest

from portbench.lib.cell import ROOT, load, reader

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_its_files(name):
    cell = load(name)
    w = {w["name"]: w for w in SPEC["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert cell.limits
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_per_layer_metrics_move_a_metric_of_their_cells(name):
    cell = load(name)
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_names_and_units():
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert all(name.match(k) for k in c["reduced"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
