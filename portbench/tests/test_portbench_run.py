"""A run drives the cell's own path end to end and prints the contract's
last line; on the CPU with the smoke sizes and the kernels' plain
versions, the CLI itself refusing a machine without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run as R
from portbench.lib.cell import ROOT
from portbench.tests.smoke import smoke_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CLI runs there")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["granite-train-4k", "granite-serve-docqa"])
def test_result_line(name, trace):
    cell = smoke_cell(name)
    seconds = 0.5 if cell.traffic["kind"] == "train" else 3.0
    result, lines = R.run_cell(cell, 2 ** 31 + 5, seconds, trace,
                               device="cpu")
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True, lines
    wanted = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert set(result["metrics"]) == wanted
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"}
               for c in result["checks"].values())
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})"
        for k, c in result["checks"].items()]
    json.dumps(result)


def test_cli_refuses_without_a_card(no_card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "granite-train-4k", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert R.forbidden_modules() == ["repro.fake"]


@pytest.mark.parametrize("name", ["granite-train-4k", "granite-serve-docqa"])
def test_traced_run_records_the_kept_pairs(name):
    import time

    from portbench.lib.cell import kind
    cell = smoke_cell(name)
    seconds = 0.3 if cell.traffic["kind"] == "train" else 3.0
    run = kind(cell.traffic["kind"]).run(cell, 2 ** 31 + 9, seconds, 1,
                                         "cpu", time.perf_counter())
    m, t = cell.config["model"], cell.traffic
    routed = run.trace.routed
    assert routed
    for span, E, C, d, kept in routed:
        assert (E, d) == (m["n_experts"], m["d_model"])
        assert 0 < kept <= E * C
    if t["kind"] == "train":
        # remat records each layer and microbatch twice, the same pairs
        assert len(routed) == 2 * m["n_layers"] * t["microbatches"] \
            * run.trace.steps
        b = t["global_batch"] // t["microbatches"]
        assert all(kept <= b * t["seq_len"] * m["top_k"]
                   for *_, kept in routed)
    else:
        assert {s for s, *_ in routed} == {"pb.prefill", "pb.decode"}
