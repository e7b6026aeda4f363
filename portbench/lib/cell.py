"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A workload names its configuration and its traffic; the configuration's
file is the one ``BENCHMARK.json`` gives, the traffic's is
``portbench/traffic/<traffic>.json``, the limits of what decides
``correct`` are ``portbench/limits/<cell>.json`` and each metric's reader
is ``portbench/metrics/<metric>.py``.  The configuration's ``family``
names ``portbench/families/<family>.py`` (weight leaves, active
parameters) and ``portbench/reference/<family>.py`` (the plain
reference); the traffic's ``kind`` names ``portbench/kinds/<kind>.py``
(how the kind drives the program and reads the limits' readings).  A
cell's metrics are the entries of ``end_to_end`` and ``per_layer`` that
list it under ``workloads`` (or that list none).  Adding a cell, a
configuration of a new family or a traffic mix of a new kind therefore
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


@dataclass
class Cell:
    name: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # ... and with --trace 1
    chips: int
    limits: dict          # portbench/limits/<cell>.json: the compared numbers


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)],
                chips=int(w["chips"]),
                limits=json.loads((root / "portbench" / "limits" /
                                   f"{name}.json").read_text()))


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of a per-layer metric's file."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    """``portbench/families/<name>.py``: a model family's weight leaves
    (``leaf_specs``) and active parameters (``n_active_params``)."""
    return importlib.import_module(f"portbench.families.{name}")


def kind(name: str):
    """``portbench/kinds/<name>.py``: how a traffic kind drives the
    program for one run (``run``) and reads what sets a cell's limits
    (``calibrate``)."""
    return importlib.import_module(f"portbench.kinds.{name}")
