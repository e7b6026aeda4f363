"""The program's spans and request stamps as the benchmark's tools read
them, on the CPU at the smoke sizes: the profiled stretch that the
registered per-layer metrics read holds none of the program's ranges; a
stretch profiled with the program's tracer on (``lib.spans``, driven by
``portbench/phases.py``) gives every span reading that the CPU can read a
number; the device's idle gaps inside a span, the prefill launch's real
lanes and the requests' waits, on records made up for the test."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from portbench import phases
from portbench.lib import spans as S, trace as T
from portbench.lib.cell import kind
from portbench.tests.smoke import smoke_cell

SEED = 2 ** 31 + 11


@pytest.mark.parametrize("name", ["granite-train-4k", "granite-serve-docqa"])
def test_first_stretch_holds_no_program_range(name):
    cell = smoke_cell(name)
    seconds = 0.3 if cell.traffic["kind"] == "train" else 3.0
    run = kind(cell.traffic["kind"]).run(cell, SEED, seconds, 1, "cpu",
                                         time.perf_counter())
    tr = run.trace
    assert tr.host
    assert not [n for n, _, _ in tr.ops + tr.host + tr.spans
                if n.startswith(S.PREFIX)]


@pytest.mark.parametrize("name", ["granite-train-4k", "granite-serve-docqa"])
def test_span_readings_read_a_number(name):
    cell = smoke_cell(name)
    train = cell.traffic["kind"] == "train"
    got = phases.measure(cell, SEED, 0.4 if train else 3.0, device="cpu")
    assert got["first_stretch_program_ranges"] == 0
    assert got["ring_dropped"] == 0
    steps = cell.traffic["trace_steps"]
    if train:
        M = cell.traffic["microbatches"]
        assert got["backward_ops"]["host_ranges"] == M * steps
        for phase in ("forward", "backward", "accumulate", "optimizer"):
            assert got["host_ms_per_step"][f"train.{phase}"] > 0
            assert got["profiled_host_ms_per_step"][f"train.{phase}"] > 0
        assert got["metrics"]["enqueue_ms_per_step.train"] > 0
    else:
        assert 0 < got["prefill_lane_share"] <= 100
        assert "serve.queue" not in got["host_ms_per_step"]
        assert got["host_ms_per_step"]["serve.decode"] > 0
        req = got["requests"]
        assert req["n"] > 0 and req["queue_ms"] >= 0
        assert req["prefill_ms"] > 0
        # each request's whole wait holds both parts, so its median
        # holds both medians
        assert req["submit_to_first_ms"] >= max(req["queue_ms"],
                                                req["prefill_ms"])
    assert got["step_s"]["on"] > 0 and got["step_s"]["off"] > 0


def test_idle_share_inside_a_span():
    """Gaps (10, 20) and (30, 50) of 30 µs; the backward's host range
    (5, 25) holds 10 of them, the optimizer's (45, 70) 5."""
    sp = S.Spans(trace=T.Trace(ops=[("k", 0, 10), ("k", 20, 30),
                                    ("k", 50, 60)]),
                 host=[(S.PREFIX + "train.backward", 5, 25),
                       (S.PREFIX + "train.optimizer", 45, 70)])
    assert sp.idle_share("train.backward") == pytest.approx(100 / 3)
    assert sp.idle_share("train.optimizer") == pytest.approx(50 / 3)
    assert sp.idle_share("train.forward") is None


def test_lane_share_of_the_prefill_chunks():
    """Two launches of 8 lanes hold 3 and 1 real tokens: 25 %; spans of
    another name, and a chunk span without ``lanes``, are not read."""
    def ev(name, args):
        return {"ph": "X", "cat": "serve", "name": name, "args": args}
    sp = S.Spans(trace=T.Trace(), events=[
        ev("prefill_chunk", {"slots": 2, "tokens": 3, "lanes": 8}),
        ev("prefill_chunk", {"slots": 1, "tokens": 1, "lanes": 8}),
        ev("prefill_chunk", {"slots": 1, "tokens": 5}),
        ev("decode", {"lanes": 100, "tokens": 0})])
    assert sp.lane_share() == pytest.approx(25.0)
    assert S.Spans(trace=T.Trace()).lane_share() is None


def test_waits_of_the_requests_first_served_in_the_window():
    """Of four requests, the two whose first token came in (100, 200]
    are read, one of them placed before the window."""
    def req(submit, placed, first):
        return SimpleNamespace(submit_ns=submit, placed_ns=placed,
                               first_token_ns=first)
    got = phases._waits([req(0, 10, 90), req(20, 60, 150),
                         req(110, 130, 200), req(150, 190, None)],
                        100, 200)
    assert got["n"] == 2 and got["placed_before_window"] == 1
    assert got["queue_ms"] == pytest.approx(1e-6 * 30)
    assert got["prefill_ms"] == pytest.approx(1e-6 * 80)
    assert got["submit_to_first_ms"] == pytest.approx(1e-6 * 110)
