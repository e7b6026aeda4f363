"""The port's tracer (``repro_torch.obs.trace``) on the paths it times, on
the CPU: off, ``trace_span`` is the shared no-op and a profiled train step
holds no ``repro_torch.*`` range; on, the train step's phases are in the
ring and, in the same count and order, in the profiler's trace; a
``ContinuousBatcher`` run stamps each request's queue, placement and
first token in order, and its prefill launches' real tokens fit their
lanes."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.serve import batcher as TB  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig, init_opt_state,
)
from repro_torch.train.train_step import (  # noqa: E402
    StepConfig, build_train_step,
)

CPU = torch.device("cpu")
M = 2   # microbatches


@pytest.fixture()
def tracer():
    """The tracer on, cleared, for one test; off and cleared after."""
    obs.clear()
    obs.enable()
    try:
        yield
    finally:
        obs.disable()
        obs.clear()


def _profiled_train_step():
    """One AdamW step of the granite-moe SMOKE config in fp32, at two
    microbatches, under ``torch.profiler``; the profiler's
    ``repro_torch.*`` host ranges, by start."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype="float32")
    ocfg = AdamWConfig()
    step, _ = build_train_step(cfg, ShapeConfig("t", 16, 4, "train",
                                                microbatches=M),
                               StepConfig(remat=False), ocfg)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    opt = init_opt_state(params, ocfg)
    ids = torch.randint(0, cfg.vocab, (4, 17),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": ids[:, :-1].contiguous(),
             "labels": ids[:, 1:].contiguous()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    ranges = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    return [e.name for e in sorted(ranges, key=lambda e: e.time_range.start)]


PHASES = [n for i in range(M) for n in ("forward", "backward", "accumulate")] \
    + ["optimizer"]


def test_off_is_the_shared_noop_and_opens_no_profiler_range():
    assert not obs.enabled()
    assert obs.trace_span("train", "forward") is obs._NOOP
    assert obs.trace_span("serve", "decode", {"active": 1}) is obs._NOOP
    assert _profiled_train_step() == []


def test_on_the_train_phases_reach_the_ring_and_the_profiler(tracer):
    names = _profiled_train_step()
    ring = [e for e in obs.snapshot() if e["cat"] == "train"]
    ring.sort(key=lambda e: e["ts_ns"])
    assert [e["name"] for e in ring] == PHASES
    assert [e["args"] for e in ring] == \
        [{"mb": i} for i in range(M) for _ in range(3)] + [None]
    assert names == [f"repro_torch.train.{n}" for n in PHASES]


def test_batcher_stamps_each_request_and_prefill_fits_its_lanes(tracer):
    cfg = ModelConfig(name="obs-test", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=128, dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    b = TB.ContinuousBatcher(cfg, params, n_slots=2, cache_len=32,
                             policy="dlbc", prefill_chunk=4, device="cpu")
    g = torch.Generator().manual_seed(2)
    reqs = [TB.Request(rid=i, prompt=torch.randint(
        0, cfg.vocab, (n,), generator=g).tolist(), max_new=3,
        arrive_step=i)
        for i, n in enumerate([9, 1, 6, 13, 3])]
    b.run(reqs)
    assert all(r.done_step is not None for r in reqs)
    for r in reqs:
        assert r.submit_ns <= r.placed_ns <= r.first_token_ns
    ev = obs.snapshot()
    chunks = [e["args"] for e in ev if e["name"] == "prefill_chunk"
              and e["ph"] == "X"]
    assert chunks and all(0 < a["tokens"] <= a["lanes"] == 2 * 4
                          for a in chunks)
    for name, a, z in (("queue", "submit_ns", "placed_ns"),
                       ("prefill", "placed_ns", "first_token_ns")):
        spans = {e["args"]["rid"]: e for e in ev
                 if e["cat"] == "serve" and e["name"] == name}
        assert sorted(spans) == [r.rid for r in reqs]
        for r in reqs:
            assert spans[r.rid]["ts_ns"] == getattr(r, a)
            assert spans[r.rid]["dur_ns"] == getattr(r, z) - getattr(r, a)
