"""The program's spans in one cell, and what the program's tracer costs
when it is on.

    python3 portbench/phases.py --workload <name> --seed <n> [--seconds 20]

Builds the cell's program as its traffic kind does (``lib.train`` or
``lib.serve``: the same set-up and warm-up; a kind hands no program
over), then, the tracer off unless said: ``--seconds`` of window; four
timed stretches of ``--seconds / 2`` each, the tracer off, on, on, off;
the profiled stretch that ``--trace 1`` takes; the same again with the
tracer on (``lib.spans``).  Prints one JSON line:

* ``host_ms_per_step``: each span's host ms per step from the tracer's
  own rings in the two unprofiled "on" stretches;
  ``profiled_host_ms_per_step``: the same from the profiler's ranges,
  which the profiler's per-operator cost inflates;
* ``idle_share_inside``: the % of the device's idle time that lies inside
  each span's host ranges, under the profiler (its cost lands where the
  host launches, so the split may be partly its own);
* ``step_s``: the median step of each side, and the on-cost;
* training: ``backward_ops``, how many device operations start inside the
  device ranges of ``train.backward`` against inside its host ranges
  (where the autograd engine's launches land);
* serving: ``prefill_lane_share``; ``requests``: the queue and prefill
  waits (medians of the ``Request`` stamps) of the requests whose first
  token came in the window, beside the harness's TTFT median;
* the registered metrics of the window and the first profiled stretch,
  and the program's ranges found in that stretch (none: the tracer was
  off there).

Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]

#: the registered metrics read beside the spans
METRICS = {
    "train": ["enqueue_ms_per_step.train", "idle_share.train"],
    "serve": ["ttft_p95_ms.serve", "idle_share.serve"],
}

#: complete spans of one request each, not of a step
PER_REQUEST = {"serve.queue", "serve.prefill"}


class _Program:
    """One cell's program, stepped whole steps at a time."""

    def __init__(self, cell, seed, device):
        from portbench.lib import device as D

        self.D = D
        self.kind = "train" if cell.traffic["kind"] == "train" else "serve"
        if self.kind == "train":
            from portbench.lib.train import Trainer
            self.prog = Trainer(cell, seed, device)
            self.prog.checked_steps()
        else:
            from portbench.lib.serve import Server
            self.prog = Server(cell, seed, device)
            for _ in range(cell.traffic["warmup_steps"]):
                self.prog.step()
        D.sync()

    def step(self, _=None):
        from torch.profiler import record_function

        with record_function("pb.step"):
            self.prog.step()

    def timed(self, seconds: float) -> list:
        """Each whole step's seconds (synchronised) until ``seconds``."""
        out, t0 = [], time.perf_counter()
        while not out or time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            self.prog.step()
            self.D.sync()
            out.append(time.perf_counter() - a)
        return out


def _inside(ops, ranges) -> int:
    return sum(1 for _, a, _ in ops if any(x <= a < y for x, y in ranges))


def _waits(reqs, t0_ns: int, t1_ns: int) -> dict:
    """Medians, in ms, of the stamps of the requests whose first token
    came in ``(t0_ns, t1_ns]``."""
    got = [r for r in reqs
           if r.first_token_ns is not None and t0_ns < r.first_token_ns
           <= t1_ns]

    def med(xs):
        return 1e-6 * statistics.median(xs) if xs else None
    return {"n": len(got),
            "placed_before_window": sum(1 for r in got
                                        if r.placed_ns <= t0_ns),
            "queue_ms": med([r.placed_ns - r.submit_ns for r in got]),
            "prefill_ms": med([r.first_token_ns - r.placed_ns for r in got]),
            "submit_to_first_ms": med([r.first_token_ns - r.submit_ns
                                       for r in got])}


def measure(cell, seed: int, seconds: float, device="cuda") -> dict:
    from repro_torch.obs import trace as obs

    from portbench.lib import spans as S, trace as T
    from portbench.lib.cell import reader

    d = _Program(cell, seed, device)
    t0_ns = time.perf_counter_ns()
    win = d.prog.window(seconds)
    t1_ns = time.perf_counter_ns()
    if d.kind == "serve":
        waits = _waits(d.prog.finished + list(d.prog.live.values()),
                       t0_ns, t1_ns)
    sides: dict = {False: [], True: []}
    ring_ns: dict = {}
    dropped = 0
    for on in (False, True, True, False):
        obs.clear()
        if on:
            obs.enable()
        try:
            sides[on] += d.timed(seconds / 2)
        finally:
            obs.disable()
            for e in obs.snapshot():
                key = f"{e['cat']}.{e['name']}"
                if e["ph"] == "X" and key not in PER_REQUEST:
                    ring_ns[key] = ring_ns.get(key, 0) + e["dur_ns"]
            dropped += sum(r.dropped for r in obs._rings)
            obs.clear()
    steps = cell.traffic["trace_steps"]
    first = T.record(d.step, steps)
    sp = S.record(d.step, steps)
    run = SimpleNamespace(kind=d.kind, window=win, trace=first,
                          model=cell.config["model"], traffic=cell.traffic)
    out = {"workload": cell.name, "seed": seed,
           "metrics": {m: reader(m)(run) for m in METRICS[d.kind]}}
    out["host_ms_per_step"] = {k: 1e-6 * v / len(sides[True])
                               for k, v in sorted(ring_ns.items())}
    out["ring_dropped"] = dropped
    names = sorted({n[len(S.PREFIX):] for n, _, _ in sp.host})
    out["profiled_host_ms_per_step"] = {n: 1e3 * sp.host_s(n) / steps
                                        for n in names}
    out["idle_share_inside"] = {n: sp.idle_share(n) for n in names}
    out["profiled_step_ms"] = 1e3 * sp.trace.window_s / steps
    off, on = statistics.median(sides[False]), statistics.median(sides[True])
    out["step_s"] = {"off": off, "on": on, "on_cost": on / off - 1,
                     "steps": [len(sides[False]), len(sides[True])]}
    out["first_stretch_program_ranges"] = sum(
        1 for n, _, _ in first.ops + first.host + first.spans
        if n.startswith(S.PREFIX))
    if d.kind == "train":
        name = S.PREFIX + "train.backward"
        dev = [(a, b) for n, a, b in sp.device if n == name]
        host = [(a, b) for n, a, b in sp.host if n == name]
        out["backward_ops"] = {"device_ranges": len(dev),
                               "in_device_ranges": _inside(sp.trace.ops, dev),
                               "host_ranges": len(host),
                               "in_host_ranges": _inside(sp.trace.ops, host),
                               "all": len(sp.trace.ops)}
        out["enqueue_ms_median"] = 1e3 * statistics.median(win["enqueue_s"])
    else:
        out["prefill_lane_share"] = sp.lane_share()
        waits["ttft_ms_median"] = 1e3 * statistics.median(win["ttft_s"]) \
            if win["ttft_s"] else None
        out["requests"] = waits
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        sys.path.insert(0, p)
    import torch

    from portbench.lib.cell import load

    if not torch.cuda.is_available():
        print("phases: needs a CUDA card", file=sys.stderr)
        return 2
    out = measure(load(args.workload), args.seed, args.seconds)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
