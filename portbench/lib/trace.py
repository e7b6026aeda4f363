"""The device trace of a short stretch of whole steps, reduced.

``torch.profiler`` (CPU and CUDA activity, CUPTI) records the stretch;
what the metrics read is kept as plain lists:

* ``ops``: every operation that ran on the device (kernels, copies,
  sets), as ``(name, start_us, end_us)``;
* ``spans``: the benchmark's own ranges (``record_function("pb.*")``), as
  the device timeline shows them: ``(name, start_us, end_us)``; a device
  operation belongs to the span whose interval holds its start;
* ``busy_s``: the union of the operations' intervals; ``window_s``: the
  stretch on the host's clock, from the synchronise before it to the one
  after it;
* ``host``: the host's operator events, ``(name, start_us, end_us)``,
  which name what the host was doing in the device's idle gaps;
* ``routed``: ``(span, E, C, d, kept pairs)`` of each mixture call of
  the stretch (``lib.routed``), where the run records them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

PREFIX = "pb."


@dataclass
class Trace:
    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    host: list = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    routed: list = field(default_factory=list)

    def in_span(self, name: str) -> list:
        """The device operations of every span called ``name``, one list
        per span."""
        out = []
        for s_name, a, b in self.spans:
            if s_name == name:
                out.append([o for o in self.ops if a <= o[1] < b])
        return out

    def gaps(self) -> list:
        """The device's idle gaps ``(start_us, end_us)``, longest first."""
        out, end = [], None
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return sorted(out, key=lambda g: g[0] - g[1])

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host operator that overlapped each most."""
        by: dict = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        for a, b in self.gaps()[:n]:
            best, what = 0.0, "nothing traced"
            for name, ha, hb in self.host:
                ov = min(b, hb) - max(a, ha)
                if ov > best:
                    best, what = ov, name
            gaps.append([what, (b - a) * 1e-6])
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": gaps}


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def record(run_step, steps: int) -> Trace:
    """Profile ``steps`` calls of ``run_step(i)``; each call is one whole
    step of the window's own kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run_step(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    tr = Trace(window_s=window, steps=steps)
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(PREFIX):
                tr.spans.append((e.name, a, b))
            else:
                tr.ops.append((e.name, a, b))
        elif not e.name.startswith(PREFIX):
            tr.host.append((e.name, a, b))
    tr.busy_s = _union_s((a, b) for _, a, b in tr.ops)
    return tr
