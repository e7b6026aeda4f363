"""The program's own spans over a profiled stretch of whole steps.

``record`` enables the program's tracer (``repro_torch.obs.trace``),
cleared, for the stretch and disables it after.  While the profiler
records, each span of the program is also a profiler range named
``repro_torch.<cat>.<name>``; ``lib.trace.record`` profiles the stretch,
then every event of that name moves out of the trace's ``ops`` and
``host`` (whose device work and host operators stay as that module
describes them) into:

* ``host``: the program's ranges on the host, ``(name, start_us,
  end_us)``, on the profiler's clock;
* ``device``: the same ranges as the device timeline shows them, where
  the profiler puts the device work launched inside them;
* ``events``: the tracer's own records of the stretch (``obs.snapshot()``:
  each span's ``args``, and the complete spans that open no profiler
  range).

Where the program's spans open no profiler range, or carry no such
``args``, the readings are None.  ``portbench/phases.py`` reads them;
no registered metric does yet (a kind that calls ``record`` after its
first traced stretch, and the metrics' files, come with their
``BENCHMARK.json`` entries).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import trace as T

PREFIX = "repro_torch."


@dataclass
class Spans:
    trace: T.Trace
    host: list = field(default_factory=list)
    device: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def host_s(self, name: str) -> float:
        """Seconds of the host ranges called ``repro_torch.<name>``."""
        return sum(b - a for n, a, b in self.host if n == PREFIX + name) \
            * 1e-6

    def idle_share(self, name: str):
        """% of the device's idle gaps (``Trace.gaps()``) that lies inside
        the host ranges called ``repro_torch.<name>``, or None where there
        are none of either."""
        ranges = [(a, b) for n, a, b in self.host if n == PREFIX + name]
        gaps = self.trace.gaps()
        if not ranges or not gaps:
            return None
        inside = sum(max(0, min(b, hb) - max(a, ha))
                     for a, b in gaps for ha, hb in ranges)
        return 100.0 * inside / sum(b - a for a, b in gaps)

    def lane_share(self):
        """% of the prefill launches' lanes (``n_slots * prefill_chunk``)
        that hold a real prompt token: the summed ``tokens`` over the
        summed ``lanes`` of the ``serve.prefill_chunk`` spans, or None
        where there are none."""
        chunks = [e["args"] for e in self.events
                  if e["cat"] == "serve" and e["name"] == "prefill_chunk"
                  and e["ph"] == "X" and "lanes" in (e["args"] or {})]
        if not chunks:
            return None
        return 100.0 * sum(a["tokens"] for a in chunks) \
            / sum(a["lanes"] for a in chunks)


def _split(events) -> tuple:
    """``(the program's ranges, the rest)``."""
    return ([e for e in events if e[0].startswith(PREFIX)],
            [e for e in events if not e[0].startswith(PREFIX)])


def record(run_step, steps: int) -> Spans:
    """Profile ``steps`` calls of ``run_step(i)`` with the program's
    tracer on."""
    from repro_torch.obs import trace as obs

    obs.clear()
    obs.enable()
    try:
        tr = T.record(run_step, steps)
    finally:
        obs.disable()
    out = Spans(trace=tr, events=obs.snapshot())
    obs.clear()
    out.device, tr.ops = _split(tr.ops)
    out.host, tr.host = _split(tr.host)
    tr.busy_s = T._union_s((a, b) for _, a, b in tr.ops)
    return out

