"""repro.obs — low-overhead span tracing, distribution telemetry, the
always-on metrics plane, and the incident flight recorder.

Four parts:

* :mod:`repro.obs.trace` — per-thread bounded ring buffers of
  span/instant events (``perf_counter_ns``; no locks or allocation on
  the hot path; a single module-flag read when disabled).  The
  scheduling surfaces emit an instant wherever they bump a
  ``SchedTelemetry`` counter and a span around worker busy time and
  phase boundaries (serve step phases, EP round edges, trainer step
  phases, checkpoint shard writes).
* :mod:`repro.obs.export` — merge the rings into Chrome trace-event
  JSON (Perfetto-loadable, one track per worker; spans still open at
  export time are swept in as truncated spans) plus metrics derived
  *from the trace*: per-worker occupancy/idle, join-stall and steal
  breakdowns, and the conservation cross-check that re-derives the
  spawn/join/steal counts from events and compares them to
  ``SchedTelemetry.summary()``.
* :mod:`repro.obs.metrics` — the **default-on** metrics registry
  (counters/gauges/``LogHistogram``\\ s) with windowed snapshot deltas,
  a background :class:`~repro.obs.metrics.Snapshotter` into a bounded
  time-series ring, and JSON-lines streaming
  (``REPRO_METRICS=/path/metrics.jsonl`` or the launchers'
  ``--metrics-json``).
* :mod:`repro.obs.monitor` — the per-tenant SLO burn-rate monitor
  (:class:`~repro.obs.monitor.SloMonitor`), the
  :class:`~repro.obs.monitor.StallWatchdog`, and the
  :class:`~repro.obs.monitor.FlightRecorder` that turns trace export
  from an atexit afterthought into a *triggered* incident dump.

Enable tracing per-process with ``REPRO_TRACE=/path/out.json`` (exports
at exit), per-run with the launchers' ``--trace out.json``, or in code
with :func:`repro.obs.enable` + :func:`repro.obs.write_chrome_trace`.
See ``docs/obs.md``.
"""

from .trace import (  # noqa: F401
    DEFAULT_CAPACITY, Ring, clear, complete_span, disable, enable,
    enabled, instant, open_span_events, ring_stats, snapshot, trace_span,
)
from .export import (  # noqa: F401
    chrome_trace, counts_from_chrome, crosscheck, derived_metrics,
    exchange_counts_from_chrome, write_chrome_trace,
)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, MetricsSnapshot,
    Snapshotter,
)
from .monitor import (  # noqa: F401
    FlightRecorder, SloMonitor, StallWatchdog,
)
