"""repro_torch.obs — low-overhead span tracing, distribution telemetry,
the always-on metrics plane, and the incident flight recorder.

Four parts:

* :mod:`repro_torch.obs.trace` — per-thread bounded ring buffers of
  span/instant events (``perf_counter_ns``; no locks or allocation on
  the hot path; a single module-flag read when disabled).  The
  scheduling surfaces emit an instant wherever they bump a
  ``SchedTelemetry`` counter and a span around worker busy time and
  phase boundaries (serve step phases and each request's queue and
  prefill, EP round edges, the train step's phases, checkpoint shard
  writes).  While ``torch.profiler`` records, each span is also a
  ``record_function`` range named ``repro_torch.<cat>.<name>``, so the
  profiler holds the spans on its own clock beside the device ops.
* :mod:`repro_torch.obs.export` — merge the rings into Chrome
  trace-event JSON (Perfetto-loadable, one track per worker; spans still
  open at export time are swept in as truncated spans) plus metrics
  derived *from the trace*: per-worker occupancy/idle, join-stall and
  steal breakdowns, and the conservation cross-check that re-derives the
  spawn/join/steal counts from events and compares them to
  ``SchedTelemetry.summary()``.
* :mod:`repro_torch.obs.metrics` — the **default-on** metrics registry
  (counters/gauges/``LogHistogram``\\ s) with windowed snapshot deltas,
  a background :class:`~repro_torch.obs.metrics.Snapshotter` into a
  bounded time-series ring, and JSON-lines streaming
  (``REPRO_METRICS=/path/metrics.jsonl`` or the launchers'
  ``--metrics-json``).
* :mod:`repro_torch.obs.monitor` — the per-tenant SLO burn-rate monitor
  (:class:`~repro_torch.obs.monitor.SloMonitor`), the
  :class:`~repro_torch.obs.monitor.StallWatchdog`, and the
  :class:`~repro_torch.obs.monitor.FlightRecorder` that turns trace
  export from an atexit afterthought into a *triggered* incident dump.

Enable tracing per-process with ``REPRO_TRACE=/path/out.json`` (exports
at exit), per-run with the launchers' ``--trace out.json``, or in code
with :func:`repro_torch.obs.enable` +
:func:`repro_torch.obs.write_chrome_trace`.  See ``docs/obs.md``.
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
