"""Trace export + trace-derived metrics.

Two consumers, one format:

* **Perfetto / ``chrome://tracing``** — :func:`chrome_trace` merges the
  per-thread rings into Chrome trace-event JSON (``traceEvents`` with
  ``ph="X"`` complete spans and ``ph="i"`` instants, one track per
  worker thread via ``thread_name`` metadata).  Extra top-level keys
  (the Chrome format explicitly allows them) carry the telemetry
  summary and the derived metrics, so one artifact is both loadable in
  a viewer and machine-checkable in CI.
* **CI conservation gates** — :func:`counts_from_chrome` re-derives the
  spawn/join/steal/split/complete/error counts from the instant events
  (summing each event's integer weight ``n``) and :func:`crosscheck`
  asserts they equal ``SchedTelemetry.summary()``.  The trace cannot
  silently lie about the counts the paper's Fig. 10 argument rests on.

Derived metrics (:func:`derived_metrics`), all computed *from the
trace*: per-worker occupancy/idle fractions (busy = ``cat="worker"``
span time), park time, and per-span-name duration breakdowns
(``join_stall``, ``steal``, serve/train/ckpt/ep phases) with
p50/p99/max — the queue-wait and join-stall story ``report()``'s
medians cannot tell.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..sched.telemetry import percentile
from . import trace as _trace

#: instant-event names whose weights must reconcile with the
#: SchedTelemetry counter of the same name (the conservation contract)
COUNTER_EVENTS = ("spawns", "joins", "steals", "splits", "completions",
                  "errors", "cancelled", "retries", "worker_deaths")
#: instant name (singular, as emitted) → telemetry summary key
_EVENT_TO_COUNTER = {
    "spawn": "spawns", "join": "joins", "steal": "steals",
    "split": "splits", "complete": "completions", "error": "errors",
    "cancel": "cancelled", "retry": "retries",
    "worker_death": "worker_deaths",
}
#: span categories counted as worker *busy* time (occupancy numerator);
#: these spans never nest within each other by construction
WORKER_CATS = ("worker",)


def chrome_trace(events: Optional[List[Dict]] = None,
                 extra: Optional[Dict[str, Any]] = None,
                 include_open: bool = True) -> Dict[str, Any]:
    """Snapshot (or take) raw events and render Chrome trace-event JSON.

    Timestamps are microseconds (the format's unit), rebased to the
    earliest event so traces start near t=0 in a viewer.

    When snapshotting (``events is None``), spans still open at export
    time are swept in as truncated spans (``"trunc": true``, end = now)
    — an atexit/incident export must show what was in flight, not drop
    it.  Truncated spans never carry counter instants, so they cannot
    disturb the conservation cross-check.
    """
    if events is None:
        events = _trace.snapshot()
        if include_open:
            events = events + _trace.open_span_events()
    t0 = min((e["ts_ns"] for e in events), default=0)
    out: List[Dict[str, Any]] = []
    threads = {}
    for e in events:
        threads.setdefault(e["tid"], e["thread"])
        rec: Dict[str, Any] = {
            "name": e["name"], "cat": e["cat"], "ph": e["ph"],
            "ts": (e["ts_ns"] - t0) / 1e3, "pid": 0, "tid": e["tid"],
            "args": dict(e["args"] or {}, n=e["n"]),
        }
        if e["ph"] == "X":
            rec["dur"] = e["dur_ns"] / 1e3
            if e.get("trunc"):
                rec["trunc"] = True
                rec["args"]["trunc"] = True  # survives viewer round-trips
        else:
            rec["s"] = "t"  # instant scope: thread
        out.append(rec)
    # one named track per thread (workers are named by their executor)
    for tid, name in sorted(threads.items()):
        out.append({"name": "thread_name", "ph": "M", "pid": 0,
                    "tid": tid, "args": {"name": name}})
    doc: Dict[str, Any] = {"traceEvents": out, "displayTimeUnit": "ms"}
    if extra:
        doc.update(extra)
    return doc


def write_chrome_trace(path: str,
                       events: Optional[List[Dict]] = None,
                       extra: Optional[Dict[str, Any]] = None,
                       derive: bool = True) -> Dict[str, Any]:
    """Export to ``path`` (Perfetto-loadable), embedding the derived
    metrics (and any ``extra`` keys, e.g. ``{"telemetry": summary}``)
    as top-level siblings of ``traceEvents``."""
    doc = chrome_trace(events, extra)
    if derive:
        doc["derived"] = derived_metrics(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def _trace_events(doc_or_events) -> List[Dict]:
    if isinstance(doc_or_events, dict):
        return doc_or_events["traceEvents"]
    return doc_or_events


def counts_from_chrome(doc_or_events) -> Dict[str, int]:
    """Re-derive the telemetry counters from the exported instants —
    each counter is the sum of its events' integer weights."""
    counts = {k: 0 for k in COUNTER_EVENTS}
    for e in _trace_events(doc_or_events):
        if e.get("ph") != "i":
            continue
        key = _EVENT_TO_COUNTER.get(e["name"])
        if key is not None:
            counts[key] += int(e.get("args", {}).get("n", 1))
    return counts


def errors_by_site_from_chrome(doc_or_events) -> Dict[str, int]:
    """Per-site error counts re-derived from the ``error`` instants'
    ``site`` args — the error-instant conservation side of
    ``SchedTelemetry.errors_by_site``.  Events without a site (legacy
    traces) land under ``"?"``."""
    out: Dict[str, int] = {}
    for e in _trace_events(doc_or_events):
        if e.get("ph") != "i" or e.get("name") != "error":
            continue
        args = e.get("args") or {}
        site = args.get("site", "?")
        out[site] = out.get(site, 0) + int(args.get("n", 1))
    return out


def exchange_counts_from_chrome(doc_or_events) -> Dict[str, int]:
    """EP round edges re-derived from the ``round_posted`` /
    ``round_completed`` instants (cat ``ep``)."""
    posted = completed = 0
    for e in _trace_events(doc_or_events):
        if e.get("ph") != "i" or e.get("cat") != "ep":
            continue
        if e["name"] == "round_posted":
            posted += int(e.get("args", {}).get("n", 1))
        elif e["name"] == "round_completed":
            completed += int(e.get("args", {}).get("n", 1))
    return {"posted": posted, "completed": completed}


def _span_stats(durs_us: List[float]) -> Dict[str, float]:
    ms = [d / 1e3 for d in durs_us]
    return dict(count=len(ms), total_ms=round(sum(ms), 3),
                p50_ms=round(percentile(ms, 50), 4),
                p99_ms=round(percentile(ms, 99), 4),
                max_ms=round(max(ms), 4))


def derived_metrics(doc_or_events) -> Dict[str, Any]:
    """Metrics computed purely from the trace: wall span, per-worker
    occupancy/idle/park fractions, per-name span breakdowns, and the
    re-derived counts."""
    events = _trace_events(doc_or_events)
    xs = [e for e in events if e.get("ph") == "X"]
    all_ts = [e["ts"] for e in events if e.get("ph") in ("X", "i")]
    if not all_ts:
        return {"wall_ms": 0.0, "per_worker": {}, "span_stats": {},
                "counts": counts_from_chrome(events)}
    end = max((e["ts"] + e.get("dur", 0)) for e in events
              if e.get("ph") in ("X", "i"))
    wall_us = max(end - min(all_ts), 1e-9)

    per_worker: Dict[str, Dict[str, float]] = {}
    busy: Dict[Any, float] = {}
    park: Dict[Any, float] = {}
    names: Dict[str, List[float]] = {}
    for e in xs:
        key = f"{e.get('cat', '')}.{e['name']}"
        names.setdefault(key, []).append(e.get("dur", 0.0))
        if e.get("cat") in WORKER_CATS:
            busy[e["tid"]] = busy.get(e["tid"], 0.0) + e.get("dur", 0.0)
        elif e["name"] == "park":
            park[e["tid"]] = park.get(e["tid"], 0.0) + e.get("dur", 0.0)
    for tid in sorted(set(busy) | set(park), key=str):
        b = busy.get(tid, 0.0)
        per_worker[str(tid)] = dict(
            busy_ms=round(b / 1e3, 3),
            occupancy=round(b / wall_us, 4),
            idle_frac=round(1.0 - min(b / wall_us, 1.0), 4),
            park_ms=round(park.get(tid, 0.0) / 1e3, 3))
    return {
        "wall_ms": round(wall_us / 1e3, 3),
        "per_worker": per_worker,
        "span_stats": {k: _span_stats(v) for k, v in sorted(names.items())},
        "counts": counts_from_chrome(events),
        "exchange": exchange_counts_from_chrome(events),
    }


def crosscheck(doc_or_events, telemetry_summary: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Compare trace-derived counts with a ``SchedTelemetry.summary()``.

    Returns ``{"ok", "mismatches", "trace", "telemetry"}``; callers
    (benches, CI gates, tests) assert on ``ok``.  Only counters present
    in the summary are compared — a surface that never steals is not
    penalised for a zero.
    """
    tcounts = counts_from_chrome(doc_or_events)
    mismatches = []
    checked = {}
    for key in COUNTER_EVENTS:
        if key not in telemetry_summary:
            continue
        want = int(telemetry_summary[key])
        got = tcounts[key]
        checked[key] = want
        if got != want:
            mismatches.append(f"{key}: trace={got} telemetry={want}")
    by_site = telemetry_summary.get("errors_by_site")
    if by_site:
        got_site = errors_by_site_from_chrome(doc_or_events)
        for site, want in sorted(by_site.items()):
            checked[f"errors_by_site.{site}"] = want
            if got_site.get(site, 0) != int(want):
                mismatches.append(f"errors_by_site.{site}: "
                                  f"trace={got_site.get(site, 0)} "
                                  f"telemetry={want}")
    ex = telemetry_summary.get("exchange")
    if ex:
        got_ex = exchange_counts_from_chrome(doc_or_events)
        for key in ("posted", "completed"):
            if key in ex:
                checked[f"exchange.{key}"] = ex[key]
                if got_ex[key] != int(ex[key]):
                    mismatches.append(f"exchange.{key}: "
                                      f"trace={got_ex[key]} "
                                      f"telemetry={ex[key]}")
    return {"ok": not mismatches, "mismatches": mismatches,
            "trace": tcounts, "telemetry": checked}
