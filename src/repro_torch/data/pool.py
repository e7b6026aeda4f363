"""Back-compat host worker pool — now a thin wrapper over ``repro.sched``.

The DLBC policy (idle-count read, Fig. 6 remainder-spread chunking,
re-probing serial fallback) lives in :mod:`repro.sched.policy`; the
thread pool itself is :class:`repro.sched.executors.ThreadExecutor`.
This module only keeps the historical ``DLBCPool`` name and its
``stats`` field shape (``tasks_spawned``/``joins``/``serial_items``/
``parallel_items``) alive for existing callers.

The pool can also run on the adaptive work-stealing substrate
(:class:`repro.sched.executors.WorkStealingExecutor`): ranges start
coarse and split on steal, with the grain decided by the scheduling
policy's :class:`~repro.sched.policy.GrainController` — no grain
arithmetic lives here.  Opt in per call (``stealing=True``) or
process-wide with ``REPRO_POOL_STEALING=1``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from ..sched.executors import ThreadExecutor, WorkStealingExecutor
from ..sched.telemetry import SchedTelemetry

# Old name for the stats record: SchedTelemetry carries the same fields
# (``tasks_spawned`` is an alias of ``spawns``).
PoolStats = SchedTelemetry


class DLBCPool(ThreadExecutor):
    """Deprecated alias of :class:`repro.sched.executors.ThreadExecutor`
    (DLBC is that executor's default policy)."""

    @property
    def stats(self) -> SchedTelemetry:
        return self.telemetry


class StealingPool(WorkStealingExecutor):
    """:class:`DLBCPool` on the adaptive work-stealing substrate: same
    ``run_loop``/policy surface, same ``stats`` shape, but committed
    chunks stay stealable (steal-driven splitting, helping joins)."""

    @property
    def stats(self) -> SchedTelemetry:
        return self.telemetry


_GLOBAL: Optional[Union[DLBCPool, StealingPool]] = None


def global_pool(n_workers: int = 4,
                stealing: Optional[bool] = None
                ) -> Union[DLBCPool, StealingPool]:
    """The process-wide host pool.  ``stealing`` picks the substrate for
    the pool's *creation* (first caller wins); ``None`` defers to the
    ``REPRO_POOL_STEALING`` environment switch."""
    global _GLOBAL
    if _GLOBAL is None:
        if stealing is None:
            stealing = os.environ.get("REPRO_POOL_STEALING", "0") == "1"
        _GLOBAL = StealingPool(n_workers) if stealing else DLBCPool(n_workers)
    return _GLOBAL
