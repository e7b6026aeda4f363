"""The (token, choice) pairs that the program's mixture layers keep, call
by call, while the profiled stretch runs.

Read from the admission mask that each call hands to the program's
dispatch (``repro_torch.kernels.moe_dispatch.ops.dispatch_tokens``):
only the reference to it is kept while the stretch runs, so the trace
holds no operation of the harness's; the masks are summed once the
profiler has stopped.  The expert kernels' rooflines count these rows,
not the buffers' E·C slots.  Where the program no longer calls that
function, nothing is recorded and those rooflines are left out.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def recording(tag=lambda: None):
    """Inside: ``calls`` gets ``(tag(), E, C, d, keep)`` of every
    dispatch."""
    calls: list = []
    try:
        from repro_torch.kernels.moe_dispatch import ops
    except ImportError:
        yield calls
        return
    fn = getattr(ops, "dispatch_tokens", None)
    if fn is None:
        yield calls
        return

    def wrapped(x, keep, ids, pos, E, C, *a, **k):
        calls.append((tag(), E, C, x.shape[-1], keep))
        return fn(x, keep, ids, pos, E, C, *a, **k)
    ops.dispatch_tokens = wrapped
    try:
        yield calls
    finally:
        ops.dispatch_tokens = fn


def counted(calls: list) -> list:
    """``(tag, E, C, d, kept pairs)`` of each recorded call."""
    return [(t, E, C, d, int(keep.sum())) for t, E, C, d, keep in calls]
