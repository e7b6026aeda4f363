"""What the per-layer metrics' files share: the device operations of the
traced stretch by kernel name, and a kernel's least time per traced step
from ``lib.costs`` at the cell's shapes."""

from __future__ import annotations

from . import costs


def durations_s(ops, names) -> float:
    """Seconds of the device operations whose name holds one of
    ``names``."""
    return sum(b - a for n, a, b in ops if any(k in n for k in names)) \
        * 1e-6


def share(bound_s: float, measured_s: float):
    """A roofline share in %, or None where the kernel did not run."""
    return 100.0 * bound_s / measured_s if measured_s > 0 else None


def launches(ops) -> int:
    """Kernels among the device operations (copies and sets left out)."""
    return sum(1 for n, _, _ in ops
               if not n.startswith(("Memcpy", "Memset")))


def train_roofline(run, names, cost):
    """Share of the least time of ``cost(model, traffic, b)`` (one call at
    microbatch ``b``: (flops, bytes), at the model dtype's peak) times the
    traced steps' calls (one per layer and microbatch), in the measured
    time of the kernels named ``names``."""
    if run.trace is None:
        return None
    m, t = run.model, run.traffic
    b = t["global_batch"] // t["microbatches"]
    calls = m["n_layers"] * t["microbatches"] * run.trace.steps
    bound = costs.bound_s(*cost(m, t, b), m["dtype"]) * calls
    return share(bound, durations_s(run.trace.ops, names))
