"""Where the kernel wrappers and the counted collectives report their
costs while an op counter (:class:`~.op_counter.OpCounter`) is active.

A plain module-level list, not a thread-local: the autograd engine may
run a backward, and with it the backward kernels' and collectives'
reports, on another thread than the one that entered the counter.
Without an active counter each report is one truth test of an empty
list.
"""

from __future__ import annotations

_SINKS: list = []


def kernel(name: str, flops: float, nbytes: float) -> None:
    """One call of kernel ``name`` that would do ``flops`` operations and
    move ``nbytes`` bytes (each input read once, each output written
    once)."""
    for s in _SINKS:
        s.on_kernel(name, flops, nbytes)


def collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` whose result is ``nbytes`` bytes."""
    for s in _SINKS:
        s.on_collective(kind, nbytes)


def push(sink) -> None:
    _SINKS.append(sink)


def pop(sink) -> None:
    _SINKS.remove(sink)
