"""Kernels launched on the device per step, counted in the profiled
stretch (copies and sets left out)."""

from portbench.lib.readers import launches


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.ops:
        return None
    return launches(run.trace.ops) / run.trace.steps
