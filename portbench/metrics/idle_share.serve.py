"""Share of the profiled stretch (host clock, synchronised at both ends)
in which no operation ran on the device, in %."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
