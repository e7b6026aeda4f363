"""Seconds from the process's start to the start of the window: weights
made on the card, kernels loaded (built on a checkout's first run), the
cell's shapes warmed."""


def read(run):
    return run.setup_s
