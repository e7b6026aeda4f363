"""Trained tokens of every whole optimizer step completed in the window,
over the time those steps took (host clock, synchronised per step)."""


def read(run):
    if run.kind != "train":
        return None
    return run.window["tokens"] / run.window["seconds"]
