"""Mean host time from the train step's call to its return, before the
synchronise, over the unprofiled window's steps."""


def read(run):
    e = run.window.get("enqueue_s") if run.kind == "train" else None
    return 1e3 * sum(e) / len(e) if e else None
