"""Generated tokens that reached the host in the window, over the unprofiled
window."""


def read(run):
    if run.kind != "serve":
        return None
    return run.window["generated"] / run.window["seconds"]
