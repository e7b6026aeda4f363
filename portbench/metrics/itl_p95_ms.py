"""95th percentile, over every gap between consecutive generated tokens
of a request whose later token came in the window, of the gap."""

from portbench.lib.serve import p95


def read(run):
    if run.kind != "serve" or not run.window["itl_s"]:
        return None
    return 1e3 * p95(run.window["itl_s"])
