"""95th percentile, over every request whose first generated token came
in the window, of the host time from the client's send to that token
(queue and prefill included)."""

from portbench.lib.serve import p95


def read(run):
    if run.kind != "serve" or not run.window["ttft_s"]:
        return None
    return 1e3 * p95(run.window["ttft_s"])
