"""Device time of one ``decode_step`` launch: the device operations inside
the harness's ``pb.decode`` ranges of the profiled stretch, summed, over
the number of launches."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    spans = run.trace.in_span("pb.decode")
    if not spans or not any(spans):
        return None
    return 1e3 * sum((b - a) * 1e-6 for ops in spans for _, a, b in ops) \
        / len(spans)
