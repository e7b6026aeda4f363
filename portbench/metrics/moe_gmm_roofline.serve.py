"""``moe_gmm``'s forward kernels (``gmm_kernel``, ``split_sum_kernel``)
inside the profiled ``prefill_step`` and ``decode_step`` launches against
their least time, in %: each mixture call of those launches bounded at
the routed pairs it kept (``lib.routed``), padded lanes included where
the program routes them."""

from portbench.lib import costs
from portbench.lib.readers import durations_s, share

NAMES = ("gmm_kernel", "split_sum_kernel")
SPANS = ("pb.prefill", "pb.decode")


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.routed:
        return None
    m = run.model
    bound = sum(costs.bound_s(*costs.moe_gmm(E, kept, d, m["d_ff"]),
                              m["dtype"])
                for span, E, _, d, kept in run.trace.routed if span in SPANS)
    measured = sum(durations_s(ops, NAMES) for span in SPANS
                   for ops in run.trace.in_span(span))
    return share(bound, measured)
