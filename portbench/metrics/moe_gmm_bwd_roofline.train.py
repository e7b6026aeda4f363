"""``moe_gmm``'s backward kernels (``wg_kernel``) against their least
time, in %.  Each backward call (one per layer and microbatch of the
traced steps) is bounded at the rows its forward filled: the routed
pairs the mixture call kept (``lib.routed``; under ``remat`` every call
is recorded twice with the same pairs, so the mean over the records is
the mean over the calls)."""

from portbench.lib import costs
from portbench.lib.readers import durations_s, share


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.routed:
        return None
    m, t = run.model, run.traffic
    per = [costs.bound_s(*costs.moe_gmm_bwd(E, kept, d, m["d_ff"]),
                         m["dtype"])
           for _, E, _, d, kept in run.trace.routed]
    calls = m["n_layers"] * t["microbatches"] * run.trace.steps
    return share(sum(per) / len(per) * calls,
                 durations_s(run.trace.ops, ("wg_kernel",)))
