"""The ``serve_closed`` kind: a closed loop of clients on the port's
batcher (``lib.serve``); what decides ``correct`` is
``lib.check_serve``."""

from __future__ import annotations

import time
from types import SimpleNamespace


def run(cell, seed, seconds, trace, device, t_start):
    from torch.profiler import record_function

    from repro_torch.models import model as MDL

    from ..lib import check_serve, device as D, routed, trace as T
    from ..lib.serve import Server

    srv = Server(cell, seed, device)
    for _ in range(cell.traffic["warmup_steps"]):
        srv.step()
    D.sync()
    setup_s = time.perf_counter() - t_start
    D.reset_peak()
    win = srv.window(seconds)
    peak = D.peak_bytes()
    tt = None
    if trace:
        prefill, decode = MDL.prefill_step, MDL.decode_step
        now = [None]

        def spans(name, fn):
            def wrapped(*a, **k):
                now[0] = name
                try:
                    with record_function(name):
                        return fn(*a, **k)
                finally:
                    now[0] = None
            return wrapped
        MDL.prefill_step = spans("pb.prefill", prefill)
        MDL.decode_step = spans("pb.decode", decode)
        try:
            with routed.recording(lambda: now[0]) as calls:
                tt = T.record(lambda _: srv.step(),
                              cell.traffic["trace_steps"])
            tt.routed = routed.counted(calls)
            del calls
        finally:
            MDL.prefill_step, MDL.decode_step = prefill, decode
    chk = cell.traffic["check"]
    reqs = check_serve.sample(win["finished"], seed, chk["served_tokens"])
    srv.free()
    del srv
    D.free()
    got = check_serve.gaps(cell.config["model"], seed, reqs, device)
    # a window that finished nothing has served nothing to check
    numbers = {"logit_gap": got.get("served", float("inf")),
               "mean_logit_gap": got.get("served_mean", float("inf")),
               "failed_requests": win["failed"]}
    return SimpleNamespace(kind="serve", setup_s=setup_s, window=win,
                           trace=tt, peak=peak, numbers=numbers,
                           attempted=len(win["finished"]) + win["failed"],
                           failed=win["failed"],
                           detail={"setup_s": setup_s,
                                   "window_steps": win["steps"],
                                   "ttft_samples": len(win["ttft_s"]),
                                   "itl_samples": len(win["itl_s"]),
                                   "checked_tokens": got["tokens"],
                                   "checked_requests": got["requests"]})


def calibrate(cell, seed, args, device) -> list:
    """``--program`` serves the cell's own load (its warm-up and
    ``--seconds`` of window) and reads the logit gaps of the sampled
    served tokens; ``--control`` reads, on the same sample, the gaps of
    the tokens the float8 reference puts first; ``--faults`` alters one
    served token of the sample where it was produced."""
    import numpy as np

    from ..lib import check_serve as CS, device as D
    from ..lib.serve import Server
    from ..reference.decoder import fp8_quant

    model = cell.config["model"]
    srv = Server(cell, seed, device)
    for _ in range(cell.traffic["warmup_steps"]):
        srv.step()
    win = srv.window(args.seconds)
    reqs = CS.sample(win["finished"], seed,
                     cell.traffic["check"]["served_tokens"])
    srv.free()
    del srv
    D.free()
    out = []
    got = CS.gaps(model, seed, reqs, device,
                  quant=fp8_quant if args.control else None)
    for what, key in (("program", "served"), ("control", "control")):
        if key in got and (args.program or what == "control"):
            out.append((what, {"logit_gap": got[key],
                               "mean_logit_gap": got[key + "_mean"],
                               "flips": got[key + "_flips"],
                               "tokens": got["tokens"]}))
    if args.faults and reqs:
        rng = np.random.Generator(np.random.PCG64(seed + 3))
        prompt, served = reqs[0]
        j = len(served) // 2
        served = list(served)
        served[j] = int(rng.integers(0, model["vocab"]))
        bad = CS.gaps(model, seed, [(prompt, served)] + reqs[1:], device)
        out.append(("fault_token", {"logit_gap": bad["served"],
                                    "mean_logit_gap": bad["served_mean"]}))
    return out
