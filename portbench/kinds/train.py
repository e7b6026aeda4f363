"""The ``train`` kind: the port's train step, built once, driven from the
seed through its checked steps (set-up) and then the window
(``lib.train``); what decides ``correct`` is ``lib.check_train``."""

from __future__ import annotations

import time
from types import SimpleNamespace


def run(cell, seed, seconds, trace, device, t_start):
    from torch.profiler import record_function

    from ..lib import check_train, device as D, routed, trace as T
    from ..lib.train import Trainer

    tr = Trainer(cell, seed, device)
    rec = tr.checked_steps()
    D.sync()
    setup_s = time.perf_counter() - t_start
    D.reset_peak()
    win = tr.window(seconds)
    peak = D.peak_bytes()
    tt = None
    if trace:
        def one(_):
            with record_function("pb.step"):
                tr.step()
        with routed.recording() as calls:
            tt = T.record(one, cell.traffic["trace_steps"])
        tt.routed = routed.counted(calls)
        del calls
    skipped = int(sum(int(s) for s in tr.skipped))
    tr.free()
    del tr
    D.free()
    ref = check_train.reference_steps(cell.config["model"], cell.traffic,
                                      seed, device)
    got = check_train.compare(rec, ref)
    numbers = {k: got[k] for k in ("loss", "grad", "grad_median", "change",
                                    "change_median")}
    numbers["skipped_steps"] = skipped
    return SimpleNamespace(kind="train", setup_s=setup_s, window=win,
                           trace=tt, peak=peak, numbers=numbers,
                           attempted=win["steps"], failed=win["skipped"],
                           detail={"setup_s": setup_s,
                                   "window_steps": win["steps"],
                                   "grad_leaf": got["grad_leaf"],
                                   "change_leaf": got["change_leaf"]})


def calibrate(cell, seed, args, device) -> list:
    """``--program``: the program's set-up (its checked steps) against the
    reference; ``--control``: the reference computed a precision lower
    (float8, ``fp8_quant``) in the program's place; ``--faults``: the
    reference with half of each batch left out (the mean over the rest)
    there.  A step that returns its state unchanged reads 1 on ``grad``
    and ``change`` by construction and needs no run."""
    from ..lib import check_train as CT, device as D
    from ..lib.train import Trainer
    from ..reference.decoder import fp8_quant

    model, traffic = cell.config["model"], cell.traffic
    out = []
    prog = None
    if args.program:
        tr = Trainer(cell, seed, device)
        prog = tr.checked_steps()
        tr.free()
        del tr
        D.free()
    ref = CT.reference_steps(model, traffic, seed, device)
    D.free()
    if prog is not None:
        out.append(("program", CT.compare(prog, ref)))
    if args.control:
        low = CT.reference_steps(model, traffic, seed, device,
                                 quant=fp8_quant)
        out.append(("control", CT.compare(low, ref)))
        D.free()
    if args.faults:
        half = CT.reference_steps(model, traffic, seed, device,
                                  fault="half")
        out.append(("fault_half_batch", CT.compare(half, ref)))
        D.free()
    return out
