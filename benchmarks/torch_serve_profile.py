"""Where a serving step of the port spends its time, on the card.

    PYTHONPATH=src python benchmarks/torch_serve_profile.py [--warmup 8] [--steps 12] [--seed 0]

Runs the serving workload of ``chip_smoke.py`` (granite-moe-1b-a400m at
full width, bf16, random weights from ``--seed``; 16 requests with
128–384-token prompts, 32 new tokens each, 8 slots, 32-token prefill
chunks), lets ``--warmup`` steps pass, then records ``--steps`` steps
under ``torch.profiler`` (CPU and CUDA activity) and prints one JSON line:
wall time of the window, device busy share (sum of device time of all
kernels / wall), host operator calls, kernel launches and stream
synchronisations per step, and the top operators by host self time and
by device time.  Needs
a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def summary(prof, wall_ms: float, steps: int) -> dict:
    """Wall time, device busy share, host operator calls, kernel launches
    and stream synchronisations per step, and the top operators by host
    self time and kernels by device time, of one profiled window."""
    ka = prof.key_averages()
    kernels = [e for e in ka if e.self_device_time_total > 0
               and not e.key.startswith("aten::")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host_ops = sum(e.count for e in ka if e.key.startswith("aten::"))
    syncs = sum(e.count for e in ka if "Synchronize" in e.key)

    def top(events, attr, n=12):
        rows = sorted(events, key=lambda e: getattr(e, attr), reverse=True)
        return [{"name": e.key[:80], "calls": e.count,
                 "ms": getattr(e, attr) / 1e3} for e in rows[:n]]
    return {"wall_ms": wall_ms, "ms_per_step": wall_ms / steps,
            "device_busy_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "host_ops_per_step": host_ops / steps,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "syncs_per_step": syncs / steps,
            "top_host_self": top([e for e in ka if e.key.startswith("aten::")
                                  or "cuda" in e.key], "self_cpu_time_total"),
            "top_device": top(kernels, "self_device_time_total")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.serve.batcher import ContinuousBatcher, Request

    cfg = get_config("granite-moe-1b-a400m")
    params = TM.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    rng = np.random.default_rng(args.seed)
    b = ContinuousBatcher(cfg, params, n_slots=8, cache_len=512,
                          policy="dlbc", prefill_chunk=32, device="cuda")
    for i in range(16):
        b.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(128, 385))).tolist(),
            max_new=32))
    for now in range(args.warmup):
        b.step(now)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for now in range(args.warmup, args.warmup + args.steps):
            b.step(now)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"bench": "torch_serve_profile", "arch": cfg.name,
           "dtype": cfg.dtype, "device": torch.cuda.get_device_name(0),
           "steps": args.steps, **summary(prof, wall_ms, args.steps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
