"""Serving launcher: continuous batching with DLBC slot scheduling, on
the card (the port's copy of ``repro/launch/serve.py``: same flags and
JSON, plus ``--device`` and ``--dtype``).

``python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --requests 16``

Weights are random, drawn from ``--seed`` on the device.

Multi-tenant serving (weighted-DLBC admission over one slot executor):

``python -m repro_torch.launch.serve --arch qwen2.5-32b --smoke --policy wdlbc \\
    --tenants steady,bursty --tenant-weights 3,1 \\
    --tenant-arrivals steady,bursty``

Arrival mixes per tenant: ``steady`` spreads that tenant's requests
uniformly over the trace; ``bursty`` drops them in a few synchronized
bursts; ``front`` queues everything at step 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import DTYPES, resolve_device
from ..models import model as MDL
from ..serve.batcher import ContinuousBatcher, Request

ARRIVAL_MIXES = ("steady", "bursty", "front")


def make_arrivals(mix: str, n: int, horizon: int, rng) -> list:
    """Arrival steps for one tenant's ``n`` requests over ``horizon``."""
    if mix == "front":
        return [0] * n
    if mix == "steady":
        gap = max(1, horizon // max(1, n))
        return [i * gap for i in range(n)]
    if mix == "bursty":
        n_bursts = max(1, min(4, n // 4))
        starts = sorted(int(rng.integers(0, max(1, horizon)))
                        for _ in range(n_bursts))
        return [starts[i % n_bursts] for i in range(n)]
    raise ValueError(f"unknown arrival mix {mix!r} "
                     f"(choose from {ARRIVAL_MIXES})")


def build_requests(args, cfg, rng) -> tuple:
    """(requests, tenants-weight-map-or-None) from the CLI flags."""
    if args.cache_len < 10:
        raise SystemExit("--cache-len must be >= 10 (max_new is sampled "
                         "from [4, cache_len // 2))")

    def request(rid, arrive_step, tenant="default"):
        # draw order (prompt, max_new, then arrive) matches the original
        # single-queue generator so a given --seed reproduces the same
        # trace it always did
        prompt = list(rng.integers(0, cfg.vocab, size=4))
        max_new = int(rng.integers(4, args.cache_len // 2))
        if arrive_step is None:
            arrive_step = int(rid * rng.integers(0, 3))
        return Request(rid=rid, prompt=prompt, max_new=max_new,
                       arrive_step=arrive_step, tenant=tenant)

    if not args.tenants:
        return [request(i, None) for i in range(args.requests)], None
    names = [t.strip() for t in args.tenants.split(",") if t.strip()]
    weights = ([float(w) for w in args.tenant_weights.split(",")]
               if args.tenant_weights else [1.0] * len(names))
    if len(weights) != len(names):
        raise SystemExit("--tenant-weights must match --tenants")
    mixes = ([m.strip() for m in args.tenant_arrivals.split(",")]
             if args.tenant_arrivals else ["steady"] * len(names))
    if len(mixes) != len(names):
        raise SystemExit("--tenant-arrivals must match --tenants")
    horizon = max(8, args.requests * 2)
    reqs, rid = [], 0
    for name, mix in zip(names, mixes):
        for step in make_arrivals(mix, args.requests, horizon, rng):
            reqs.append(request(rid, step, tenant=name))
            rid += 1
    return reqs, dict(zip(names, weights))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests total (single queue) or per tenant")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--policy", default="dlbc",
                    choices=("dlbc", "lc", "wdlbc"))
    ap.add_argument("--tenants", default=None,
                    help="comma-separated tenant names (enables "
                         "multi-tenant admission)")
    ap.add_argument("--tenant-weights", default=None,
                    help="comma-separated weights matching --tenants")
    ap.add_argument("--tenant-arrivals", default=None,
                    help=f"per-tenant arrival mix {ARRIVAL_MIXES}, "
                         "matching --tenants")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="override the config's parameter/cache dtype")
    ap.add_argument("--telemetry-json", default=None,
                    help="also dump the slot-scheduler telemetry here")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record an obs span trace of the run and write "
                         "Chrome trace-event JSON here (Perfetto-loadable)")
    ap.add_argument("--metrics-json", default=None, metavar="OUT.jsonl",
                    help="stream windowed metrics-registry snapshots "
                         "(JSON lines, one delta per interval) here")
    ap.add_argument("--metrics-interval", type=float, default=0.5,
                    help="snapshot interval in seconds for --metrics-json")
    args = ap.parse_args(argv)

    if args.trace:
        from ..obs import trace as obs_trace
        obs_trace.enable()
    snapshotter = None
    if args.metrics_json:
        from ..obs.metrics import Snapshotter
        snapshotter = Snapshotter(interval_s=args.metrics_interval,
                                  path=args.metrics_json)
        snapshotter.start()

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = MDL.init_params(cfg, gen, device=device)
    rng = np.random.default_rng(args.seed)
    reqs, tenants = build_requests(args, cfg, rng)
    batcher = ContinuousBatcher(cfg, params, n_slots=args.slots,
                                cache_len=args.cache_len,
                                policy=args.policy, tenants=tenants,
                                device=device)
    try:
        stats = batcher.run(reqs)
    finally:
        if snapshotter is not None:
            snapshotter.stop()
    # Fig. 10-comparable spawn/join telemetry from the slot scheduler
    telemetry = batcher.sched.telemetry.summary()
    out = {
        "arch": cfg.name, "policy": batcher.policy, "steps": stats.steps,
        "utilization": round(stats.utilization, 3),
        "mean_latency_steps": float(np.mean(stats.latencies)),
        "p99_latency_steps": float(np.percentile(stats.latencies, 99)),
        "mean_queue_wait": float(np.mean(stats.queue_waits)),
        "sched": telemetry,
    }
    if batcher.tenant_stats:
        out["tenants"] = {name: st.summary()
                          for name, st in sorted(batcher.tenant_stats.items())}
        out["slot_shares"] = batcher.slot_shares()
    print(json.dumps(out, indent=1))
    if args.telemetry_json:
        with open(args.telemetry_json, "w") as f:
            json.dump({"serve_slots": telemetry}, f, indent=1)
    if args.trace:
        from ..obs import export as obs_export
        doc = obs_export.write_chrome_trace(
            args.trace, extra={"telemetry": telemetry})
        check = obs_export.crosscheck(doc, telemetry)
        print(f"[trace written to {args.trace}; "
              f"crosscheck ok={check['ok']}]")
    return out


if __name__ == "__main__":
    main()
