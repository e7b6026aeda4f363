"""Where a training step of the port spends its time, on the card.

    PYTHONPATH=src python -m benchmarks.torch_train_profile [--arch granite-moe-1b-a400m | hymba-1.5b | whisper-medium] [--warmup 1] [--steps 2] [--seed 0]

Runs a training step of ``chip_smoke.py`` at full width, bf16, random
weights from ``--seed``, policy ``afe``, sched policy ``dlbc``, AdamW:
granite-moe-1b-a400m (the default) at seq 1024 and global batch 8 in 2
microbatches, or ``--arch hymba-1.5b`` at seq 1024 and global batch 8 in
8 microbatches of one sequence (its fp32 scan tensors leave no room for
two), or ``--arch whisper-medium`` at seq 448 (Whisper's decoder context,
with seeded 1500-frame encoder inputs) and global batch 8 in 2
microbatches; lets
``--warmup`` steps pass, then records ``--steps`` steps under
``torch.profiler`` (CPU and CUDA activity) and prints one JSON line: the
wall time of the window, the device busy share, host operator calls and
kernel launches per step, the top operators by host self time and by
device time, and the device time and launches per step of each of the
port's kernels (every template instance by its name).  A second
window of the same steps without the profiler gives the step time the
profiler does not slow.  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType

#: the port's hand-written kernels, by the names their launches carry
PORT_KERNELS = ("attn_tc_kernel", "attn_kernel", "attn_bwd_dq",
                "attn_bwd_dkv", "gmm_kernel", "wg_kernel", "split_sum_kernel",
                "ssm_scan")
#: microbatches of the global batch of 8 sequences, per architecture
MICROBATCHES = {"granite-moe-1b-a400m": 2, "hymba-1.5b": 8,
                "whisper-medium": 2}
#: sequence length per architecture where it is not 1024
SEQ_LEN = {"whisper-medium": 448}


def summary(prof, wall_ms: float, steps: int) -> dict:
    """Wall time, device busy share, host operator calls, kernel launches
    and stream synchronisations per step, and the top operators by host
    self time and kernels by device time, of one profiled window.  As
    ``torch_serve_profile.summary``, except that a kernel is an event of
    the device itself: under autograd the backward's nodes carry their
    kernels' device time too, and counting them would count it twice."""
    ka = prof.key_averages()
    kernels = [e for e in ka if e.self_device_time_total > 0
               and e.device_type == DeviceType.CUDA]
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
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=sorted(MICROBATCHES))
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import train_setup
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    step, params, opt, batch, shape = train_setup(
        torch, cfg, args.seed, seq_len=SEQ_LEN.get(args.arch, 1024),
        microbatches=MICROBATCHES[args.arch])
    for _ in range(args.warmup):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    port = {e.key[:120]: {"ms": e.self_device_time_total / 1e3 / args.steps,
                          "launches": e.count / args.steps}
            for e in prof.key_averages()
            if e.self_device_time_total > 0
            and any(k in e.key for k in PORT_KERNELS)}
    out = {"bench": "torch_train_profile", "arch": cfg.name,
           "dtype": cfg.dtype, "device": torch.cuda.get_device_name(0),
           "tokens_per_step": shape.global_batch * shape.seq_len,
           "steps": args.steps,
           "step_ms_unprofiled": plain_ms,
           "port_kernels_per_step": port,
           **summary(prof, wall_ms, args.steps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
