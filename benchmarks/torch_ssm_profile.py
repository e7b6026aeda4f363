"""Where falcon-mamba-7b's forward and decode spend their time, on the card.

    PYTHONPATH=src python -m benchmarks.torch_ssm_profile [--tokens 2048] [--decode-steps 16] [--seed 0]

falcon-mamba-7b at full width and depth (64 layers), bf16, random weights
from ``--seed``: the workload of ``chip_smoke.py``'s ``ssm_bf16`` phase.
Profiles one ``--tokens``-token forward (after one warm-up forward) and
``--decode-steps`` decode steps (after 8 warm-up steps) under
``torch.profiler`` and prints one JSON line per window with
``benchmarks.torch_serve_profile.summary`` (wall, device busy share, host
operator calls, kernel launches and syncs per step, top operators and
kernels), plus the device time per step split into the ``ssm_scan``
kernel, matrix products and everything else.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmarks.torch_serve_profile import summary


def _split(prof, steps: int) -> dict:
    """Device ms per step of the ``ssm_scan`` kernel, of matrix products
    (cuBLAS kernels, named ``nvjet_*``, ``*gemm*`` or ``splitKreduce`` by
    the installed cuBLAS) and of all other kernels."""
    out = {"ssm_scan_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or e.key.startswith("aten::"):
            continue
        name = e.key.lower()
        key = "ssm_scan_ms" if "ssm_scan" in name else "matmul_ms" \
            if any(w in name for w in ("gemm", "gemv", "nvjet", "splitk")) \
            else "other_ms"
        out[key] += e.self_device_time_total / 1e3 / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ssm_profile: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    cfg = get_config("falcon-mamba-7b")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = TM.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, args.tokens), generator=gen,
                         device="cuda")
    cache = TM.init_cache(cfg, 1, 64, device="cuda")

    def forward():
        TM.forward(params, cfg, {"tokens": toks}, last_only=True)

    def decode(t):
        TM.decode_step(params, cfg, cache, {
            "tokens": toks[:, t:t + 1],
            "cache_index": torch.tensor(t, device="cuda")})

    forward()
    for t in range(8):
        decode(t)
    for name, steps, run in (
            ("forward", 1, forward),
            ("decode", args.decode_steps,
             lambda: [decode(t) for t in range(8, 8 + args.decode_steps)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({
            "bench": "torch_ssm_profile", "window": name, "arch": cfg.name,
            "dtype": cfg.dtype, "device": torch.cuda.get_device_name(0),
            "tokens": args.tokens if name == "forward" else 1,
            "steps": steps, **summary(prof, wall_ms, steps),
            **_split(prof, steps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
