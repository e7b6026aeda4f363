"""Time the port's ``moe_gmm`` on the card at the shapes its paths launch.

    PYTHONPATH=src python -m benchmarks.torch_moe_gmm_bench [--src DIR] [--plans] [--seed 0]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so that two checkouts can be timed in turn on one card, each
in its own process (for example parent, change, change, parent).  At
granite-moe-1b-a400m's expert shape (E 32, d 1024, f 512; C 8, 80 and
256) and mixtral-8x7b's (E 8, d 4096, f 14336; C 8 and 160 in bf16, 64
in fp32), with random inputs from ``--seed``, it times ``moe_gmm`` with
CUDA events (mean of 20 calls after 2 warm-up calls) and checks it
against the plain version at the reference's tolerance (5 × 2e-2 bf16,
5 × 2e-5 fp32).  ``--plans`` also times every C tile the kernels are
built for at each shape (``launch_plan``'s alternatives, with the down
kernel's K splits as the plan sets them; fp32 up to 64 rows), which is
how the plan's choice of tile is measured.  Prints one JSON line per
row, the card's name and power limit on each.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROWS = (
    ("granite-moe-1b-a400m", (32, 1024, 512), "bfloat16", (8, 80, 256)),
    ("granite-moe-1b-a400m", (32, 1024, 512), "float32", (8, 80, 256)),
    ("mixtral-8x7b", (8, 4096, 14336), "bfloat16", (8, 160)),
    ("mixtral-8x7b", (8, 4096, 14336), "float32", (64,)),
)


def time_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_gmm_bench: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["moe_gmm"])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for arch, (E, d, f), dtype, caps in ROWS:
        dt = getattr(torch, dtype)
        w1 = (torch.randn(E, d, f, generator=gen, device="cuda")
              * d ** -0.5).to(dt)
        w3 = (torch.randn(E, d, f, generator=gen, device="cuda")
              * d ** -0.5).to(dt)
        w2 = (torch.randn(E, f, d, generator=gen, device="cuda")
              * f ** -0.5).to(dt)
        tol = (2e-2 if dtype == "bfloat16" else 2e-5) * 5
        for C in caps:
            buf = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
            ref = moe_gmm_ref(buf, w1, w3, w2).float()
            out = MG.moe_gmm(buf, w1, w3, w2)
            torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
            row = {"arch": arch, "E": E, "C": C, "d": d, "f": f,
                   "dtype": dtype, "src": args.src, "card": card,
                   "max_abs_err": float((out.float() - ref).abs().max()),
                   "kernel_ms": time_ms(torch, lambda: MG.moe_gmm(
                       buf, w1, w3, w2))}
            if args.plans:
                base = MG.launch_plan(E, C, d, f, dt, n_sms)
                code = _build.DTYPE_CODES[str(dt)]
                row["plan_block_m"] = base.down.block_m
                row["by_block_m"] = {}
                for bm, stages in MG.STAGES.items():
                    if bm > 64 and dt == torch.float32:
                        continue          # not built: see ``block_m``
                    g, dn = base
                    plan = MG.LaunchPlan(
                        g._replace(block_m=bm, stages=stages),
                        dn._replace(block_m=bm, stages=stages))
                    o = torch.empty_like(buf)
                    MG.run_plan(buf, w1, w3, w2, o, plan, code)
                    torch.testing.assert_close(o.float(), ref, atol=tol,
                                               rtol=tol)
                    row["by_block_m"][bm] = time_ms(
                        torch, lambda: MG.run_plan(buf, w1, w3, w2, o, plan,
                                                   code))
            print(json.dumps(row), flush=True)
            del buf, out, ref
        del w1, w3, w2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
