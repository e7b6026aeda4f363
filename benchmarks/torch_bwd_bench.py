"""Time the port's two training backward kernels on the card.

    PYTHONPATH=src python -m benchmarks.torch_bwd_bench [--src DIR] [--seed 0]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two checkouts can be timed in turn on one card, each in its own
process (for example parent, change, change, parent).  With random inputs
from ``--seed`` it times, with CUDA events (mean of 20 calls after 3
warm-up calls):

- ``moe_gmm_bwd`` at granite-moe-1b-a400m's expert shape (E 32, d 1024,
  f 512): C 8 and C 1280 (a training microbatch) in bf16, C 1280 in fp32
  (3xTF32), beside the backward of the ``torch.bmm`` chain on the same
  inputs (forward and backward less forward; library, timed only), and
  the device time of each of its kernels from ``torch.profiler`` (which
  of the four GEMMs sets the pace);
- ``ssm_scan_bwd`` at hymba-1.5b's chunk (B 1, L 256, Di 3200, N 16) and
  falcon-mamba-7b's (Di 8192), from a zero state with no ``dh_last`` and
  from a carried state with one.

Each result is first checked against the plain version (moe: each
gradient within 2e-2 (bf16) or 1e-4 (fp32) of its largest autograd
value; ssm: within 1e-5 of ``ssm_scan_bwd_ref``'s).  Prints one JSON line
per row, with the card's name and power limit on each, and the bound
(bytes each read and written once over 3.35 TB/s, or FLOPs over 989
TFLOP/s bf16 / 3 × over 495 TF32).  Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BPS = 3.35e12


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def kernel_times(torch, fn, calls: int = 5) -> dict:
    """Device µs per call of each CUDA kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if t > 0:
            out[evt.key[:120]] = t / calls
    return out


def bench_moe(torch, args, card: str) -> None:
    from repro_torch.kernels.moe_dispatch import moe_gmm as MG
    from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref

    E, d, f = 32, 1024, 512
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for dtype, C in (("bfloat16", 8), ("bfloat16", 1280), ("float32", 1280)):
        dt = getattr(torch, dtype)
        w1, w3 = ((torch.randn(E, d, f, generator=gen, device="cuda")
                   * d ** -0.5).to(dt) for _ in range(2))
        w2 = (torch.randn(E, f, d, generator=gen, device="cuda")
              * f ** -0.5).to(dt)
        buf = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
        dout = torch.randn(E, C, d, generator=gen, device="cuda").to(dt)
        got = MG.moe_gmm_bwd(buf, w1, w3, w2, dout)
        ref_in = [t.float().requires_grad_(True) for t in (buf, w1, w3, w2)]
        ref = torch.autograd.grad(moe_gmm_ref(*ref_in).float(), ref_in,
                                  dout.float())
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        rel = {}
        for name, g, r in zip(("dbuf", "dw1", "dw3", "dw2"), got, ref):
            r = r.to(dt).float()
            rel[name] = float((g.float() - r).abs().max()) / float(
                r.abs().max())
            if rel[name] > tol:
                raise AssertionError(f"moe_gmm_bwd C={C} {dtype}: {name} "
                                     f"{rel[name]} beyond {tol}")
        del ref_in, ref
        lib_in = [t.detach().requires_grad_(True) for t in (buf, w1, w3, w2)]
        h = torch.nn.functional.silu(torch.bmm(lib_in[0], lib_in[1])) \
            * torch.bmm(lib_in[0], lib_in[2])
        lib_out = torch.bmm(h, lib_in[3])
        flops = 16 * E * C * d * f
        nbytes = (3 * E * C * d + 6 * E * d * f) * buf.element_size()
        t_ops = (3 * flops / 495e12 if dtype == "float32"
                 else flops / 989e12) * 1e3
        t_bytes = nbytes / HBM_BPS * 1e3
        row = {"kernel": "moe_gmm_bwd", "E": E, "C": C, "d": d, "f": f,
               "dtype": dtype, "src": args.src, "card": card,
               "err_over_max_ref": rel,
               "kernel_ms": time_ms(torch, lambda: MG.moe_gmm_bwd(
                   buf, w1, w3, w2, dout)),
               "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                   lib_out, lib_in, dout, retain_graph=True)),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "per_launch_us": kernel_times(torch, lambda: MG.moe_gmm_bwd(
                   buf, w1, w3, w2, dout))}
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        print(json.dumps(row), flush=True)
        del buf, dout, w1, w3, w2, got, lib_in, lib_out, h
        torch.cuda.empty_cache()


def bench_ssm(torch, args, card: str) -> None:
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for what, B, L, Di, N in (("hymba chunk", 1, 256, 3200, 16),
                              ("falcon chunk", 1, 256, 8192, 16)):
        dA = torch.rand(B, L, Di, N, generator=gen, device="cuda") * 0.5 + 0.5
        dBx = torch.randn(B, L, Di, N, generator=gen, device="cuda") * 0.1
        C = torch.randn(B, L, N, generator=gen, device="cuda")
        dy = torch.randn(B, L, Di, generator=gen, device="cuda")
        h0 = torch.randn(B, Di, N, generator=gen, device="cuda")
        dh = torch.randn(B, Di, N, generator=gen, device="cuda")
        for carried in (False, True):
            h, g = (h0, dh) if carried else (None, None)
            got = SS.ssm_scan_bwd(dA, dBx, C, h, dy, g)
            ref = ssm_scan_bwd_ref(dA, dBx, C, h, dy, g)
            for x, r in zip(got, ref):
                if x is not None:
                    e = float((x - r).abs().max())
                    if e > 1e-5 * float(r.abs().max()):
                        raise AssertionError(f"ssm_scan_bwd {what}: {e}")
            state = B * L * Di * N
            nbytes = 4 * (4 * state + 2 * B * L * N + B * L * Di
                          + (3 * B * Di * N if carried else 0))
            row = {"kernel": "ssm_scan_bwd", "shape": what, "B": B, "L": L,
                   "Di": Di, "N": N, "h0_and_dh_last": carried,
                   "src": args.src, "card": card,
                   "kernel_ms": time_ms(torch, lambda: SS.ssm_scan_bwd(
                       dA, dBx, C, h, dy, g)),
                   "bound_ms": nbytes / HBM_BPS * 1e3, "bound_by": "bytes",
                   "per_launch_us": kernel_times(torch, lambda: SS.ssm_scan_bwd(
                       dA, dBx, C, h, dy, g))}
            print(json.dumps(row), flush=True)
            del got, ref
        del dA, dBx, C, dy, h0, dh
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_bench: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all(["moe_gmm", "ssm_scan"])
    bench_moe(torch, args, card)
    bench_ssm(torch, args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
