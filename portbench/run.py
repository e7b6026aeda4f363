"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines
on standard error).  In order: load the cell, make the weights on the
card from ``--seed``, reuse the kernels nvcc built in
``build/repro_torch_kernels/`` of this checkout (built on the first run),
warm only the cell's shapes, measure for ``--seconds``, check what the
timed path produced against the plain reference (``portbench/reference``),
print.  ``--trace 0`` reports the cell's end-to-end metrics; ``--trace
1`` measures the same window unprofiled, then profiles a short stretch
of whole steps, and reports the cell's per-layer metrics, each read by
its own file under ``portbench/metrics``.  How a run drives the program
is its traffic kind's (``portbench/kinds/<kind>.py``).

Exits non-zero and prints no result without a card, with fewer cards
than the cell asks for, or when JAX or the JAX package ``repro`` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches inside this checkout at fixed paths; the program's source
    and the harness importable; no JAX behind any library."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Modules whose top-level name (the part before the first dot), taken
    whole, is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _device(trace) -> dict:
    import torch

    from portbench.lib.device import on_card
    out = {"platform": "gpu" if on_card() else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card() else "cpu",
           "count": 1}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def run_cell(cell, seed: int, seconds: float, trace: int,
             device="cuda") -> tuple:
    """``(result, check_lines)`` of one run of ``cell``."""
    from portbench.lib.cell import kind, reader

    limits = cell.limits
    run = kind(cell.traffic["kind"]).run(cell, seed, seconds, trace, device,
                                         T_START)
    run.cell, run.model, run.traffic = cell, cell.config["model"], \
        cell.traffic
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in run.numbers.items() if k in limits}
    run.detail.update({f"not compared {k}": v
                       for k, v in run.numbers.items() if k not in limits})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": dict(_device(run.trace),
                             memory_peak_bytes=run.peak)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    lines = [f"{k}: {v}" for k, v in run.detail.items()]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench.lib.cell import load

    cell = load(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
