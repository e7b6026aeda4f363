"""Readings that set a cell's limits: the program's, the control's and the
planted faults', seed by seed, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control] [--faults] [--program] [--seconds 20]

``--program`` reads the program's run against the reference,
``--control`` the reference computed a precision lower (float8:
``fp8_quant`` of ``reference.decoder``) in the program's place,
``--faults`` the faults the comparison has to catch; what each means for
a traffic kind is its ``calibrate`` (``portbench/kinds/<kind>.py``).
Prints one JSON line per seed and reading.  Not run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        sys.path.insert(0, p)
    import torch

    from portbench.lib.cell import kind, load

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load(args.workload)
    fn = kind(cell.traffic["kind"]).calibrate
    for seed in [int(s) for s in args.seeds.split(",")]:
        for what, got in fn(cell, seed, args, "cuda"):
            got = {k: ({n: float(f"{x:.3g}") for n, x in v.items()}
                       if isinstance(v, dict) else v) for k, v in got.items()}
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": what, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
