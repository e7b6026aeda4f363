"""Recompute the roofline fields of saved dry-run records from their
stored ``OpCost`` (no re-trace):
``python -m repro_torch.roofline.reanalyze [dir]`` (default
``experiments/torch_dryrun``).

Counterpart of ``repro/roofline/reanalyze.py``, which re-parses saved HLO
dumps: a record of :mod:`repro_torch.launch.dryrun` keeps its counted
``cost`` itself, so a change to the roofline's constants or terms
(:mod:`.analysis`) is applied to every record in place.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..configs import SHAPES, get_config
from .analysis import (
    OpCost, model_flops_estimate, roofline_fraction, roofline_from_opcost,
)


def reanalyze(path: Path) -> bool:
    """Rewrite ``path``'s ``roofline`` and ``roofline_fraction`` from its
    ``cost``; False for a record that is not ``ok``."""
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok":
        return False
    terms = roofline_from_opcost(
        OpCost.from_dict(rec["cost"]), chips=rec["chips"],
        model_flops=model_flops_estimate(get_config(rec["arch"]),
                                         SHAPES[rec["shape"]]))
    rec["roofline"] = terms.as_dict()
    rec["roofline_fraction"] = round(roofline_fraction(terms), 4)
    path.write_text(json.dumps(rec, indent=1))
    return True


def main(argv=None):
    d = Path((argv or sys.argv[1:] or ["experiments/torch_dryrun"])[0])
    n = 0
    for f in sorted(d.glob("*.json")):
        if reanalyze(f):
            n += 1
            print("reanalyzed", f.name)
    print(f"done: {n} artifacts")


if __name__ == "__main__":
    main()
