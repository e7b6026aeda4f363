"""The paper's evaluation ladder (Fig. 12): Serial, UnOpt, UnOpt+AFE, LC,
LC+AFE, DLBC, DCAFE — each as a program→program scheme, plus a one-call
runner that returns the Fig. 10 dynamic counts and Fig. 11/13 metrics."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from .afe import apply_afe
from .dlbc import apply_dcafe, apply_dlbc
from .ir import Program
from .kernels_rtp import RTPKernel, build_kernel
from .lc import apply_lc
from .runtime import CostModel, SimResult, run_program, serial_program


def scheme_unopt(p: Program) -> Program:
    return p


def scheme_serial(p: Program) -> Program:
    return serial_program(p)


def scheme_afe(p: Program) -> Program:
    out, _ = apply_afe(p)
    return out


def scheme_lc(p: Program) -> Program:
    return apply_lc(p)


def scheme_lc_afe(p: Program) -> Program:
    out, _ = apply_afe(apply_lc(p))
    return out


def scheme_dlbc(p: Program) -> Program:
    return apply_dlbc(p)


def scheme_dcafe(p: Program) -> Program:
    out, _ = apply_dcafe(p)
    return out


SCHEMES: Dict[str, Callable[[Program], Program]] = {
    "Serial": scheme_serial,
    "UnOpt": scheme_unopt,
    "UnOpt+AFE": scheme_afe,
    "LC": scheme_lc,
    "LC+AFE": scheme_lc_afe,
    "DLBC": scheme_dlbc,
    "DCAFE": scheme_dcafe,
}


@dataclass
class SchemeRun:
    kernel: str
    scheme: str
    workers: int
    time: float
    energy: float
    asyncs: int
    finishes: int
    barriers: int
    ok: bool
    result: dict

    def row(self):
        return dict(kernel=self.kernel, scheme=self.scheme,
                    workers=self.workers, time=round(self.time, 2),
                    energy=round(self.energy, 2), asyncs=self.asyncs,
                    finishes=self.finishes, ok=self.ok)

    def sched_summary(self) -> dict:
        """The run's Fig. 10 counts in the shared ``repro.sched`` counter
        vocabulary (spawns/joins), comparable across the simulator, the
        host pools, and the serving batcher."""
        return dict(spawns=self.asyncs, joins=self.finishes,
                    barriers=self.barriers)


def run_scheme(kernel: RTPKernel, scheme: str, workers: int = 4,
               cost_model: Optional[CostModel] = None,
               max_events: int = 50_000_000) -> SchemeRun:
    prog = SCHEMES[scheme](kernel.program)
    res: SimResult = run_program(
        prog, n_workers=(1 if scheme == "Serial" else workers),
        heap=kernel.fresh_heap(), cost_model=cost_model,
        max_events=max_events,
    )
    got = kernel.extract(res.heap)
    want = {k: v for k, v in kernel.expected().items()
            if k in kernel.result_keys}
    ok = res.ok and got == want
    return SchemeRun(
        kernel=kernel.name, scheme=scheme, workers=workers, time=res.time,
        energy=res.energy, asyncs=res.counters.asyncs,
        finishes=res.counters.finishes, barriers=res.counters.barriers,
        ok=ok, result=got,
    )
