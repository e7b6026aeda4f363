"""DCAFE paper core: async-finish task IR, AFE + LC + DLBC transformations,
exception extensions, and the deterministic multi-worker runtime simulator.

Public API:

    from repro.core import (
        ir, analysis, transforms, afe, lc, dlbc, runtime, schemes,
        kernels_rtp,
    )
    prog_dcafe, report = dlbc.apply_dcafe(prog)
    result = runtime.run_program(prog_dcafe, n_workers=16, heap=...)
"""

from . import analysis, errors, ir, runtime  # noqa: F401
from .afe import AFEReport, apply_afe  # noqa: F401
from .dlbc import apply_dcafe, apply_dlbc  # noqa: F401
from .kernels_rtp import KERNELS, RTPKernel, build_kernel  # noqa: F401
from .lc import apply_lc  # noqa: F401
from .runtime import CostModel, SimResult, run_program  # noqa: F401
from .schemes import SCHEMES, SchemeRun, run_scheme  # noqa: F401
