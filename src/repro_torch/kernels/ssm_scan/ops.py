"""What the model calls for the selective scan.

The reference's ``ops.py`` jits the Pallas kernel and picks interpret
mode off the TPU; here the wrapper itself picks the plain version for CPU
tensors and the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from .ssm_scan import ssm_scan


def ssm_scan_op(dA, dBx, C, h0=None):
    """``(y, h_last)`` from the state ``h0`` (``None`` = zero): one chunk
    of the model's chained scan."""
    return ssm_scan(dA, dBx, C, h0)


def ssm_scan_auto(dA, dBx, C):
    """The reference's function: zero initial state, ``y`` only."""
    return ssm_scan(dA, dBx, C)[0]
