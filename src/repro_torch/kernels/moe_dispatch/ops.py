"""MoE dispatch ops: token routing into capacity buffers + expert FFN.

Port of ``repro/kernels/moe_dispatch/ops.py``.  This module owns the
*mechanics* of MoE dispatch — scattering admitted (token, choice) pairs
into per-expert ``(E, C, d)`` capacity buffers, running the expert FFN
(the grouped-matmul kernel by default, einsum on request) and gathering
and combining the results.  The admission decision is the caller's,
through :class:`repro_torch.sched.capacity.ExpertCapacityProvider`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .moe_gmm import moe_gmm


def dispatch_tokens(x, keep, ids, pos, E: int, C: int):
    """Scatter admitted tokens into (E, C, d) buffers.

    ``keep`` is the admission mask from the capacity provider.  A dropped
    pair's clamped slot ``ids*C + C-1`` can coincide with a kept pair's
    slot: the reference adds a zero there, which is harmless, but a
    set-style write is not — so dropped pairs are routed to one spare row
    past the buffer and the spare row is cut off.  Returns (buf, slot) —
    ``slot`` (clamped, as in the reference) is reused by
    :func:`combine_tokens`.
    """
    T, d = x.shape
    K = ids.shape[1]
    slot = ids * C + torch.clamp(pos, max=C - 1)          # (T, K)
    target = torch.where(keep, slot, E * C).reshape(-1)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[target] = x[:, None, :].expand(T, K, d).reshape(T * K, d)
    return buf[:E * C].reshape(E, C, d), slot


def combine_tokens(out, slot, gates, keep, gate_dtype=None):
    """Gather expert outputs back to token order and gate-combine."""
    E, C, d = out.shape
    T, K = slot.shape
    gathered = out.reshape(E * C, d)[slot.reshape(-1)].reshape(T, K, d)
    w = (gates * keep).to(gate_dtype or gathered.dtype)
    return torch.einsum("tkd,tk->td", gathered, w)


def expert_ffn(buf, p: dict, act: str, use_kernel: bool = True):
    """The (E, C, d) × expert-weights contraction.  SwiGLU goes through
    the grouped-matmul kernel (its plain version on CPU tensors) unless
    ``use_kernel=False``, which keeps the reference's einsum path; gelu
    experts always use einsum (the reference has no gelu kernel)."""
    if use_kernel and act == "swiglu":
        return moe_gmm(buf, p["w1"].to(buf.dtype).contiguous(),
                       p["w3"].to(buf.dtype).contiguous(),
                       p["w2"].to(buf.dtype).contiguous())
    if act == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"])) * \
            torch.einsum("ecd,edf->ecf", buf, p["w3"])
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, p["w1"]), approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, p["w2"])


def dispatch_combine(x, gates, ids, pos, keep, E: int, C: int, p: dict,
                     act: str, use_kernel: bool = True, experts=None):
    """dispatch → expert FFN → combine, for pre-decided admissions.

    ``experts`` = ``(lo, hi)`` runs only experts ``lo .. hi-1``, whose
    weights ``p`` holds (a model rank's share of E): the pairs routed
    elsewhere are left out of the ``(hi - lo, C, d)`` buffer and the
    combine, and the result is those experts' partial sum."""
    if experts is not None:
        lo, hi = experts
        keep = keep & (ids >= lo) & (ids < hi)
        ids = torch.clamp(ids - lo, 0, hi - lo - 1)
        E = hi - lo
    buf, slot = dispatch_tokens(x, keep, ids, pos, E, C)
    out = expert_ffn(buf, p, act, use_kernel=use_kernel)
    return combine_tokens(out, slot, gates, keep, gate_dtype=x.dtype)
