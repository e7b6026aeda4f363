"""Plain PyTorch version of the grouped expert-FFN kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_gmm_ref(buf, w1, w3, w2):
    """buf: (E, C, d); w1/w3: (E, d, f); w2: (E, f, d).  fp32 inside,
    result in buf's dtype."""
    x = buf.float()
    h = F.silu(torch.einsum("ecd,edf->ecf", x, w1.float())) \
        * torch.einsum("ecd,edf->ecf", x, w3.float())
    return torch.einsum("ecf,efd->ecd", h, w2.float()).to(buf.dtype)
