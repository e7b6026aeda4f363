"""Device resolution and numeric parity mode.

Every entry point of the port takes ``device=None``, which means the
card.  Only an explicit ``device="cpu"`` runs on the CPU (the tests do
that); asking for the card where there is none raises — nothing quietly
carries on on the host.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``.  Raises when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string → torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(choose from {sorted(DTYPES)})") from None


def parity_mode(deterministic: bool = False):
    """Full-fp32 matmuls (TF32 off for cuBLAS and cuDNN) and, when a
    phase asks for bitwise equality, deterministic algorithms.

    cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` before its first handle is
    made for deterministic mode; it is set here if the caller did not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(deterministic)
