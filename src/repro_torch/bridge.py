"""Move parameter, cache and optimizer-state trees between the JAX
reference and the port.

The reference's trees are nested dicts of arrays (stacked layers keep
their leading ``(L,)`` dim); the port uses the same nesting with torch
tensors.  The AdamW state (``m``, ``v``, ``master`` and the int32 scalar
``step``) travels the same way, dtypes kept, so a parity test can start
both packages' train steps from one state.  Anything exposing ``__array__`` (a JAX array, a numpy array)
is accepted, so this module imports neither JAX nor the reference.

bf16 travels as its raw 16 bits: numpy's bf16 is the ``ml_dtypes``
extension type, which ``torch.from_numpy`` rejects, so the bits go
through a ``uint16``/``int16`` view in both directions and the round
trip is bitwise.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .device import resolve_device


def _np_bf16_dtype() -> np.dtype:
    # Registered by ml_dtypes, which the JAX side has always imported by
    # the time a tree comes back to it.
    try:
        return np.dtype("bfloat16")
    except TypeError:
        raise TypeError("numpy has no bfloat16 dtype registered; import "
                        "ml_dtypes (JAX does) before converting bf16 "
                        "tensors back") from None


def leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np_bf16_dtype())
    return t.numpy()


def to_torch(tree: Any, device: Optional[Union[str, torch.device]] = None):
    """Nested dict/list/tuple of arrays → the same nesting of tensors on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return leaf_to_torch(x, dev)
    return go(tree)


def to_numpy(tree: Any):
    """Nested tensors → the same nesting of numpy arrays (bf16 as the
    ``ml_dtypes`` bfloat16 numpy dtype), ready for ``jnp.asarray``."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return leaf_to_numpy(tree)
