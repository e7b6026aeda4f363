"""AdamW with fp32 master weights, as plain tensor ops on each leaf.

Port of ``repro/train/optimizer.py``: the same config, schedule, global
norm, clip and non-finite guard, leaf by leaf in the reference's order
(dict keys sorted, :mod:`repro_torch.tree`).  Not ``torch.optim``: the
step is a function of ``(params, grads, state)``.

Unlike the reference's pure function, :func:`adamw_update` writes the new
parameters, moments and master weights IN PLACE into the tensors it is
given and returns them: a functional update would hold two copies of the
optimizer state at once (another 16.6 GB for granite-moe-1b-a400m's 1.39 B
parameters).  Nothing leaves the device: the guard is a ``torch.where``,
never a host branch.  The state shards like the params once the port has a
mesh (ROADMAP Queue 1 item 11); until then it lives whole on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    master_fp32: bool = True


def opt_state_shapes(param_shapes: dict, ocfg: AdamWConfig) -> dict:
    """The state's tree as meta tensors (see ``models.model.param_shapes``)."""
    def f32(s):
        return torch.empty(s.shape, dtype=torch.float32, device="meta")
    out = {"m": tree_map(f32, param_shapes),
           "v": tree_map(f32, param_shapes),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    if ocfg.master_fp32:
        out["master"] = tree_map(f32, param_shapes)
    return out


def init_opt_state(params: dict, ocfg: AdamWConfig) -> dict:
    """Zero fp32 moments, step 0 (int32) and, with ``master_fp32``, fp32
    copies of the params (copies even where the params are fp32: the
    update writes both in place)."""
    dev = tree_leaves(params)[0].device
    out = {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params),
           "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if ocfg.master_fp32:
        out["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return out


def _schedule(step: torch.Tensor, ocfg: AdamWConfig) -> torch.Tensor:
    warm = torch.clamp(step.float() / ocfg.warmup_steps, max=1.0)
    return ocfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, ocfg: AdamWConfig):
    """Returns ``(new_params, new_state, metrics)``, written in place into
    ``params`` and ``state``.

    The non-finite-gradient guard is the exception-semantics analogue: a
    bad microbatch must not corrupt the step — every leaf keeps its params,
    moments and master when the global norm is not finite, and the step
    counter still advances (as in the reference), so the skip is atomic.
    """
    step = state["step"] + 1
    lr = _schedule(step, ocfg)
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    clip = torch.where(gnorm > ocfg.grad_clip,
                       ocfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       torch.ones_like(gnorm))
    b1, b2 = ocfg.b1, ocfg.b2
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    masters = state.get("master", params)
    for p, g, m, v, ma in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"]),
                              tree_leaves(masters)):
        g = g.float() * clip
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        base = ma.float()
        new_master = base - lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2)
                                                + ocfg.eps)
                                  + ocfg.weight_decay * base)
        new_master = torch.where(finite, new_master, base)
        m.copy_(torch.where(finite, m2, m))
        v.copy_(torch.where(finite, v2, v))
        if "master" in state:
            ma.copy_(new_master)
        p.copy_(new_master.to(p.dtype))
    state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": lr,
               "nonfinite_skipped": (~finite).to(torch.int32)}
    return params, state, metrics
