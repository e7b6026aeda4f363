"""Mesh construction on ``torch.distributed``.

Port of ``repro/launch/mesh.py``: the same shapes and axis names, built
with ``init_device_mesh`` over an initialised process group.

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model").

The device type is ``"cuda"`` (NCCL) unless the caller asks for
``"cpu"`` (gloo), as the CPU tests do.  Functions, so that importing
this module touches no process group.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from ..distributed.sharding import EXPERT_AXIS


def make_production_mesh(*, multi_pod: bool = False, expert: int = 0,
                         device_type: str = "cuda"):
    """``expert > 0`` carves an expert-parallel axis out of the *data*
    axis (16 must divide by it): axes ``("expert", data/expert,
    "model")``, with a leading ``"pod"`` when multi-pod."""
    data = 16
    if expert:
        if data % expert:
            raise ValueError(
                f"expert axis {expert} must divide the data axis {data}")
        shape = (2, expert, data // expert, 16) if multi_pod else \
            (expert, data // expert, 16)
        axes = ("pod", EXPERT_AXIS, "data", "model") if multi_pod else \
            (EXPERT_AXIS, "data", "model")
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    shape = (2, data, 16) if multi_pod else (data, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   expert: int = 0, device_type: str = "cuda"):
    """Small mesh over the running process group (its world size must be
    the product of the axes)."""
    shape, axes = (), ()
    if pod:
        shape, axes = (pod,), ("pod",)
    if expert:
        shape, axes = shape + (expert,), axes + (EXPERT_AXIS,)
    shape, axes = shape + (data, model), axes + ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
