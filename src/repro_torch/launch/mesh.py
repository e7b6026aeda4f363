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

from ..distributed.sharding import EXPERT_AXIS, MeshShape


def production_mesh_shape(*, multi_pod: bool = False,
                          expert: int = 0) -> MeshShape:
    """The axis names and sizes of :func:`make_production_mesh`, without
    a process group (what the spec rules and ``comm.axis_groups``
    read)."""
    data = 16
    if expert:
        if data % expert:
            raise ValueError(
                f"expert axis {expert} must divide the data axis {data}")
        shape, axes = (expert, data // expert, 16), \
            (EXPERT_AXIS, "data", "model")
    else:
        shape, axes = (data, 16), ("data", "model")
    if multi_pod:
        shape, axes = (2,) + shape, ("pod",) + axes
    return MeshShape(axes, shape)


def make_production_mesh(*, multi_pod: bool = False, expert: int = 0,
                         device_type: str = "cuda"):
    """``expert > 0`` carves an expert-parallel axis out of the *data*
    axis (16 must divide by it): axes ``("expert", data/expert,
    "model")``, with a leading ``"pod"`` when multi-pod."""
    shape = production_mesh_shape(multi_pod=multi_pod, expert=expert)
    return init_device_mesh(device_type, shape.shape,
                            mesh_dim_names=shape.mesh_dim_names)


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
