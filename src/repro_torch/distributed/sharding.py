"""Sharding rules over a ``torch.distributed`` device mesh.

Port of ``repro/distributed/sharding.py``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
axis names — ``"pod"``, ``"expert"``, ``"data"``, ``"model"``
(:mod:`repro_torch.launch.mesh`) — or, where only the specs are wanted, a
:class:`MeshShape` with the same names and sizes and no process groups.
A spec is a tuple with one entry per tensor dimension, in the positions
of the reference's ``PartitionSpec``: ``None`` (replicated), an axis name,
or a tuple of axis names (one name is written bare, as ``PartitionSpec``
normalises it).

Param rules (per tensor role, by pytree path), as in the reference:

* embeddings/lm_head: vocab → model, d_model → fsdp axes
* attention qkv: d_model(in) → fsdp, heads(out) → model; out: the reverse
* mlp w1/w3: d → fsdp, ff → model;  w2: ff → model, d → fsdp
* MoE experts: E → "expert" when the config opts into expert
  parallelism and the mesh carves an expert axis dividing E; else E →
  model when it divides, else ff → model
* mamba: d_inner → model, d_model → fsdp
* norms/scalars: replicated; a leading stacked-layer dim: never sharded

What the port executes: the fsdp axes (``("pod", "data")``) shard the
batch and, under the ``afe`` policies, the optimizer state
(:class:`FsdpLayout`, ``train/train_step.py``); the expert axis carries
the EP round (:mod:`repro_torch.ep`).  The ``"model"`` axis is the
reference's tensor-parallel GSPMD sharding inside the layers, which needs
collectives inside attention, MLP and mamba: a mesh whose model axis is
larger than 1 gets its specs here but raises where it would run
(:func:`require_executable`; ROADMAP Queue 1, the tensor-parallel item).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import torch

_MESH_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)

#: The one copy of the expert-parallel mesh-axis name (repro_torch.ep and
#: launch.mesh import it).
EXPERT_AXIS = "expert"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without process groups: what the
    spec rules read, for meshes larger than the running world."""

    mesh_dim_names: tuple
    shape: tuple


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@contextlib.contextmanager
def mesh_context(mesh):
    token = _MESH_CTX.set(mesh)
    try:
        yield mesh
    finally:
        _MESH_CTX.reset(token)


def current_mesh():
    return _MESH_CTX.get()


def fsdp_axes(mesh=None):
    """The data-parallel axes tuple: ("pod","data") or ("data",)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ("data",)
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def expert_axis_size(mesh=None) -> int:
    """Size of the dedicated expert-parallel axis (0 when the mesh does
    not carve one — the single-host MoE dispatch path)."""
    mesh = mesh or current_mesh()
    if mesh is None or EXPERT_AXIS not in mesh.mesh_dim_names:
        return 0
    return axis_sizes(mesh)[EXPERT_AXIS]


def _model_size(mesh) -> int:
    """TP axis size; 1 for meshes without a "model" axis."""
    return axis_sizes(mesh).get("model", 1)


def require_executable(mesh) -> None:
    """Raise for a mesh the port cannot run: a ``"model"`` axis larger
    than 1 is the reference's tensor parallelism inside the layers."""
    if mesh is not None and _model_size(mesh) > 1:
        raise NotImplementedError(
            f"a 'model' (tensor-parallel) mesh axis of size "
            f"{_model_size(mesh)} is not ported yet: it needs collectives "
            "inside attention, MLP and mamba (ROADMAP Queue 1: the "
            "tensor-parallel model axis)")


def shard_act(x):
    """The reference's sequence-parallel activation constraint.  Tensors
    are whole on every rank of a mesh whose model axis is 1, so this is
    the identity there (and raises on a larger model axis)."""
    require_executable(current_mesh())
    return x


def shard_logits(x):
    """The reference's vocab-over-model logits constraint: the identity on
    a mesh whose model axis is 1, as :func:`shard_act`."""
    require_executable(current_mesh())
    return x


# ---------------------------------------------------------------------------
# Param specs by pytree path
# ---------------------------------------------------------------------------


def _entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: one name bare."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _role_spec(path: str, shape: tuple, cfg, dp_shard: bool,
               model_size: int, expert_size: int = 0) -> tuple:
    """The spec of one param; ``path`` is '/'-joined pytree keys.
    Leading stacked-layer dims (added by the L-stacking) are detected by
    comparing ndim with the role's base rank and left unsharded."""
    fa = fsdp_axes() if dp_shard else None
    M = "model"

    def pad(spec_tail: tuple, ndim: int) -> tuple:
        lead = ndim - len(spec_tail)
        return (None,) * lead + tuple(_entry(a) for a in spec_tail)

    nd = len(shape)
    # --- scalars / norms / biases: replicated ---
    if nd <= 1 or "scale" in path or "bias" in path or path.endswith("/b") \
            or "conv_b" in path or "/D" in path or "dt_b" in path:
        return (None,) * nd
    # --- embeddings / lm head ---
    if "embed" in path:
        return pad((M, fa), nd)       # (V, D)
    if "lm_head" in path:
        return pad((fa, M), nd)       # (D, V)
    # --- MoE experts ---
    if "/moe/" in path or path.startswith("moe/"):
        if "router" in path:
            return pad((fa, None), nd)
        # A dedicated expert axis (the EP all-to-all dispatch) wins when
        # the config opts in: E shards over "expert".
        if cfg.n_experts > 0 and expert_size > 0 and \
                getattr(cfg, "expert_parallel", False) and \
                cfg.n_experts % expert_size == 0:
            if "w1" in path or "w3" in path:
                return pad((EXPERT_AXIS, fa, M), nd)   # (E, d, f)
            if "w2" in path:
                return pad((EXPERT_AXIS, M, fa), nd)   # (E, f, d)
        ep = cfg.n_experts > 0 and model_size > 0 and \
            cfg.n_experts % model_size == 0
        if "w1" in path or "w3" in path:
            # (E, d, f)
            return pad((M, fa, None), nd) if ep else pad((None, fa, M), nd)
        if "w2" in path:
            # (E, f, d)
            return pad((M, None, fa), nd) if ep else pad((None, M, fa), nd)
    # --- attention ---
    if "/wq/" in path or "/wk/" in path or "/wv/" in path:
        return pad((fa, M), nd)
    if "/wo/" in path:
        return pad((M, fa), nd)
    # --- mamba ---
    if "in_proj" in path:
        return pad((fa, M), nd)       # (D, 2*Di): Di → model
    if "out_proj" in path:
        return pad((M, fa), nd)       # (Di, D)
    if "x_proj" in path:
        return pad((M, None), nd)     # (Di, dtr+2N)
    if "dt_proj" in path:
        return pad((None, M), nd)     # (dtr, Di)
    if "conv_w" in path:
        return pad((None, M), nd)     # (cw, Di)
    if "A_log" in path:
        return pad((M, None), nd)     # (Di, N)
    # --- dense mlp ---
    if "/w1/" in path or "/w3/" in path or path.endswith("/w1") \
            or path.endswith("/w3"):
        return pad((fa, M), nd)
    if "/w2/" in path or path.endswith("/w2"):
        return pad((M, fa), nd)
    if path.endswith("/w"):
        # generic dense inside attn/mlp dicts handled above via parent name
        return pad((fa, M), nd)
    return (None,) * nd


def param_specs_tree(shapes_tree, cfg, *, dp_shard: bool = True):
    """Map a tree of tensors (or anything with ``.shape``) to specs (same
    structure) under the current mesh."""
    mesh = current_mesh()
    model_size = _model_size(mesh) if mesh is not None else 0
    expert_size = expert_axis_size(mesh)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return _role_spec(path, tuple(node.shape), cfg, dp_shard,
                          model_size, expert_size)

    return walk(shapes_tree, "")


def named_shardings(shapes_tree, cfg, *, dp_shard: bool = True):
    """The specs of :func:`param_specs_tree` as DTensor placements: per
    leaf, one ``Shard(dim)`` or ``Replicate()`` for each mesh axis, in
    the mesh's axis order."""
    # imported here: DTensor takes most of a second to import, and every
    # model module imports this one
    from torch.distributed.tensor import Replicate, Shard

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("named_shardings requires a mesh context")

    def placements(spec):
        out = []
        for axis in mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec) if e == axis or
                    (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return placements(node)

    return walk(param_specs_tree(shapes_tree, cfg, dp_shard=dp_shard))


# ---------------------------------------------------------------------------
# FSDP layout of the optimizer state (the afe policies)
# ---------------------------------------------------------------------------


def fsdp_dim(spec: tuple, mesh=None) -> Optional[int]:
    """The dimension a spec shards over the fsdp axes, or None."""
    fa = fsdp_axes(mesh)
    for d, e in enumerate(spec):
        if e == _entry(fa):
            return d
    return None


@dataclass(frozen=True)
class FsdpLayout:
    """Where the ``afe`` policies shard each leaf of the param tree.

    ``dims`` has the params' structure: per leaf the dimension that
    ``param_specs_tree(..., dp_shard=True)`` puts on the fsdp axes, or
    None (replicated).  Rank ``rank`` of ``size`` holds rows ``[rank·c,
    (rank+1)·c)`` of that dimension, ``c = ceil(n / size)``, the rows past
    ``n`` zero (the dimension padded to a multiple of ``size``)."""

    dims: dict
    rank: int
    size: int

    def local(self, t, dim: Optional[int]):
        """This rank's piece of a whole tensor ``t`` (a new tensor)."""
        if dim is None:
            return t.clone()
        n = t.shape[dim]
        c = -(-n // self.size)
        lo, hi = min(self.rank * c, n), min((self.rank + 1) * c, n)
        piece = t.narrow(dim, lo, hi - lo)
        if hi - lo == c:
            return piece.clone()
        pad = list(t.shape)
        pad[dim] = c - (hi - lo)
        return torch.cat([piece, t.new_zeros(pad)], dim=dim)


    def local_tree(self, tree):
        """This rank's pieces of a whole tree shaped like the params (an
        optimizer-state subtree restored at another world size)."""
        def walk(node, dims):
            if isinstance(node, dict):
                return {k: walk(node[k], dims[k]) for k in node}
            return node if dims is None else self.local(node, dims)

        return walk(tree, self.dims)

    def splits(self, params, prefixes=("/opt/m", "/opt/v", "/opt/master")
               ) -> dict:
        """``{checkpoint path: (dim, whole length)}`` of the sharded leaves
        of ``params``'s tree under each prefix (the optimizer state's
        paths in the trainer's ``{"params", "opt"}`` checkpoint)."""
        out = {}

        def walk(node, dims, path):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], dims[k], f"{path}/{k}")
            elif dims is not None:
                for pre in prefixes:
                    out[pre + path] = (dims, int(node.shape[dims]))

        walk(params, self.dims, "")
        return out


def fsdp_layout(params, cfg, rank: int, size: int) -> FsdpLayout:
    """The :class:`FsdpLayout` of ``params`` under the current mesh."""
    specs = param_specs_tree(params, cfg, dp_shard=True)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return fsdp_dim(node)

    return FsdpLayout(dims=walk(specs), rank=rank, size=size)
