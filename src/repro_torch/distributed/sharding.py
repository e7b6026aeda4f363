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
the EP round (:mod:`repro_torch.ep`), and in training each expert rank
holds its ``E/S`` experts and their optimizer state
(:func:`tp_local_params` with ``axis="expert"``: the reference's
``(EXPERT, fa, M)`` spec), every other leaf whole; the ``"model"`` axis
is Megatron tensor parallelism inside the layers
(:mod:`repro_torch.distributed.comm`), with the reference's sequence
parallelism between them (:func:`shard_act`): a model rank holds its
``S/m`` rows of the residual stream where ``m`` divides S, all-gathered
into each layer and reduce-scattered out of it, so the norms run on
those rows and their gradients are partial sums over the model ranks
(:func:`sp_summed`); where ``m`` does not divide S, and in decode
(S = 1), the activations are whole on every model rank, entering each
layer through ``copy_to_tp`` and leaving through ``reduce_from_tp``.  On
both (the reference's
``(expert, data, model)`` production layout, ``axis=("expert",
"model")``) an expert rank's ``E/S`` experts split their d_ff over the
model ranks, as the ``(EXPERT, fa, M)`` spec stores them, and the rest is
as on a model axis alone.  The specs above are the
reference's *storage* layout and stay as they are; what a model rank
computes with is its *compute* layout, :func:`tp_local_params`, which
differs from the specs in three places: mamba's fused ``in_proj`` (a rank
holds its slice of ``xi`` and of ``z``, not one half of the fused
columns), the per-channel vectors the specs replicate (``conv_b``, ``D``,
``dt_proj``'s bias, the MLP's ``b1``: a rank keeps its channels), and GQA
with fewer KV heads than model ranks (a rank keeps the one KV head its
query heads read).  Attention whose heads the model axis does not divide
(hymba-1.5b's 25) runs whole on every rank.  :func:`tp_local_config` is
the config of one model rank's shapes.

Serving on a ``(data D, model m)`` mesh: a rank's decode caches
(``models.model.init_cache`` on the mesh) hold its ``B / D`` rows, its KV
heads (one where ``KV < m``) and its ``d_inner / m`` channels;
:func:`tp_local_cache` cuts a whole cache tree so and
:func:`tp_assemble_cache` puts the ranks' back together.  Context-parallel
decode caches (``init_cache(..., context=True)``) are the reference's
layout (``launch/dryrun.py`` ``_cache_shardings`` there,
:func:`cache_layout` here): the self-attention KV leaves' time axis over
``"model"`` (every KV head on every model rank) or, where the batch does
not split over the data axes, over the data axes and ``"model"``;
:func:`cp_local_cache` and :func:`cp_assemble_cache` cut and assemble.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass, replace
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


def ep_takes_experts(cfg, S: int) -> bool:
    """Whether an expert axis of ``S`` ranks takes ``cfg``'s experts (E
    over ``"expert"``, the EP round): the config opts into
    ``expert_parallel`` and ``S``, larger than 1, divides E."""
    return bool(getattr(cfg, "expert_parallel", False)) and S > 1 and \
        cfg.n_experts > 0 and cfg.n_experts % S == 0


def seq_sharded(tp, S: int) -> bool:
    """The reference's rule for the sequence over the model axis: whether
    a ``(B, S, d)`` activation is held as ``S/m`` rows per model rank, for
    the model ranks' ``Collectives`` ``tp`` (None without a model axis):
    ``m > 1`` divides S.  Ragged lengths and decode (S = 1) stay whole."""
    return tp is not None and tp.size > 1 and S % tp.size == 0


def shard_act(x, tp):
    """The reference's sequence-parallel activation constraint on a
    tensor that every model rank holds whole (``enc_frames``,
    ``vis_embed``): this rank's rows ``[j·S/m, (j+1)·S/m)`` where
    :func:`seq_sharded`, else ``x``.  (The residual stream reaches its
    blocks from the vocab-parallel embedding's reduce-scatter, and the
    batch is this rank's rows over the data axes already.)  Sharding the
    sequence bounds the remat-saved layer inputs; the reference's
    docstring gives qwen2.5-32b train_4k at 42 GB per device without it
    and 2.6 GB with it."""
    if not seq_sharded(tp, x.shape[1]):
        return x
    from .comm import slice_to_sp   # comm imports this module
    return slice_to_sp(x, tp)


def shard_logits(x):
    """The reference's vocab-over-model logits constraint: the identity.
    On a model axis the head is column-parallel, so the logits a rank
    computes already are its vocab shard."""
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


# ---------------------------------------------------------------------------
# Tensor parallelism: one model rank's compute layout
# ---------------------------------------------------------------------------


def model_size(mesh=None) -> int:
    """The ``"model"`` axis's size under ``mesh`` (default: the current
    mesh); 1 without a mesh."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else _model_size(mesh)


def attn_split(cfg, m: int) -> bool:
    """Whether attention's heads split over ``m`` model ranks: ``m``
    divides the query heads and either divides the KV heads or is a
    multiple of them (then each rank keeps the one KV head its query
    heads read).  Otherwise every rank runs the layer's attention whole."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return H % m == 0 and (KV % m == 0 or m % KV == 0)


def tp_local_config(cfg, m: int, expert: int = 0):
    """The config whose shapes one of ``m`` model ranks computes with: the
    query and KV heads over ``m`` where they split (else whole; one KV
    head where ``KV < m``), the experts' d_ff where an expert axis of
    ``expert`` ranks takes E (:func:`ep_takes_experts`: E stays whole,
    since routing is over all E), else E over ``m`` where it divides (else
    d_ff), the MLP's d_ff, d_inner.  The vocab, the router and the norms
    keep their whole widths."""
    rep = {}
    if cfg.n_heads and attn_split(cfg, m):
        rep.update(n_heads=cfg.n_heads // m, d_head=cfg.head_dim,
                   n_kv_heads=max(1, cfg.n_kv_heads // m))
    if cfg.n_experts and cfg.n_experts % m == 0 and \
            not ep_takes_experts(cfg, expert):
        rep["n_experts"] = cfg.n_experts // m
    elif cfg.d_ff:
        rep["d_ff"] = cfg.d_ff // m
    if cfg.d_inner:
        rep["d_inner"] = cfg.d_inner // m
    return replace(cfg, **rep)


def _tp_rule(path: str, cfg, m: int, S: int = 0) -> tuple:
    """How one leaf (``path``: '/'-joined keys) lies over ``m`` model
    ranks, on its trailing dims (leading stacked-layer dims are never
    split): ``("rep",)`` whole on every rank; ``("split", dim, groups)``
    ``dim`` read as ``(groups, m, n / (groups·m))`` and rank ``r`` holding
    ``[:, r]``; ``("kv", dim)`` ``dim`` read as ``(KV, head_dim)`` and rank
    ``r`` holding head ``r // (m / KV)``.  ``S``: the size of an expert
    axis beside the model axis (0 without one); where it takes E the
    experts split their d_ff over the model ranks."""
    keys = path.strip("/").split("/")
    leaf, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
    if leaf == "embed":
        return ("split", -2, 1)                     # (V, D)
    if leaf == "lm_head":
        return ("split", -1, 1)                     # (D, V)
    if "moe" in keys:
        if leaf == "router":
            return ("rep",)
        if cfg.n_experts % m == 0 and not ep_takes_experts(cfg, S):
            return ("split", -3, 1)                 # E over model
        return ("split", -2 if leaf == "w2" else -1, 1)   # d_ff over model
    if "ssm" in keys:
        if parent == "in_proj":
            return ("split", -1, 2)                 # (D, [xi | z])
        if parent in ("x_proj", "out_proj") or leaf == "A_log":
            return ("split", -2, 1)                 # Di rows
        return ("split", -1, 1)                     # conv, D, dt_proj
    if parent in ("wq", "wk", "wv", "wo"):
        if not attn_split(cfg, m):
            return ("rep",)
        if parent == "wo":
            return ("split", -2, 1)
        if parent == "wq" or cfg.n_kv_heads % m == 0:
            return ("split", -1, 1)
        return ("kv", -1)
    if "mlp" in keys:
        if leaf == "w2":
            return ("split", -2, 1)
        return ("rep",) if leaf == "b2" else ("split", -1, 1)
    return ("rep",)                                 # norms


def _ep_rule(path: str, cfg, S: int) -> tuple:
    """How one leaf lies over ``S`` expert ranks: an EP config's experts
    (``w1``/``w3``/``w2``) ``("split", -3, 1)``, E over the ranks; its
    router ``("sum",)``, whole on every rank, its gradient partial (each
    rank's tokens' share) until summed over the ranks; every other leaf
    ``("rep",)``, whole and computed alike on every rank."""
    keys = path.strip("/").split("/")
    if "moe" not in keys or not ep_takes_experts(cfg, S):
        return ("rep",)
    return ("sum",) if keys[-1] == "router" else ("split", -3, 1)


def _check_two_axes(axis) -> None:
    if tuple(axis) != (EXPERT_AXIS, "model"):
        raise ValueError(f"a two-axis cut is ('expert', 'model'), not "
                         f"{axis!r}")


def _axes(rank, size, axis) -> tuple:
    """A cut as ``((axis, rank, size, S), ...)`` in the order it is made:
    one axis (``axis`` a name, ``rank`` and ``size`` ints) or the two of
    the production layout (``axis`` ``("expert", "model")``, ``rank`` and
    ``size`` pairs: E over the expert ranks first, then the model cut of
    each expert rank's tree).  ``S``: the expert axis's size that the
    model cut reads (0 where the cut has no expert axis)."""
    if isinstance(axis, str):
        return ((axis, rank, size, 0),)
    _check_two_axes(axis)
    (s, r), (S, m) = rank, size
    return (("expert", s, S, 0), ("model", r, m, S))


def _rule(path: str, cfg, m: int, axis: str, S: int = 0) -> tuple:
    return _tp_rule(path, cfg, m, S) if axis == "model" else \
        _ep_rule(path, cfg, m)


def _map_rules(tree, cfg, m: int, fn, path="", axis: str = "model",
               S: int = 0):
    if isinstance(tree, dict):
        return {k: _map_rules(v, cfg, m, fn, f"{path}/{k}", axis, S)
                for k, v in tree.items()}
    return fn(tree, _rule(path, cfg, m, axis, S))


def _cut(t, rule, rank: int, m: int, cfg):
    if rule[0] in ("rep", "sum"):
        return t.clone()
    d = rule[1] % t.ndim
    if rule[0] in ("kv", "head"):
        head = rank // (m // cfg.n_kv_heads)
        if rule[0] == "head":
            return t.narrow(d, head, 1).clone(
                memory_format=torch.contiguous_format)
        return t.unflatten(d, (cfg.n_kv_heads, -1)).select(d, head) \
            .clone(memory_format=torch.contiguous_format)
    groups, n = rule[2], t.shape[d]
    if n % (groups * m):
        raise ValueError(f"dim {n} of a {tuple(t.shape)} leaf does not "
                         f"split over {m} ranks")
    return t.unflatten(d, (groups, m, n // (groups * m))).select(d + 1, rank) \
        .flatten(d, d + 1).clone(memory_format=torch.contiguous_format)


def _join(pieces, rule, m: int, cfg):
    if rule[0] in ("rep", "sum"):
        return pieces[0]
    d = rule[1] % pieces[0].ndim
    if rule[0] in ("kv", "head"):
        per = m // cfg.n_kv_heads
        heads = [pieces[k * per] for k in range(cfg.n_kv_heads)]
        if rule[0] == "head":
            return torch.cat(heads, d)
        return torch.stack(heads, d).flatten(d, d + 1)
    groups = rule[2]
    return torch.stack([p.unflatten(d, (groups, -1)) for p in pieces],
                       d + 1).flatten(d, d + 2)


def tp_local_params(params, cfg, rank, size, axis="model"):
    """Rank ``rank`` of ``size``'s compute shards of a whole param tree
    over the ``axis`` mesh axis (``"model"``, or ``"expert"``: an EP
    config's ``E/S`` experts, everything else whole), or over both
    (``axis=("expert", "model")``, ``rank=(s, r)``, ``size=(S, m)``: the
    production layout, expert rank ``s``'s ``E/S`` experts with their d_ff
    over the model ranks, everything else as on a model axis alone), as
    contiguous copies (the kernels check 16-byte alignment); the whole
    tree copied when every size is 1.  Works on meta tensors (shapes
    only)."""
    for ax, r, n, S in _axes(rank, size, axis):
        params = _map_rules(params, cfg, n,
                            lambda t, rule: _cut(t, rule, r, n, cfg),
                            axis=ax, S=S)
    return params


def _assemble(pieces: list, cfg, axis: str, S: int = 0):
    m = len(pieces)

    def walk(nodes, path):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], f"{path}/{k}")
                    for k in nodes[0]}
        return _join(nodes, _rule(path, cfg, m, axis, S), m, cfg)

    return walk(pieces, "")


def tp_assemble(pieces: list, cfg, axis="model"):
    """The whole tree from every rank's :func:`tp_local_params`
    (``pieces[r]``: rank ``r``'s tree; over ``("expert", "model")``
    ``pieces[s][r]``: expert rank ``s``, model rank ``r``): the inverse,
    bit for bit."""
    if isinstance(axis, str):
        return _assemble(pieces, cfg, axis)
    _check_two_axes(axis)
    S = len(pieces)
    return _assemble([_assemble(row, cfg, "model", S) for row in pieces],
                     cfg, "expert")


def tp_gather_params(local, cfg, comm, axis="model"):
    """The whole tree on every rank from each rank's compute shards
    (``comm``: a :class:`~repro_torch.distributed.comm.Collectives` over
    the ``axis`` ranks, one all-gather per leaf that is split; over
    ``("expert", "model")`` the pair ``(expert comm, model comm)``, the
    model axis's pieces joined first)."""
    if not isinstance(axis, str):
        _check_two_axes(axis)
        ep, tp = comm
        return _gather(_gather(local, cfg, tp, "model", ep.size), cfg, ep,
                       "expert")
    return _gather(local, cfg, comm, axis)


def _gather(local, cfg, comm, axis: str, S: int = 0):
    m = comm.size

    def fn(t, rule):
        if rule[0] in ("rep", "sum"):
            return t.clone()
        return _join(list(comm.all_gather(t.detach()[None]).unbind(0)),
                     rule, m, cfg)

    return _map_rules(local, cfg, m, fn, axis=axis, S=S)


def tp_owned(params, cfg, rank, size, axis="model"):
    """Per leaf, whether rank ``rank``'s copy counts once in a sum over
    the ``axis`` ranks (the gradient norm): every rank's piece of a split
    leaf, rank 0's copy of a replicated one, the first holder's of a KV
    head that several ranks hold.  Over ``("expert", "model")`` (``rank``
    and ``size`` pairs, as in :func:`tp_local_params`) a copy counts where
    it counts on both axes, so that every element counts once over the
    ``S·m`` ranks."""
    def owned(ax, r, n, S):
        def fn(_, rule):
            if rule[0] in ("rep", "sum"):
                return r == 0
            if rule[0] == "kv":
                return r % (n // cfg.n_kv_heads) == 0
            return True

        return _map_rules(params, cfg, n, fn, axis=ax, S=S)

    flags = [owned(*a) for a in _axes(rank, size, axis)]
    if len(flags) == 1:
        return flags[0]

    def both(a, b):
        if isinstance(a, dict):
            return {k: both(a[k], b[k]) for k in a}
        return a and b

    return both(*flags)


#: the norms' leaves: their ``scale`` and ``bias`` see a rank's rows only
_NORMS = ("ln1", "ln2", "lnx", "final_norm", "enc_norm")


def sp_summed(params, m: int, seq: int, enc_seq: int = 0):
    """Per leaf, whether its gradient is partial on each of ``m`` model
    ranks under sequence parallelism, and is summed over them: the
    leaves that act on the residual stream row by row outside the
    tensor-parallel region — the norms' ``scale`` and ``bias`` and the
    MLP's ``b2``, added after its exit — in the stacks whose rows shard
    (:func:`seq_sharded`): the decoder side at sequence length ``seq``,
    whisper's encoder and ``enc_norm`` at ``enc_seq`` frames."""
    dec, enc = (m > 1 and n > 0 and n % m == 0 for n in (seq, enc_seq))

    def fn(path):
        keys = path.strip("/").split("/")
        if not (enc if keys[0] in ("enc_layers", "enc_norm") else dec):
            return False
        parent = keys[-2] if len(keys) > 1 else ""
        return parent in _NORMS or (keys[-1] == "b2" and "mlp" in keys)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return fn(path)

    return walk(params, "")


def ep_summed(params, cfg, size: int):
    """Per leaf, whether its gradient is partial on each of ``size``
    expert ranks and is summed over them (an EP config's router)."""
    return _map_rules(params, cfg, size, lambda _, r: r[0] == "sum",
                      axis="expert")


# ---------------------------------------------------------------------------
# Serving caches on a (data, model) mesh
# ---------------------------------------------------------------------------


def data_size(mesh=None) -> int:
    """The product of the fsdp axes' sizes under ``mesh`` (default: the
    current mesh): how many ways a serving batch's rows split; 1 without
    a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in fsdp_axes(mesh):
        n *= sizes[a]
    return n


def _cache_rules(path: str, cfg, m: int) -> tuple:
    """How one cache leaf lies over the mesh: ``(model rule, row dim)``.
    KV leaves ``(..., B, T, KV, dh)`` (self attention and ``cross_kv``)
    split their KV heads over ``m`` where attention splits, one head per
    rank where ``KV < m`` (``("head", dim)``: rank ``r`` holds head ``r //
    (m / KV)``), else whole; mamba's ``conv`` ``(..., B, cw-1, Di)`` and
    ``h`` ``(..., B, Di, N)`` split ``Di``.  The row dim ``B`` splits over
    the data axes."""
    leaf = path.strip("/").split("/")[-1]
    if leaf == "conv":
        return ("split", -1, 1), -3
    if leaf == "h":
        return ("split", -2, 1), -3
    if not attn_split(cfg, m):
        return ("rep",), -4
    if cfg.n_kv_heads % m == 0:
        return ("split", -2, 1), -4
    return ("head", -2), -4


def tp_local_cache(cache, cfg, model_rank: int, m: int, data_rank: int = 0,
                   D: int = 1):
    """The cache tree that rank ``(data_rank, model_rank)`` of a ``(data
    D, model m)`` mesh holds, cut from a whole one (copies): the layout of
    ``models.model.init_cache`` under that mesh."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        rule, rows = _cache_rules(path, cfg, m)
        t = _cut(node, ("split", rows, 1), data_rank, D, cfg)
        return _cut(t, rule, model_rank, m, cfg)

    return walk(cache, "")


def tp_assemble_cache(pieces: list, cfg):
    """The whole cache tree from every rank's (``pieces[d][r]``: the tree
    of data rank ``d``, model rank ``r``): the inverse of
    :func:`tp_local_cache`, bit for bit."""
    D, m = len(pieces), len(pieces[0])

    def walk(nodes, path):
        if isinstance(nodes[0][0], dict):
            return {k: walk([[n[k] for n in row] for row in nodes],
                            f"{path}/{k}") for k in nodes[0][0]}
        rule, rows = _cache_rules(path, cfg, m)
        return _join([_join(row, rule, m, cfg) for row in nodes],
                     ("split", rows, 1), D, cfg)

    return walk(pieces, "")


# ---------------------------------------------------------------------------
# Context-parallel decode caches (the reference's _cache_shardings)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CacheLayout:
    """Where a decode cache's self-attention KV leaves ``(..., B, T, KV,
    dh)`` lie over a mesh: ``batch`` the axes that carry ``B`` (the fsdp
    axes, or none), ``time`` the axes that carry ``T`` (the context group,
    in mesh order; none: ``T`` whole).  Where ``time`` holds ``"model"``
    every KV head is on every model rank."""

    batch: tuple
    time: tuple


def cache_layout(cfg, B: int, T: int, mesh, *, nested: bool = False
                 ) -> CacheLayout:
    """The reference's rule (``launch/dryrun.py`` ``_cache_shardings``)
    for self-attention KV leaves of batch ``B`` and time ``T`` (a
    sliding-window cache's ring) on ``mesh``: ``B`` over the fsdp axes
    when they divide it, ``T`` then over ``"model"`` when it divides;
    else ``T`` over the fsdp axes and ``"model"`` when that divides it,
    else over the fsdp axes alone, else whole.  ``nested`` (vlm's
    ``self_layers``, 6-d): ``B`` over the fsdp axes when they divide it,
    ``T`` over ``"model"`` when it divides, independently."""
    sizes = axis_sizes(mesh)
    fa = fsdp_axes(mesh)
    D = math.prod(sizes[a] for a in fa)
    m = sizes.get("model", 1)
    model = ("model",) if "model" in sizes else ()
    if nested:
        return CacheLayout(fa if B % D == 0 else (),
                           model if T % m == 0 else ())
    if B % D == 0:
        return CacheLayout(fa, model if T % m == 0 else ())
    if T % (D * m) == 0:
        return CacheLayout((), fa + model)
    if T % D == 0:
        return CacheLayout((), fa)
    return CacheLayout((), ())


def _mesh_coords(mesh, rank: int) -> dict:
    """``{axis: index}`` of mesh rank ``rank`` (row-major over the axes)."""
    out = {}
    for a, n in reversed(list(axis_sizes(mesh).items())):
        out[a] = rank % n
        rank //= n
    return out


def _flat(coords: dict, sizes: dict, axes: tuple) -> tuple:
    """``(index, count)`` of ``coords`` over ``axes``, row-major."""
    k, n = 0, 1
    for a in axes:
        k, n = k * sizes[a] + coords[a], n * sizes[a]
    return k, n


def _self_kv(keys: list) -> bool:
    return keys[-1] in ("k", "v") and "cross_kv" not in keys


def _cp_cuts(path: str, shape: tuple, cfg, mesh, rank: int) -> list:
    """How mesh rank ``rank``'s block of one leaf of a whole cache (of
    ``shape``) is cut: ``[(dim, kind, index, n)]``, ``kind`` ``"block"``
    (block ``index`` of ``n`` along ``dim``) or ``"head"`` (head ``index``
    of ``n``, one wide).  Self-attention KV leaves follow
    :func:`cache_layout` (their heads whole where ``T`` is over
    ``"model"``, else as :func:`tp_local_cache` cuts them); ``cross_kv``
    and the mamba leaves split ``B`` over the fsdp axes where they divide
    it, their heads or ``Di`` as :func:`tp_local_cache` does."""
    keys = path.strip("/").split("/")
    sizes = axis_sizes(mesh)
    coords = _mesh_coords(mesh, rank)
    fa = fsdp_axes(mesh)
    m = sizes.get("model", 1)
    mr = coords.get("model", 0)
    B = shape[-3] if keys[-1] in ("conv", "h") else shape[-4]
    if _self_kv(keys):
        lay = cache_layout(cfg, B, shape[-3], mesh,
                           nested=len(shape) == 6)
        batch, time = lay.batch, lay.time
    else:
        batch = fa if B % math.prod(sizes[a] for a in fa) == 0 else ()
        time = ()
    cuts = []
    rule, rows = _cache_rules(path, cfg, m)
    if batch:
        cuts.append((rows, "block", *_flat(coords, sizes, batch)))
    if time:
        cuts.append((-3, "block", *_flat(coords, sizes, time)))
    if m > 1 and "model" not in time:
        if rule[0] == "split":
            cuts.append((rule[1], "block", mr, m))
        elif rule[0] == "head":
            cuts.append((-2, "head", mr // (m // cfg.n_kv_heads),
                         cfg.n_kv_heads))
    return cuts


def _cp_walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _cp_walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    return fn(tree, path)


def _cp_block(t, path: str, cfg, mesh, rank: int):
    """Mesh rank ``rank``'s block of the whole leaf ``t``: a view."""
    for dim, kind, k, n in _cp_cuts(path, tuple(t.shape), cfg, mesh, rank):
        w = 1 if kind == "head" else t.shape[dim] // n
        t = t.narrow(dim, k * w, w)
    return t


def cp_local_cache(cache, cfg, mesh, rank: int):
    """The cache tree that mesh rank ``rank`` (row-major over ``mesh``'s
    axes) holds in the context-parallel layout, cut from a whole one
    (copies): the layout of ``models.model.init_cache(..., mesh=mesh,
    context=True)``."""
    return _cp_walk(cache, lambda t, path: _cp_block(
        t, path, cfg, mesh, rank).clone(memory_format=torch.contiguous_format))


def cp_local_shapes(cache, cfg, mesh):
    """The shapes of :func:`cp_local_cache`'s blocks (alike on every
    rank), from a whole cache tree of any tensors (meta ones too)."""
    return _cp_walk(cache, lambda t, path: _cp_block(t, path, cfg, mesh,
                                                     0).shape)


def cp_assemble_cache(pieces: list, cfg, mesh, bsz: int, cache_len: int):
    """The whole cache tree from every mesh rank's (``pieces[rank]``):
    the inverse of :func:`cp_local_cache`, bit for bit, for a cache of
    ``bsz`` rows and ``cache_len`` positions (what decides the layout)."""
    win = cfg.sliding_window
    T = min(cache_len, win) if win > 0 else cache_len

    def whole(t, path):
        keys = path.strip("/").split("/")
        shape = list(t.shape)
        if keys[-1] in ("conv", "h"):
            shape[-3] = bsz
        else:
            shape[-4] = bsz
            if _self_kv(keys):
                shape[-3] = T
        # the whole width of the heads or Di, where a cut narrows them
        for dim, kind, _, n in _cp_cuts(path, tuple(shape), cfg, mesh, 0):
            if dim not in (-3, -4):
                shape[dim] = n if kind == "head" else t.shape[dim] * n
        return shape

    def assemble(leaves, path):
        shape = whole(leaves[0], path)
        out = leaves[0].new_zeros(shape)
        for r, t in enumerate(leaves):
            view = out
            for dim, kind, k, n in _cp_cuts(path, tuple(shape), cfg, mesh,
                                             r):
                w = 1 if kind == "head" else view.shape[dim] // n
                view = view.narrow(dim, k * w, w)
            view.copy_(t)
        return out

    def walk(nodes, path=""):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes], f"{path}/{k}")
                    for k in nodes[0]}
        return assemble(nodes, path)

    return walk(pieces)
