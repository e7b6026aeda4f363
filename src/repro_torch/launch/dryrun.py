"""The dry run on the meta device: every (arch × shape × mesh) cell's
step, traced for one rank, with no card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 512 host devices and reads XLA's cost and memory analyses.  Here
rank 0 of the production mesh (``16x16`` or ``2x16x16``,
:func:`~repro_torch.launch.mesh.production_mesh_shape`, which exists only
as a :class:`~repro_torch.distributed.sharding.MeshShape`) runs its step
on the meta device: its compute shards of the params
(``tp_local_params``), its FSDP pieces of the optimizer state
(``fsdp_layout``), its rows of the batch and its cache
(``init_cache`` on the mesh, a decode cell's in the reference's
context-parallel layout), then the train step (``build_train_step``:
forward, backward and AdamW, ``remat`` on), the prefill or one decode
step.  Shapes and dtypes only: nothing is allocated and nothing is
launched, and CUDA is never initialised (``torch.cuda.is_initialized()``
stays False) — the one entry point of the port whose device is not the
card.  The collectives over the mesh's axes go through
:class:`~repro_torch.distributed.comm.Collectives` over
:class:`~repro_torch.distributed.comm.MeshGroup` groups, which issue nothing
and count kinds and bytes.

Each record has the reference's keys where they mean the same (``arch``,
``shape``, ``mesh``, ``policy``, ``schedule``, ``status``, ``reason``,
``chips``, ``cost``, ``roofline``, ``roofline_fraction``, ``n_params``,
``n_active_params``, ``hbm_per_device_gb``, ``fits_hbm``) and:

* ``cost`` — the :class:`~repro_torch.roofline.analysis.OpCost` of the
  traced step (:mod:`repro_torch.roofline.op_counter`), which
  :mod:`repro_torch.roofline.reanalyze` recomputes the roofline from;
* ``trace_s`` in place of ``lower_s`` / ``compile_s``;
* ``memory`` — the rank's argument bytes, exact (params, optimizer state,
  its rows of the batch, its cache), and the activation bytes: the peak
  of the tensors autograd holds for the backward
  (``saved_tensors_hooks``, each base tensor once, the params and the
  batch left out);
* ``kernels`` — each hand-written kernel's calls, FLOPs and bytes;
* ``collectives`` — a train step's counts per mesh axis (the step's
  ``metrics``);
* ``layout`` — where the port lays a decode cell's cache out otherwise
  than the reference (``launch/dryrun.py`` ``_cache_shardings`` there):
  only ``cross_kv``, whose heads the port splits over the model ranks
  where the reference, whose rule splits only its time axis, holds it
  whole on each (1500 frames or 1601 patches do not divide ``"model"``).
  The self-attention caches follow the reference's rule
  (``sharding.cache_layout``: the time axis over ``"model"``, or at B 1
  over the data axes and ``"model"``), and decode runs context-parallel
  over the axes that carry it.

``fits_hbm`` holds the rank's argument and activation bytes against
:data:`HBM_BYTES`.  Records go to ``experiments/torch_dryrun/``, one file
per cell (a cell whose file exists is skipped)::

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, input_specs
from ..configs import shape_applicable
from ..distributed.comm import (
    Collectives, context_comm, mesh_group, model_comm,
)
from ..distributed.sharding import (
    attn_split, axis_sizes, cache_layout, data_size, fsdp_axes,
    mesh_context, tp_local_params,
)
from ..models import model as MDL
from ..roofline.analysis import (
    model_flops_estimate, roofline_fraction, roofline_from_opcost,
)
from ..roofline.op_counter import OpCounter
from ..train.optimizer import AdamWConfig, opt_state_shapes
from ..train.train_step import (
    StepConfig, build_decode_step, build_prefill_step, build_train_step,
)
from ..tree import tree_leaves
from .mesh import production_mesh_shape

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (81,559 MiB in nvidia-smi), read on the card; ``chip_smoke.py``
#: gates it
HBM_BYTES = 85_017_493_504
OUT_DIR = "experiments/torch_dryrun"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class _SavedBytes:
    """The peak bytes of the tensors autograd holds for the backward: each
    saved tensor's base counted once while it is alive, tensors whose
    base is a leaf that requires grad (the params) or one of ``skip``
    (the batch) left out."""

    def __init__(self, skip=()):
        self.skip = {id(t) for t in skip}
        self.live: dict = {}
        self.now = self.peak = 0

    def _release(self, key):
        self.now -= self.live.pop(key)

    def pack(self, t):
        base = t._base if t._base is not None else t
        key = id(base)
        if key in self.live or key in self.skip or (
                base.is_leaf and base.requires_grad):
            return t
        n = base.numel() * base.element_size()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(base, self._release, key)
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        lambda t: t)


def trace_step(cfg, shape, mesh, *, policy: str = "afe",
               schedule: str = "masked") -> dict:
    """Trace rank 0's step of ``shape`` (train, prefill or decode) for
    ``cfg`` on ``mesh`` (a ``MeshShape``) on the meta device.  Returns
    ``{"cost", "kernels", "memory", "collectives", "layout", "trace_s"}``
    (``cost`` an ``OpCost``)."""
    t0 = time.perf_counter()
    scfg = StepConfig(policy=policy, schedule=schedule)
    ocfg = AdamWConfig()
    specs = input_specs(cfg, shape)
    D = data_size(mesh)
    B = shape.global_batch
    layout = ""
    memory: dict = {}
    collectives: dict = {}
    with mesh_context(mesh):
        tp = model_comm(mesh)
        m = tp.size if tp is not None else 1
        pshapes = MDL.param_shapes(cfg)
        if shape.kind == "train":
            step, _ = build_train_step(cfg, shape, scfg, ocfg)
            params, opt = step.local_state(
                pshapes, opt_state_shapes(pshapes, ocfg))
            rows = B // D
            saved = _SavedBytes(specs.values())
            with OpCounter() as counter, saved.hooks():
                _, _, metrics = step(params, opt, specs)
            memory = {"params_bytes": _nbytes(params),
                      "opt_state_bytes": _nbytes(opt),
                      "batch_bytes": sum(
                          t[:rows].numel() * t.element_size()
                          for t in specs.values()),
                      "cache_bytes": 0,
                      "activation_bytes": saved.peak}
            collectives = {"data": metrics["collectives"],
                           "model": metrics["tp_collectives"],
                           "expert": metrics["ep_collectives"]}
        else:
            params = tp_local_params(pshapes, cfg, 0, m) \
                if tp is not None else pshapes
            whole = B % D != 0
            if shape.kind == "decode" and cfg.family in ("encdec", "vlm") \
                    and m > 1 and attn_split(cfg, m):
                layout = (f"cross_kv: {cfg.n_kv_heads} KV heads split over "
                          f"{m} model ranks (the reference holds it whole "
                          "on each: its time axis does not divide "
                          "\"model\")")
            rows = B if whole else B // D
            # the MoE layers size capacity over every data rank's rows;
            # rows held whole are not split over the data ranks
            dp = None if whole or D == 1 else \
                Collectives(mesh_group(mesh, fsdp_axes(mesh)))
            batch = {k: (v[:rows] if v.ndim else v) for k, v in specs.items()}
            cache = {}
            with torch.no_grad(), OpCounter() as counter:
                if shape.kind == "prefill":
                    build_prefill_step(cfg, scfg)(params, batch, dp=dp)
                else:
                    win = cfg.sliding_window
                    T = min(shape.seq_len, win) if win > 0 \
                        else shape.seq_len
                    cp = context_comm(mesh, cache_layout(
                        cfg, B, T, mesh, nested=cfg.family == "vlm").time)
                    cache = MDL.init_cache(cfg, B, shape.seq_len,
                                           device="meta", mesh=mesh,
                                           context=True)
                    build_decode_step(cfg)(params, cache, batch, dp=dp,
                                           cp=cp)
            memory = {"params_bytes": _nbytes(params),
                      "opt_state_bytes": 0,
                      "batch_bytes": _nbytes(batch),
                      "cache_bytes": _nbytes(cache),
                      "activation_bytes": 0}
    memory["argument_bytes"] = sum(memory[k] for k in (
        "params_bytes", "opt_state_bytes", "batch_bytes", "cache_bytes"))
    return {"cost": counter.cost, "kernels": counter.kernels,
            "memory": memory,
            "collectives": collectives, "layout": layout,
            "trace_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             policy: str = "afe", schedule: str = "masked",
             mesh=None, verbose: bool = True) -> dict:
    """Trace one cell; return its roofline/memory record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = dict(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16",
               policy=policy, schedule=schedule, status="skipped",
               reason=reason)
    if not ok:
        return rec
    mesh = mesh or production_mesh_shape(multi_pod=multi_pod)
    chips = 1
    for n in axis_sizes(mesh).values():
        chips *= n
    got = trace_step(cfg, shape, mesh, policy=policy, schedule=schedule)
    terms = roofline_from_opcost(got["cost"], chips=chips,
                                 model_flops=model_flops_estimate(cfg, shape))
    mem = got["memory"]
    per_device = mem["argument_bytes"] + mem["activation_bytes"]
    rec.update(
        status="ok",
        chips=chips,
        trace_s=round(got["trace_s"], 2),
        memory=mem,
        hbm_per_device_gb=round(per_device / 2 ** 30, 3),
        fits_hbm=bool(per_device < HBM_BYTES),
        cost=got["cost"].as_dict(),
        kernels=got["kernels"],
        collectives=got["collectives"],
        layout=got["layout"],
        roofline=terms.as_dict(),
        roofline_fraction=round(roofline_fraction(terms), 4),
        n_params=cfg.n_params(),
        n_active_params=cfg.n_active_params(),
    )
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "status",
                           "hbm_per_device_gb", "fits_hbm",
                           "roofline_fraction", "trace_s")}), flush=True)
        print(f"  dominant={terms.dominant} compute={terms.compute_s:.4f}s "
              f"memory={terms.memory_s:.4f}s "
              f"collective={terms.collective_s:.4f}s "
              f"coll_ops={terms.collective_ops}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="afe")
    ap.add_argument("--schedule", default="masked")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    t0 = time.perf_counter()
    for multi_pod in meshes:
        mname = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape in shapes:
                tag = f"{mname}_{arch}_{shape}_{args.policy}_{args.schedule}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"skip (exists): {tag}", flush=True)
                    continue
                print(f"=== {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=multi_pod,
                                   policy=args.policy,
                                   schedule=args.schedule)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = dict(arch=arch, shape=shape, mesh=mname,
                               policy=args.policy, status="error",
                               error=f"{type(e).__name__}: {e}")
                    failures += 1
                path.write_text(json.dumps(rec, indent=1))
    print(f"done in {time.perf_counter() - t0:.1f} s; failures={failures}",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
