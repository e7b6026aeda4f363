"""Activation memory per model rank on a ``(data 1, model 2)`` mesh.

    python -m benchmarks.torch_sp_memory [--src DIR] [--layers 24]
        [--seq 1024] [--seed 0]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two checkouts — one whose model axis runs sequence-parallel and
its parent, whose activations are whole on every model rank — can be
measured in turn in one call, each in its own processes.  Spawns two
processes on the one card, a gloo group (the mesh is built with
``device_type="cpu"`` over CUDA tensors; its file store under ``build/``),
granite-moe-1b-a400m at full width (``--layers`` of its 24 layers), bf16,
weights and tokens from ``--seed``, and on each model rank measures:

- ``step_activation_gb``: for each of two ``lc`` train steps (global
  batch 8 in 2 microbatches of 4 × ``--seq``, ``remat``) the peak
  allocated over the step less what was allocated just before it
  (params, optimizer state and batch excluded; the step's gradients and
  accumulators included), as ``chip_smoke.py``'s ``tp_train`` reports
  it, and ``step_ms``, each step's host-clock time (synchronised);
- ``saved_gb``: one microbatch through ``loss_fn`` with grad and
  ``remat``: allocated after the forward less before it, what autograd
  keeps for the backward (the layers' saved inputs, the logits and the
  loss's own tensors), and ``fwd_bwd_peak_gb``, the peak over that
  forward and its backward less the same base;
- ``layer_input``: the shape of a layer's input on the rank and
  ``layer_inputs_gb``, its bytes times the layer count (what ``remat``
  saves per microbatch).

Prints one JSON line per rank with the card's name and power limit.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"


def rank_run(rank: int, args) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.comm import Collectives
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import blocks as TB
    from repro_torch.models import model as TM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import StepConfig, build_train_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    mesh = make_test_mesh(data=1, model=2, device_type="cpu")
    cfg = dataclasses.replace(get_config(ARCH), n_layers=args.layers)
    S = args.seq
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=1)
    with mesh_context(mesh):
        step, _ = build_train_step(cfg, ShapeConfig(
            "train", S, 8, "train", microbatches=2), StepConfig(policy="lc"),
            ocfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = step.local_state(TM.init_params(cfg, gen, device="cuda"))
    opt = init_opt_state(params, ocfg, layout=step.layout)
    toks = torch.randint(0, cfg.vocab, (8, S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    torch.cuda.empty_cache()
    out = {"rank": rank}

    # two train steps
    out["step_ms"], out["step_activation_gb"] = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_activation_gb"].append(
            (torch.cuda.max_memory_allocated() - before) / 1e9)
    out["loss"] = float(m["loss"])
    out["tp_collectives"] = m["tp_collectives"]
    del m
    torch.cuda.empty_cache()

    # one microbatch's forward and backward through loss_fn
    shapes = []
    real = TB.layer_apply

    def spy(p, c, x, kind, **kw):
        shapes.append(tuple(x.shape))
        return real(p, c, x, kind, **kw)

    leaves = tree_leaves(params)
    views = [p.detach().requires_grad_(True) for p in leaves]
    mb = {k: v[:4] for k, v in batch.items()}
    tp = Collectives(mesh.get_group("model"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    TB.layer_apply = spy
    try:
        loss = TM.loss_fn(tree_unflatten(params, views), cfg, mb, tp=tp)
    finally:
        TB.layer_apply = real
    torch.cuda.synchronize()
    out["saved_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    grads = torch.autograd.grad(loss, views)
    torch.cuda.synchronize()
    out["fwd_bwd_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del grads, loss
    shape = shapes[0]
    n = 1
    for k in shape:
        n *= k
    out["layer_input"] = list(shape)
    out["layer_inputs_gb"] = n * 2 * cfg.n_layers / 1e9
    return out


def worker(rank: int, store: str, args, q) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(args.src).resolve()))
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2)
        q.put((rank, rank_run(rank, args)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import multiprocessing as mp

    import torch

    if not torch.cuda.is_available():
        print("torch_sp_memory: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    store = ROOT / "build" / f"sp_memory_{os.getpid()}"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, str(store / "store"), args,
                                              q)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < 2:
            r, res = q.get(timeout=900)
            got[r] = res
            if "error" in res:
                break
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    errors = [res["error"] for res in got.values() if "error" in res]
    if errors:
        print("".join(errors), file=sys.stderr)
        return 1
    for r in range(2):
        print(json.dumps({"bench": "torch_sp_memory", "arch": ARCH,
                          "layers": args.layers, "seq": args.seq,
                          "mesh": "data 1, model 2", "src": args.src,
                          "card": card, **got[r]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
