"""Expert parallelism beside a model axis: the reference's ``(expert,
data, model)`` production layout, on the CPU.

One module-scoped subprocess spawns 4 gloo ranks at ``(expert 2, data 1,
model 2)`` meeting at a ``file://`` store under the test's temporary
directory (as ``tests/test_torch_ep_train.py`` does); any rank's
traceback fails it.  granite-moe SMOKE (E 4, top-2, d_ff 32: each rank
computes with 2 experts × 16 columns), fp32, ``expert_parallel`` on.  The
subprocess's main also builds the reference's meshes (8 host devices) for
the spec tests.

* **The round** — at ample capacity (factor E / top_k) the EP round
  inside the tensor-parallel region (``ep_dispatch_combine(..., tp=)``)
  gives the single-host port's output and gradients within 2e-5 (x's
  gradient whole on every rank, the router's summed over the expert
  ranks, the experts' put back together over both axes) and the
  reference's ``jax.grad`` of its single-host ``moe_apply``; with a hot
  router at capacity factor 1 it equals the model-1 round (the same
  expert ranks without ``tp``, whole d_ff) within 1e-6 of each tensor's
  largest value and admits the same pairs.  Each axis's collectives are counted exactly.
* **The train step** — each policy's params after 2 steps, gathered
  whole, within 2e-5 of the mesh-free port step and of the reference's
  single-device jitted step; the data, model and expert axes'
  collectives exact.
* **remat** — gradients bitwise equal with and without ``remat``, also
  with the backward on a thread where the mesh context is unset.
* **Checkpoints** — a whole checkpoint written on the 4 ranks restores
  bitwise in one process and the reverse; the trainer crashes, resumes
  on the 4 ranks and ends where an uninterrupted run does.
* **Serving** — 16 fp32 decode steps and a span prefill (chunked ==
  whole, max |Δ| 0.0) on the ranks within 2e-5 of one process's and of
  the reference's ``decode_step``; the ``ContinuousBatcher``'s ranks
  alike and equal to one process's; collectives exact per axis.
* **In process** — the two-axis cut and its inverse bit for bit, every
  element owned once over the 4 ranks, the local shapes a cut of the
  reference's ``param_specs_tree``, ``tp_local_config`` with an expert
  axis, and the FSDP layout of the doubly-cut tree at ``(expert 2, data
  2, model 2)``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, fsdp_layout, mesh_context, tp_assemble, tp_local_config,
    tp_local_params, tp_owned,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sched import FixedCapacity  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
POLICIES = ("unopt", "lc", "afe", "afe_bucket")
AXES = ("expert", "model")
SEQ, BATCH, MICRO, N_BUCKETS, STEPS = 16, 8, 2, 4, 2
T = 64                                       # tokens of the round tests
DECODE_B, DECODE_STEPS = 4, 16
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
         "send_recv")


# ---------------------------------------------------------------------------
# The subprocess: 4 ranks at (expert 2, data 1, model 2)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys, threading, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    POLICIES = ("unopt", "lc", "afe", "afe_bucket")
    AXES = ("expert", "model")
    SEQ, BATCH, MICRO, N_BUCKETS, STEPS, T = 16, 8, 2, 4, 2, 64
    DECODE_B, DECODE_STEPS = 4, 16
    CHUNKINGS = ([11], [8, 3], [1] * 11)
    #: the batcher run: (rid, arrive step, prompt length, max new)
    SERVE_SPEC = [(0, 0, 2, 5), (1, 0, 9, 4), (2, 0, 5, 6), (3, 1, 13, 3),
                  (4, 2, 3, 5), (5, 4, 7, 2), (6, 5, 1, 4), (7, 7, 11, 3)]
    SERVE = dict(n_slots=4, cache_len=32, policy="dlbc", prefill_chunk=4)


    def np_leaves(tree):
        from repro_torch.tree import tree_leaves
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]


    def granite(cf):
        from repro_torch.configs import get_config
        return dataclasses.replace(
            get_config("granite-moe-1b-a400m", smoke=True), dtype="float32",
            expert_parallel=True, moe_capacity_factor=cf)


    def moe_case(hot):
        \"\"\"MoE weights, tokens and an output cotangent from seeded numpy;
        ``hot``: the router's expert 0 made hot, capacity factor 1, twice
        the tokens (the round under pressure).\"\"\"
        cfg = granite(1.0 if hot else 2.0)
        rng = np.random.default_rng(7)
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        w = lambda *s: torch.tensor(
            (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32))
        p = {"router": w(d, E), "w1": w(E, d, f), "w3": w(E, d, f),
             "w2": w(E, f, d)}
        if hot:
            p["router"][:, 0] += 4.0
        n = 2 * T if hot else T
        x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32))
        r = torch.tensor(rng.normal(size=(n, d)).astype(np.float32))
        return cfg, p, x, r


    def comms(mesh):
        from repro_torch.distributed.comm import Collectives
        return (Collectives(mesh.get_group("expert")),
                Collectives(mesh.get_group("model")))


    def cut(tree, cfg, ep, tp):
        \"\"\"This rank's compute shards of a whole tree over both axes.\"\"\"
        from repro_torch.distributed.sharding import tp_local_params
        return tp_local_params(tree, cfg, (ep.rank, tp.rank), (2, 2), AXES)


    def counts(*cs):
        return [dict(c.counts) if c is not None else None for c in cs]


    def round_grads(cfg, local, x, r, ep, tp, *, stats=False):
        \"\"\"The EP round's output and gradients (x, router, this rank's
        experts) against the cotangent ``r``, inside the tensor-parallel
        region over ``tp`` (None: the model-1 round), with both axes'
        collectives counted apart for the forward and the backward.\"\"\"
        from repro_torch.ep.dispatch import ep_dispatch_combine

        def since(before):
            return [None if a is None else {k: b[k] - a[k] for k in a}
                    for a, b in zip(before, counts(ep, tp))]

        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in local.items()}
        xg = x.clone().requires_grad_(True)
        start = counts(ep, tp)
        out = ep_dispatch_combine(leaves, cfg, xg, comm=ep, tp=tp,
                                  return_stats=stats)
        y, st = out if stats else (out, None)
        fwd, mid = since(start), counts(ep, tp)
        g = torch.autograd.grad((y * r).sum(), [xg] + [
            leaves[k] for k in ("router", "w1", "w3", "w2")])
        bwd = since(mid)
        return y.detach(), list(g), fwd, bwd, \\
            {k: float(v) for k, v in (st or {}).items()}


    def round_checks(ep, tp):
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.ep.dispatch import ep_dispatch_combine

        out = {}
        cfg, p, x, r = moe_case(False)
        y, g, fwd, bwd, _ = round_grads(cfg, cut({"moe": p}, cfg, ep, tp)
                                        ["moe"], x, r, ep, tp)
        out["ample"] = {"y": y.numpy(), "grads": [t.numpy() for t in g],
                        "fwd": fwd, "bwd": bwd}
        # whole expert weights, and the rank's E/S whole in d_ff, are
        # sliced inside the round to what the rank computes with
        ep_only = tp_local_params({"moe": p}, cfg, ep.rank, 2,
                                  "expert")["moe"]
        ys = [ep_dispatch_combine(w, cfg, x, comm=ep, tp=tp)
              for w in (p, ep_only, cut({"moe": p}, cfg, ep, tp)["moe"])]
        out["whole_equals_local"] = all(torch.equal(a, ys[-1])
                                        for a in ys[:-1])
        # a hot router at factor 1: the model-1 round (the same expert
        # ranks, whole d_ff, no tp) against the one inside the region
        cfg, p, x, r = moe_case(True)
        y2, g2, fwd2, bwd2, st2 = round_grads(
            cfg, cut({"moe": p}, cfg, ep, tp)["moe"], x, r, ep, tp,
            stats=True)
        y1, g1, _, _, st1 = round_grads(
            cfg, tp_local_params({"moe": p}, cfg, ep.rank, 2,
                                 "expert")["moe"], x, r, ep,
            None, stats=True)
        f = cfg.d_ff // 2
        cols = slice(tp.rank * f, (tp.rank + 1) * f)
        g1 = g1[:2] + [g1[2][..., cols], g1[3][..., cols],
                       g1[4][:, cols, :]]
        out["pressure"] = {
            "y_err": float((y2 - y1).abs().max()),
            "y_scale": float(y1.abs().max()),
            "grad_err": [float((a - b).abs().max()) for a, b in zip(g2, g1)],
            "grad_scale": [float(b.abs().max()) for b in g1],
            "stats": st2, "model1_stats": st1, "fwd": fwd2, "bwd": bwd2}
        return out


    def reference_state(src):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.train.optimizer import AdamWConfig

        _, tree = CheckpointManager(src).restore(device="cpu")
        batch = {k: v.long() for k, v in tree.pop("batch").items()}
        return (granite(2.0), ShapeConfig("t", SEQ, BATCH, "train",
                                          microbatches=MICRO),
                AdamWConfig(lr=1e-3, warmup_steps=2), tree, batch)


    def policy_steps(policy, src, mesh):
        \"\"\"``STEPS`` steps of ``policy`` under ``mesh`` (None: one
        process) from the reference's state; the params gathered whole.\"\"\"
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train import train_step as TT

        cfg, shape, ocfg, tree, batch = reference_state(src)
        keys = ("collectives", "tp_collectives", "ep_collectives")
        out = {k: [] for k in keys + ("grad_norm", "skipped")}
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy=policy, q_chunk=8, k_chunk=8,
                n_buckets=N_BUCKETS), ocfg)
            params, opt = step.local_state(tree["params"], tree["opt"])
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                for k in keys:
                    out[k].append(m[k])
                out["grad_norm"].append(float(m["grad_norm"]))
                out["skipped"].append(int(m["nonfinite_skipped"]))
            if mesh is not None:
                out["split_axis"] = list(step.split_axis)
                params, opt = step.whole_state(params, opt)
        out["params"] = np_leaves(params)
        return out


    def loss_grads(src, ep, tp, remat, on_thread=False):
        \"\"\"One ``loss_fn`` backward of this rank's local params on its
        microbatch rows, counting both axes' collectives; with
        ``on_thread`` the backward runs on a new thread, where the mesh
        context is unset.\"\"\"
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves, tree_unflatten

        cfg, _, _, tree, batch = reference_state(src)
        local = cut(tree["params"], cfg, ep, tp)
        leaves = [t.clone().requires_grad_(True)
                  for t in tree_leaves(local)]
        mb = {k: v[:BATCH // MICRO] for k, v in batch.items()}
        loss = TM.loss_fn(tree_unflatten(local, leaves), cfg, mb, tp=tp,
                          ep=ep, q_chunk=8, k_chunk=8, remat=remat)
        fwd = counts(ep, tp)
        got = {}
        run = lambda: got.update(g=torch.autograd.grad(loss, leaves))
        if on_thread:
            th = threading.Thread(target=run)
            th.start()
            th.join()
        else:
            run()
        bwd = [{k: b[k] - a[k] for k in a}
               for a, b in zip(fwd, counts(ep, tp))]
        return got["g"], fwd, bwd


    def trainer_resume(mesh, base):
        \"\"\"``run_training`` (policy ``afe``) on the mesh: a run that
        crashes after step 3 of 4 (checkpoints every 2), the same run again
        (it resumes from step 2), and an uninterrupted run.\"\"\"
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.trainer import (
            SimulatedFailure, TrainerConfig, run_training)
        from repro_torch.train.train_step import StepConfig

        cfg = granite(2.0)
        shape = ShapeConfig("t", SEQ, BATCH, "train", microbatches=MICRO)
        scfg = StepConfig(policy="afe", q_chunk=8, k_chunk=8)

        def run(d, **kw):
            dist.barrier()
            with mesh_context(mesh):
                return run_training(cfg, shape, TrainerConfig(
                    steps=4, ckpt_every=2, ckpt_dir=d, **kw), scfg,
                    AdamWConfig(lr=1e-3, warmup_steps=2), device="cpu")

        try:
            run(base + "_a", failure_at=3)
            crashed = False
        except SimulatedFailure:
            crashed = True
        resumed = run(base + "_a")
        whole = run(base + "_b")
        return {"crashed": crashed, "resumed_from": resumed.resumed_from,
                "completed": resumed.completed,
                "last_loss_diff": abs(resumed.losses[-1] -
                                      whole.losses[-1]),
                "grad_norm_diff": abs(resumed.grad_norms[-1] -
                                      whole.grad_norms[-1])}


    def decode_tokens(vocab):
        return np.random.default_rng(11).integers(
            0, vocab, size=(DECODE_B, DECODE_STEPS))


    def decode_run(params, cfg, mesh, ep, tp):
        \"\"\"``DECODE_STEPS`` teacher-forced decode steps of ``DECODE_B``
        rows from a zero cache: each step's logits (this rank's vocab
        shard on the mesh) and, per step, both axes' collectives.\"\"\"
        from repro_torch.models import model as TM

        toks = decode_tokens(cfg.vocab)
        cache = TM.init_cache(cfg, DECODE_B, DECODE_STEPS, device="cpu",
                              mesh=mesh)
        out, per = [], []
        with torch.no_grad():
            for t in range(DECODE_STEPS):
                before = counts(ep, tp)
                lg, cache = TM.decode_step(params, cfg, cache, {
                    "tokens": torch.tensor(toks[:, t:t + 1]),
                    "cache_index": torch.tensor(t)}, tp=tp, ep=ep)
                out.append(lg.numpy().copy())
                per.append([None if a is None else
                            {k: b[k] - a[k] for k in a}
                            for a, b in zip(before, counts(ep, tp))])
        return np.stack(out), per


    def prefill_run(params, cfg, mesh, ep, tp):
        \"\"\"An 11-token prompt (row 0; row 1 inert) prefilled through a
        (2, 16) buffer in each of ``CHUNKINGS``, then one decode step:
        the largest |Δ| of any chunking's cache or logits against the
        whole prefill's, the whole prefill's next logits, and one
        prefill round's collectives per axis.\"\"\"
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves

        prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=12)
        runs, round_counts = [], None
        with torch.no_grad():
            for sizes in CHUNKINGS:
                cache = TM.init_cache(cfg, 2, 32, device="cpu", mesh=mesh)
                pos = 0
                for n in sizes:
                    buf = torch.zeros((2, 16), dtype=torch.long)
                    buf[0, :n] = torch.tensor(prompt[pos:pos + n])
                    before = counts(ep, tp)
                    TM.prefill_step(params, cfg, cache, {
                        "tokens": buf,
                        "cache_index": torch.tensor([pos, 0]),
                        "count": torch.tensor([n, 0])}, tp=tp, ep=ep)
                    if round_counts is None and mesh is not None:
                        round_counts = [{k: b[k] - a[k] for k in a}
                                        for a, b in zip(before,
                                                        counts(ep, tp))]
                    pos += n
                lg, _ = TM.decode_step(params, cfg, cache, {
                    "tokens": torch.tensor(prompt[11:]).expand(2, 1),
                    "cache_index": torch.tensor([11, 0])}, tp=tp, ep=ep)
                runs.append(tree_leaves(cache) + [lg])
        return {"delta": max(float((a - b).abs().max()) for run in runs[1:]
                             for a, b in zip(run, runs[0])),
                "logits": runs[0][-1].numpy(), "counts": round_counts}


    def batcher_run(params, cfg, mesh):
        \"\"\"The ``ContinuousBatcher`` over ``SERVE_SPEC`` (prompts from a
        seed) on ``mesh`` (None: one process), counting its model
        launches.\"\"\"
        from repro_torch.models import model as TM
        from repro_torch.serve import batcher as TB

        rng = np.random.default_rng(1)
        trace = [(r, t, rng.integers(0, cfg.vocab, size=n).tolist(), m)
                 for r, t, n, m in SERVE_SPEC]
        b = TB.ContinuousBatcher(cfg, params, device="cpu", mesh=mesh,
                                 **SERVE)
        reqs = [TB.Request(rid=r, prompt=list(p), max_new=n,
                           arrive_step=t) for r, t, p, n in trace]
        calls = {"prefill": 0, "decode": 0}
        real = {k: getattr(TM, k + "_step") for k in calls}

        def counted(k):
            def fn(*a, **kw):
                calls[k] += 1
                return real[k](*a, **kw)
            return fn
        for k in calls:
            setattr(TM, k + "_step", counted(k))
        try:
            b.run(reqs)
        finally:
            for k in calls:
                setattr(TM, k + "_step", real[k])
        return {"tokens": [r.tokens for r in reqs],
                "prompts": [len(p) for _, _, p, _ in trace],
                "admissions": [list(a) for a in b.admissions],
                "costs": b.stats.decode_step_costs,
                "summary": b.stats.summary(), "calls": calls,
                "collectives": [None if c is None else dict(c.counts)
                                for c in (b.dp, b.ep, b.tp)]}


    def world4(rank, tmp, src):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train import train_step as TT
        from repro_torch.tree import tree_leaves

        mesh = make_test_mesh(data=1, model=2, expert=2, device_type="cpu")
        ep, tp = comms(mesh)
        out = {"coords": [ep.rank, tp.rank]}
        out["round"] = round_checks(ep, tp)
        out["steps"] = {pol: policy_steps(pol, src, mesh)
                        for pol in POLICIES}
        out["remat"] = {}
        with mesh_context(mesh):
            base = None
            for name, remat, th in (("off", False, False),
                                    ("on", True, False),
                                    ("on_thread", True, True)):
                g, fwd, bwd = loss_grads(src, *comms(mesh), remat, th)
                if base is None:
                    base = g
                out["remat"][name] = {
                    "fwd": fwd, "bwd": bwd,
                    "bitwise": all(torch.equal(a, b)
                                   for a, b in zip(g, base))}
        # the recompute on a thread with no mesh context at all
        g, fwd, bwd = loss_grads(src, *comms(mesh), True, True)
        out["remat"]["no_context"] = {
            "fwd": fwd, "bwd": bwd,
            "bitwise": all(torch.equal(a, b) for a, b in zip(g, base))}
        out["trainer"] = trainer_resume(mesh, os.path.join(tmp, "trainer"))

        # a checkpoint written on the ranks (one afe step's whole state)
        cfg, shape, ocfg, tree, batch = reference_state(src)
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy="afe", q_chunk=8, k_chunk=8), ocfg)
            params, opt = step.local_state(tree["params"], tree["opt"])
            params, opt, _ = step(params, opt, batch)
            whole_p, whole_o = step.whole_state(params, opt)
        with CheckpointManager(os.path.join(tmp, "ckpt_ep_tp")) as mgr:
            mgr.save(1, {"params": whole_p, "opt": whole_o}, blocking=True)
        out["saved"] = {"params": np_leaves(whole_p),
                        "master": np_leaves(whole_o["master"])}
        # the one-process checkpoint (the reference's state) on the ranks
        _, back = CheckpointManager(src).restore(device="cpu")
        with mesh_context(mesh):
            lp, lo = step.local_state(back["params"], back["opt"])
            wp, wo = step.whole_state(lp, lo)
        want = cut(tree["params"], cfg, ep, tp)
        out["restored"] = {
            "local_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(lp), tree_leaves(want))),
            "whole_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(wp) + tree_leaves(wo["master"]),
                tree_leaves(tree["params"]) +
                tree_leaves(tree["opt"]["master"])))}

        # serving with the one-step params, cut to this rank
        params = cut(tree["params"], cfg, ep, tp)
        out["decode"] = decode_run(params, cfg, mesh, ep, tp)
        out["prefill"] = prefill_run(params, cfg, mesh, ep, tp)
        out["batcher"] = batcher_run(params, cfg, mesh)
        return out


    def worker(fn, rank, world, store, tmp, src, q):
        try:
            torch.set_num_threads(1)
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=world)
            res = fn(rank, tmp, src)
            dist.barrier()
            q.put((rank, res))
        except BaseException:
            q.put((rank, {"error": traceback.format_exc()}))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


    def spawn(fn, world, tmp, src, tag):
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        store = os.path.join(tmp, "store_" + tag)
        procs = [ctx.Process(target=worker, args=(
            fn, r, world, store, tmp, src, q)) for r in range(world)]
        for pr in procs:
            pr.start()
        got = {}
        try:
            while len(got) < world:
                r, res = q.get(timeout=240)
                got[r] = res
                if "error" in res:
                    break
        finally:
            for pr in procs:
                pr.join(10)
                if pr.is_alive():
                    pr.kill()
        errors = [res["error"] for res in got.values() if "error" in res]
        if errors:
            sys.exit("".join(errors))
        return got


    def reference_specs():
        \"\"\"The reference's ``param_specs_tree`` of granite-moe SMOKE
        (``expert_parallel``) on real meshes of 8 host devices, at
        ``(expert 2, data 1, model 2)`` and ``(expert 2, data 2, model
        2)``, as leaf lists of tuples (the reference's leaf order).\"\"\"
        import jax
        from jax.sharding import Mesh, PartitionSpec
        from repro.configs import get_config
        from repro.distributed.sharding import mesh_context, param_specs_tree
        from repro.models import model as JM

        cfg = dataclasses.replace(
            get_config("granite-moe-1b-a400m", smoke=True), dtype="float32",
            expert_parallel=True)
        shapes = jax.eval_shape(
            lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
        out = {}
        for data in (1, 2):
            devs = np.array(jax.devices()[:4 * data]).reshape(2, data, 2)
            with mesh_context(Mesh(devs, ("expert", "data", "model"))):
                specs = param_specs_tree(shapes, cfg)
            out[f"e2d{data}m2"] = [list(s) for s in jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]
        return out


    def diff(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(a, b))


    def moe_cut_join(pieces, cfg):
        from repro_torch.distributed.sharding import tp_assemble
        return tp_assemble([[{"moe": pieces[2 * s + r]} for r in range(2)]
                            for s in range(2)], cfg, AXES)["moe"]


    if __name__ == "__main__":
        tmp, src = sys.argv[1], sys.argv[2]
        from repro_torch.models import model as TM
        from repro_torch.models import moe as MOE
        from repro_torch.tree import tree_leaves

        got = spawn(world4, 4, tmp, src, "4")
        assert [got[r]["coords"] for r in range(4)] == \\
            [[0, 0], [0, 1], [1, 0], [1, 1]], [got[r]["coords"]
                                               for r in range(4)]
        result = {"rounds": {}}
        # the ample round against the single-host port
        cfg, p, x, r = moe_case(False)
        ranks = [got[k]["round"]["ample"] for k in range(4)]
        names = ("router", "w1", "w3", "w2")
        gx = [g["grads"][0] for g in ranks]
        router = ranks[0]["grads"][1] + ranks[2]["grads"][1]
        experts = moe_cut_join([{n: torch.from_numpy(g["grads"][i])
                                 for i, n in enumerate(names, 1)}
                                for g in ranks], cfg)
        whole = [gx[0], router] + [experts[n].numpy() for n in names[1:]]
        host = dataclasses.replace(cfg, expert_parallel=False)
        ins = [t.clone().requires_grad_(True)
               for t in (x, p["router"], p["w1"], p["w3"], p["w2"])]
        y_want = MOE.moe_apply(dict(zip(names, ins[1:])), host, ins[0])
        g_want = torch.autograd.grad((y_want * r).sum(), ins)
        np.savez(os.path.join(tmp, "round_grads.npz"), *whole)
        result["rounds"]["ample"] = {
            "y_err": max(diff([g["y"]], [y_want.detach().numpy()])
                         for g in ranks),
            "x_grad_ranks_agree": all(np.array_equal(gx[0], a)
                                      for a in gx),
            "router_grad_model_ranks_agree": all(
                np.array_equal(ranks[2 * s]["grads"][1],
                               ranks[2 * s + 1]["grads"][1])
                for s in range(2)),
            "grad_err": diff(whole, [t.numpy() for t in g_want]),
            "fwd": [g["fwd"] for g in ranks],
            "bwd": [g["bwd"] for g in ranks]}
        for k in ("pressure", "whole_equals_local"):
            result["rounds"][k] = [got[r]["round"][k] for r in range(4)]
        for k in ("remat", "trainer", "restored"):
            result[k] = [got[r][k] for r in range(4)]
        steps = {}
        for pol in POLICIES:
            one = policy_steps(pol, src, None)
            rs = [got[r]["steps"][pol] for r in range(4)]
            np.savez(os.path.join(tmp, f"params_{pol}.npz"),
                     *rs[0]["params"])
            steps[pol] = {
                "ranks_agree": max(diff(rs[0]["params"], x["params"])
                                   for x in rs),
                "mesh_free_err": diff(rs[0]["params"], one["params"]),
                "grad_norm": [x["grad_norm"] for x in rs],
                "mesh_free_grad_norm": one["grad_norm"],
                "skipped": [x["skipped"] for x in rs],
                "split_axis": [x["split_axis"] for x in rs],
                **{k: [x[k] for x in rs] for k in (
                    "collectives", "tp_collectives", "ep_collectives")}}
        result["steps"] = steps
        from repro_torch.ckpt.checkpoint import CheckpointManager
        _, back = CheckpointManager(os.path.join(tmp, "ckpt_ep_tp")).restore(
            device="cpu")
        result["to_one_process"] = [
            all(np.array_equal(a, b.numpy()) for a, b in zip(
                got[r]["saved"]["params"] + got[r]["saved"]["master"],
                tree_leaves(back["params"]) +
                tree_leaves(back["opt"]["master"])))
            for r in range(4)]

        # serving: the vocab shards of expert rank 0's two model ranks
        # put together, against one process
        cfg, _, _, tree, _ = reference_state(src)
        one_dec, _ = decode_run(tree["params"], cfg, None, None, None)
        dec = [got[r]["decode"][0] for r in range(4)]
        whole_dec = np.concatenate(dec[:2], -1)
        np.save(os.path.join(tmp, "decode.npy"), whole_dec)
        one_pre = prefill_run(tree["params"], cfg, None, None, None)
        pre = [got[r]["prefill"] for r in range(4)]
        one_b = batcher_run(tree["params"], cfg, None)
        result["serve"] = {
            "decode_err": float(np.abs(whole_dec - one_dec).max()),
            "decode_scale": float(np.abs(one_dec).max()),
            "decode_expert_ranks_agree": all(
                np.array_equal(dec[r], dec[r + 2]) for r in range(2)),
            "decode_counts": [got[r]["decode"][1] for r in range(4)],
            "prefill_delta": [x["delta"] for x in pre],
            "one_process_prefill_delta": one_pre["delta"],
            "prefill_err": float(np.abs(np.concatenate(
                [x["logits"] for x in pre[:2]], -1) -
                one_pre["logits"]).max()),
            "prefill_counts": [x["counts"] for x in pre],
            "batcher": [got[r]["batcher"] for r in range(4)],
            "one_process_batcher": one_b}
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        result["specs"] = reference_specs()
        print("RESULT " + json.dumps(result))
""")


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32",
                               expert_parallel=True, moe_capacity_factor=2.0,
                               **kw)


def _t_cfg():
    return dataclasses.replace(t_get_config(ARCH, smoke=True),
                               dtype="float32", expert_parallel=True,
                               moe_capacity_factor=2.0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's granite-moe SMOKE (fp32, ``expert_parallel``,
    capacity factor E / top_k) state after one step from its init and a
    batch, written as a port checkpoint for the subprocess; its
    single-device jitted ``afe`` step taken ``STEPS`` more times; its
    ``decode_step`` over the subprocess's decode tokens from the one-step
    params; and ``jax.grad`` of its single-host ``moe_apply`` on the round
    tests' weights."""
    cfg = _cfg()
    shape = ShapeConfig("t", SEQ, BATCH, "train", microbatches=MICRO)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    step, _ = JT.build_train_step(cfg, shape, JT.StepConfig(
        policy="afe", q_chunk=8, k_chunk=8), ocfg)
    jstep = jax.jit(step)

    def batch_of(seed):
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # from the reference's state after one step, as
    # tests/test_torch_ep_train.py does (AdamW's first update from init
    # turns fp32 rounding near zero into differences of up to lr)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, ocfg)
    jp, js, _ = jstep(jp, js, {k: jnp.asarray(v)
                               for k, v in batch_of(0).items()})
    batch = batch_of(1)
    src = tmp_path_factory.mktemp("ep_tp_state")
    with CheckpointManager(str(src)) as mgr:
        mgr.save(0, {"params": bridge.to_torch(jp, "cpu"),
                     "opt": bridge.to_torch(js, "cpu"),
                     "batch": {k: torch.tensor(v) for k, v in batch.items()}},
                 blocking=True)

    # the subprocess's decode_tokens and decode_run, on the reference
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, size=(DECODE_B, DECODE_STEPS))
    decode = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    jc = JM.init_cache(cfg, DECODE_B, DECODE_STEPS)
    dec = []
    for t in range(DECODE_STEPS):
        jl, jc = decode(jp, jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
            "cache_index": jnp.asarray(t, jnp.int32)})
        dec.append(np.asarray(jl))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(STEPS):
        jp, js, jm = jstep(jp, js, jb)

    # the round tests' weights, tokens and cotangent (the subprocess's
    # ``moe_case(False)``)
    rng = np.random.default_rng(7)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(*s):
        return (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)

    mp = {"router": w(d, E), "w1": w(E, d, f), "w3": w(E, d, f),
          "w2": w(E, f, d)}
    x = rng.normal(size=(T, d)).astype(np.float32)
    r = rng.normal(size=(T, d)).astype(np.float32)
    host = dataclasses.replace(cfg, expert_parallel=False)

    def loss(x_, p_):
        return jnp.sum(JMOE.moe_apply(p_, host, x_) * r)

    gx, gp = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in mp.items()})
    return {"src": src, "grad_norm": float(jm["grad_norm"]),
            "decode": np.stack(dec),
            "params": [np.asarray(a, np.float32)
                       for a in jax.tree.leaves(jp)],
            "round_grads": [np.asarray(gx)] + [
                np.asarray(gp[k]) for k in ("router", "w1", "w3", "w2")]}


@pytest.fixture(scope="module")
def ep_tp(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_tp_ranks")
    script = tmp / "ep_tp_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(tmp),
                          str(reference["src"])],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[len("RESULT "):])
            for pol in res["steps"]:
                with np.load(tmp / f"params_{pol}.npz") as z:
                    res["steps"][pol]["params"] = [
                        z[f"arr_{i}"] for i in range(len(z.files))]
            with np.load(tmp / "round_grads.npz") as z:
                res["round_grads"] = [z[f"arr_{i}"]
                                      for i in range(len(z.files))]
            res["serve"]["decode"] = np.load(tmp / "decode.npy")
            return res
    raise AssertionError("no RESULT line:\n" + out.stdout)


def _counts(**kw):
    return dict(dict.fromkeys(KINDS, 0), **kw)


# ---------------------------------------------------------------------------
# The round inside the tensor-parallel region
# ---------------------------------------------------------------------------


def test_round_matches_single_host(ep_tp):
    """Ample capacity: the output and the gradients equal the single-host
    port's; x's gradient is whole and alike on the 4 ranks, the router's
    alike on the model ranks of each expert rank."""
    r = ep_tp["rounds"]["ample"]
    assert r["y_err"] <= 2e-5 and r["x_grad_ranks_agree"]
    assert r["router_grad_model_ranks_agree"]
    assert r["grad_err"] <= 2e-5, r["grad_err"]


def test_round_matches_reference(ep_tp, reference):
    """The same gradients, put together over both axes, against the
    reference's ``jax.grad`` of its single-host ``moe_apply``."""
    for got, want in zip(ep_tp["round_grads"], reference["round_grads"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_round_under_pressure_matches_model1_round(ep_tp):
    """A hot router at capacity factor 1: the round inside the region
    equals the model-1 round of the same expert ranks (whole d_ff, no
    ``tp``) within 1e-6 of each tensor's largest value (the d_ff split
    adds the two halves' partial sums in another order), output and
    gradients (the experts' at this rank's columns), and admits,
    reassigns and drops the same pairs."""
    for r in ep_tp["rounds"]["pressure"]:
        assert r["stats"]["reassigned"] > 0 and r["stats"]["dropped"] > 0
        assert r["stats"] == r["model1_stats"]
        errs = [r["y_err"] / r["y_scale"]] + [
            e / sc for e, sc in zip(r["grad_err"], r["grad_scale"])]
        assert max(errs) <= 1e-6, (errs, r["y_scale"], r["grad_scale"])


@pytest.mark.parametrize("case", ["ample", "pressure"])
def test_round_collective_counts(ep_tp, case):
    """Expert axis, as without a model axis: forward the two all-to-alls
    and the output all-gather (and the stats' all-reduce when asked for),
    backward the two all-to-alls and the token block's all-gather.  Model
    axis: one all-reduce each way, the lane results' forward and the
    packed tokens' gradient backward."""
    rows = ep_tp["rounds"][case]
    if case == "ample":
        rows = [{"fwd": f, "bwd": b} for f, b in zip(rows["fwd"],
                                                      rows["bwd"])]
    stats = 1 if case == "pressure" else 0
    for r in rows:
        assert r["fwd"] == [_counts(all_to_all=2, all_gather=1,
                                    all_reduce=stats),
                            _counts(all_reduce=1)]
        assert r["bwd"] == [_counts(all_to_all=2, all_gather=1),
                            _counts(all_reduce=1)]


def test_round_slices_whole_expert_weights(ep_tp):
    """Whole expert weights, and the expert rank's E/S whole in d_ff, are
    sliced inside the round: the same output as the rank's cut."""
    assert ep_tp["rounds"]["whole_equals_local"] == [True] * 4


# ---------------------------------------------------------------------------
# The train step per policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_step_matches_mesh_free_and_reference(ep_tp, reference, policy):
    r = ep_tp["steps"][policy]
    assert r["split_axis"] == [list(AXES)] * 4
    assert r["ranks_agree"] == 0.0 and r["skipped"] == [[0] * STEPS] * 4
    assert r["mesh_free_err"] <= 2e-5
    gj = reference["grad_norm"]
    for g in r["grad_norm"]:
        assert abs(g[-1] - gj) <= 2e-5 * gj
        assert all(abs(a - b) <= 2e-5 * b
                   for a, b in zip(g, r["mesh_free_grad_norm"]))
    assert len(r["params"]) == len(reference["params"])
    for got, want in zip(r["params"], reference["params"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _local_shapes(cfg):
    return tp_local_params(TM.param_shapes(cfg), cfg, (0, 0), (2, 2), AXES)


def _data_collectives(policy):
    """The data axis's collectives per step over one rank's doubly-cut
    param tree, as ``tests/test_torch_tp.py`` derives them."""
    cfg = _t_cfg()
    shapes = _local_shapes(cfg)
    leaves = tree_leaves(shapes)
    with mesh_context(MeshShape(("expert", "data", "model"), (2, 1, 2))):
        dims = tree_leaves(fsdp_layout(shapes, cfg, 0, 1).dims)
    n, ns = len(leaves), sum(d is not None for d in dims)
    if policy == "unopt":
        return _counts(all_reduce=MICRO * n)
    if policy == "lc":
        return _counts(all_reduce=n)
    if policy == "afe":
        return _counts(reduce_scatter=ns, all_gather=ns,
                       all_reduce=n - ns + 1)
    bins = [[i for i in b if dims[i] is not None] for b in TT._bucket_bins(
        leaves, N_BUCKETS, "dlbc", FixedCapacity(idle_n=N_BUCKETS - 1,
                                                 total_n=N_BUCKETS))]
    return _counts(reduce_scatter=sum(1 for b in bins if b),
                   all_reduce=(1 if n > ns else 0) + 1,
                   all_gather=sum(len({leaves[i].dtype for i in b})
                                  for b in bins))


def _tp_collectives(n_layers):
    """The model axis's collectives per step under ``remat``,
    sequence-parallel (S 16 over 2 model ranks).  Per microbatch, with
    ``L`` layers:

    * forward: the embedding's reduce-scatter onto the sequence blocks;
      per layer the all-gathers of attention's and the MoE layer's normed
      inputs, attention's output reduce-scatter and the round's lane
      all-reduce (the round's whole result leaves by a slice); the head
      input's all-gather; the cross entropy's three all-reduces —
      ``2L + 1`` all-gathers, ``L + 1`` reduce-scatters, ``L + 3``
      all-reduces;
    * the recompute, which runs on to the gate-combine's saved input past
      the return exchange: per layer the same two all-gathers, one
      reduce-scatter and one lane all-reduce;
    * backward: per layer the slice's and attention's output gradients
      all-gathered, the two gathered inputs' gradients reduce-scattered
      and the packed tokens' gradient all-reduced; the embedding's
      all-gather and the head input's reduce-scatter.

    So ``6L + 2`` all-gathers, ``4L + 2`` reduce-scatters and ``3L + 3``
    all-reduces per microbatch (before sequence parallelism ``5 + 6L``
    all-reduces).  Per step two all-reduces more: the norms' partial
    gradients summed over the model ranks, and the gradient norm's."""
    L = n_layers
    return _counts(all_gather=MICRO * (6 * L + 2),
                   reduce_scatter=MICRO * (4 * L + 2),
                   all_reduce=MICRO * (3 * L + 3) + 2)


def _ep_collectives(n_layers):
    """The expert axis's collectives per step under ``remat``, as without
    a model axis: per MoE layer and microbatch the forward's two
    all-to-alls and output all-gather, the recompute's two all-to-alls and
    the backward's two all-to-alls and token all-gather; per step the
    router's gradient sum and the norm's."""
    per = MICRO * n_layers
    return _counts(all_to_all=6 * per, all_gather=2 * per, all_reduce=2)


@pytest.mark.parametrize("policy", POLICIES)
def test_step_collective_counts(ep_tp, policy):
    r = ep_tp["steps"][policy]
    L = _t_cfg().n_layers
    for data, model, expert in zip(r["collectives"], r["tp_collectives"],
                                   r["ep_collectives"]):
        assert data == [_data_collectives(policy)] * STEPS
        assert model == [_tp_collectives(L)] * STEPS
        assert expert == [_ep_collectives(L)] * STEPS


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["on", "on_thread", "no_context"])
def test_remat_grads_bitwise_and_recompute_takes_both_axes(ep_tp, case):
    """Gradients with ``remat`` are bitwise those without; the recompute
    re-issues each layer's two exchanges and its model-axis collectives
    up to the gate-combine (the two input all-gathers, attention's
    reduce-scatter and the round's lane all-reduce; one microbatch, 2
    layers, sequence-parallel), also with the backward on a new thread,
    where the mesh context is unset."""
    L = _t_cfg().n_layers
    for r in ep_tp["remat"]:
        off, on = r["off"], r[case]
        assert on["bitwise"] and off["bitwise"]
        assert off["fwd"] == on["fwd"] == [
            _counts(all_to_all=2 * L, all_gather=L),
            _counts(all_gather=2 * L + 1, reduce_scatter=L + 1,
                    all_reduce=L + 3)]
        assert off["bwd"] == [_counts(all_to_all=2 * L, all_gather=L),
                              _counts(all_gather=2 * L + 1,
                                      reduce_scatter=2 * L + 1,
                                      all_reduce=L)]
        assert on["bwd"] == [_counts(all_to_all=4 * L, all_gather=L),
                             _counts(all_gather=4 * L + 1,
                                     reduce_scatter=3 * L + 1,
                                     all_reduce=2 * L)]


# ---------------------------------------------------------------------------
# Checkpoints and the trainer
# ---------------------------------------------------------------------------


def test_three_axis_checkpoint_restores_in_one_process(ep_tp):
    assert ep_tp["to_one_process"] == [True] * 4


def test_one_process_checkpoint_restores_on_three_axes(ep_tp):
    for r in ep_tp["restored"]:
        assert r == {"local_bitwise": True, "whole_bitwise": True}


def test_trainer_resumes_on_three_axes(ep_tp):
    """``run_training`` on ``(expert 2, data 1, model 2)`` (``afe``: whole
    checkpoints) crashes after step 3, resumes from its step-2
    checkpoint, and ends where an uninterrupted run does."""
    for r in ep_tp["trainer"]:
        assert r["crashed"] and r["resumed_from"] == 2 and \
            r["completed"] == 4
        assert r["last_loss_diff"] == 0.0 and r["grad_norm_diff"] == 0.0


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_decode_matches_one_process(ep_tp):
    """16 teacher-forced fp32 decode steps: the model ranks' vocab shards
    put together within 2e-5 of one process's logits; the expert ranks
    of one model rank alike."""
    s = ep_tp["serve"]
    assert s["decode"].shape == (DECODE_STEPS, DECODE_B,
                                 _t_cfg().padded_vocab)
    assert s["decode_err"] <= 2e-5, s["decode_err"]
    assert s["decode_expert_ranks_agree"]


def test_decode_matches_reference(ep_tp, reference):
    np.testing.assert_allclose(ep_tp["serve"]["decode"],
                               reference["decode"], atol=2e-5, rtol=0)


def _serve_counts(n_layers):
    """Per decode step (S = 1, never sequence-parallel): the expert axis's
    two exchanges and output all-gather per MoE layer; the model axis's
    all-reduces, the embedding's and per layer attention's and the
    round's lane reduce."""
    return [_counts(all_to_all=2 * n_layers, all_gather=n_layers),
            _counts(all_reduce=1 + 2 * n_layers)]


def _prefill_counts(n_layers):
    """Per prefill round of an even chunk, sequence-parallel: the expert
    axis's as in decode; on the model axis the embedding's reduce-scatter,
    per layer the two normed inputs' all-gathers, attention's
    reduce-scatter and the round's lane all-reduce (its whole result
    leaves by a slice), and the head input's all-gather."""
    L = n_layers
    return [_counts(all_to_all=2 * L, all_gather=L),
            _counts(all_gather=2 * L + 1, reduce_scatter=L + 1,
                    all_reduce=L)]


def test_decode_collectives_exact(ep_tp):
    want = _serve_counts(_t_cfg().n_layers)
    for per_step in ep_tp["serve"]["decode_counts"]:
        assert per_step == [want] * DECODE_STEPS


def test_chunked_prefill_is_bitwise_whole_and_matches_one_process(ep_tp):
    """An 11-token prompt whole, in 8 + 3 and in 11 × 1: every local cache
    leaf and the next decode step's logits equal on every rank (max |Δ|
    0.0); the whole prefill's next logits within 2e-5 of one process's;
    one prefill round's collectives exact."""
    s = ep_tp["serve"]
    assert s["prefill_delta"] == [0.0] * 4
    assert s["one_process_prefill_delta"] == 0.0
    assert s["prefill_err"] <= 2e-5
    assert s["prefill_counts"] == [_prefill_counts(_t_cfg().n_layers)] * 4


def test_batcher_ranks_alike_and_match_one_process(ep_tp):
    """The ``ContinuousBatcher`` on the 4 ranks: every rank's tokens,
    admissions, decode costs and stats those of one process, and every
    request generated past its prompt."""
    s = ep_tp["serve"]
    want = s["one_process_batcher"]
    for got in s["batcher"]:
        for k in ("tokens", "admissions", "costs", "summary"):
            assert got[k] == want[k], k
        assert all(len(t) > n for t, n in zip(got["tokens"],
                                              got["prompts"]))


def test_batcher_collectives_exact(ep_tp):
    """Per decode step the expert and model axes' collectives of
    ``_serve_counts``, per prefill round (chunk 4) those of
    ``_prefill_counts``; per decode step also the argmax's all-gather over
    the model ranks and the tokens' all-gather over the data ranks."""
    L = _t_cfg().n_layers
    ep, tp = _serve_counts(L)
    _, tp_pre = _prefill_counts(L)
    for got in ep_tp["serve"]["batcher"]:
        n_pre, n_dec = got["calls"]["prefill"], got["calls"]["decode"]
        n = n_pre + n_dec
        assert n_pre > 0 and n_dec > 0
        data, expert, model = got["collectives"]
        assert data == _counts(all_gather=n_dec)
        assert expert == {k: v * n for k, v in ep.items()}
        assert model == {k: tp[k] * n_dec + tp_pre[k] * n_pre +
                         (n_dec if k == "all_gather" else 0) for k in tp}


# ---------------------------------------------------------------------------
# In process: the two-axis layout
# ---------------------------------------------------------------------------


def _bridged():
    return bridge.to_torch(JM.init_params(_cfg(), jax.random.PRNGKey(0)),
                           "cpu")


def test_two_axis_local_params_assemble_bitwise():
    """The reference's weights cut to each of the 4 ranks (E over the
    expert ranks, then heads, vocab and each expert's d_ff over the model
    ranks) and put back together are the bridged tree bit for bit."""
    cfg = _t_cfg()
    params = _bridged()
    pieces = [[tp_local_params(params, cfg, (s, r), (2, 2), AXES)
               for r in range(2)] for s in range(2)]
    moe, whole = pieces[1][0]["layers"]["moe"], params["layers"]["moe"]
    L, E, d, f = whole["w1"].shape
    assert moe["w1"].shape == (L, E // 2, d, f // 2)
    assert moe["w2"].shape == (L, E // 2, f // 2, d)
    assert moe["router"].shape == whole["router"].shape
    assert torch.equal(moe["w1"], whole["w1"][:, 2:4, :, :f // 2])
    assert torch.equal(moe["w2"], whole["w2"][:, 2:4, :f // 2])
    back = tp_assemble(pieces, cfg, AXES)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


def test_two_axis_owned_leaves_count_every_element_once():
    cfg = _t_cfg()
    shapes = TM.param_shapes(cfg)
    total = sum(t.numel() for t in tree_leaves(shapes))
    counted = 0
    for s in range(2):
        for r in range(2):
            local = tp_local_params(shapes, cfg, (s, r), (2, 2), AXES)
            counted += sum(t.numel() for t, own in zip(
                tree_leaves(local),
                tree_leaves(tp_owned(local, cfg, (s, r), (2, 2), AXES)))
                if own)
    assert counted == total


def _spec_cut(shape, spec, sizes):
    """``shape`` cut by a reference spec over the axes in ``sizes``."""
    out = list(shape)
    for d, e in enumerate(spec):
        for a in ([e] if isinstance(e, str) else e or []):
            out[d] //= sizes.get(a, 1)
    return tuple(out)


def test_two_axis_local_shapes_cut_reference_specs(ep_tp):
    """Every local leaf's shape is the reference's ``param_specs_tree`` on
    a real ``(expert 2, data 1, model 2)`` mesh applied to the whole
    shape (the compute layout is the storage layout: E over ``"expert"``,
    d_ff and the heads over ``"model"``)."""
    cfg = _t_cfg()
    shapes = tree_leaves(TM.param_shapes(cfg))
    local = tree_leaves(_local_shapes(cfg))
    specs = ep_tp["specs"]["e2d1m2"]
    assert len(specs) == len(shapes) == len(local)
    sizes = {"expert": 2, "data": 1, "model": 2}
    for whole, got, spec in zip(shapes, local, specs):
        assert tuple(got.shape) == _spec_cut(whole.shape, spec, sizes), \
            spec


@pytest.mark.parametrize("m", [1, 2])
def test_local_config_with_an_expert_axis(m):
    """``tp_local_config(cfg, m, expert=2)``: E stays whole (routing is
    over all E), each expert's d_ff is over the model ranks, the heads as
    on a model axis alone; its shapes are the local cut's but for the
    experts' E, the vocab-parallel embedding and head and the router."""
    cfg = _t_cfg()
    local = tp_local_config(cfg, m, expert=2)
    assert local.n_experts == cfg.n_experts
    assert local.d_ff == cfg.d_ff // m
    assert local.n_heads == cfg.n_heads // m
    want = tree_leaves(tp_local_params(TM.param_shapes(cfg), cfg, (0, 0),
                                       (2, m), AXES))
    got = tree_leaves(TM.param_shapes(local))
    for a, b in zip(got, want):
        if a.ndim == 4 and a.shape[1] == cfg.n_experts:    # (L, E, ., .)
            assert a.shape[2:] == b.shape[2:]
            assert b.shape[1] == cfg.n_experts // 2
        elif a.shape != b.shape:
            assert a.shape[-1] == cfg.padded_vocab or \
                a.shape[-2] == cfg.padded_vocab


def test_fsdp_layout_of_doubly_cut_tree(ep_tp):
    """At ``(expert 2, data 2, model 2)`` the FSDP layout of one rank's
    doubly-cut tree shards each leaf along the dim the reference's spec
    puts on ``"data"`` (``None`` where it has none), and the two data
    ranks' pieces put back together are the local leaf."""
    cfg = _t_cfg()
    local = _local_shapes(cfg)
    specs = ep_tp["specs"]["e2d2m2"]
    with mesh_context(MeshShape(("expert", "data", "model"), (2, 2, 2))):
        layouts = [fsdp_layout(local, cfg, d, 2) for d in range(2)]
    dims = tree_leaves(layouts[0].dims)
    assert dims == [next((i for i, e in enumerate(s) if e == "data"), None)
                    for s in specs]
    assert any(d is not None for d in dims)
    real = tp_local_params(_bridged(), cfg, (1, 1), (2, 2), AXES)
    for t, d in zip(tree_leaves(real), dims):
        pieces = [lay.local(t, d) for lay in layouts]
        if d is None:
            assert all(torch.equal(p, t) for p in pieces)
        else:
            assert torch.equal(torch.cat(pieces, d)[
                (slice(None),) * d + (slice(0, t.shape[d]),)], t)
