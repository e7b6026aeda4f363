"""Expert parallelism under autograd (the ``"expert"`` mesh axis in
training) on the CPU.

One module-scoped subprocess spawns gloo ranks meeting at a ``file://``
store under the test's temporary directory (as ``tests/test_torch_tp.py``
does); any rank's traceback fails it.  granite-moe SMOKE (E 4, top-2),
fp32, ``expert_parallel`` on.

* **The round, 2 ranks** — at ample capacity (factor E / top_k) the EP
  round's gradients (the token matrix's, gathered; the router's, summed
  over the ranks; each rank's ``w1``/``w3``/``w2`` slice) equal the
  single-host port's within 2e-5 and the reference's ``jax.grad`` of its
  single-host ``moe_apply`` (the reference's EP round cannot run here,
  ROADMAP Queue 3 B); with a hot router at capacity factor 1 they equal a
  one-process oracle that runs both shards' legs with the exchange as a
  plain tensor permutation within 1e-6.  Forward and backward issue
  exactly two all-to-alls and one all-gather each; the stats all-reduce
  only when asked for.
* **The round on a data axis, 4 ranks** — at ``(expert 2, data 2)`` the
  round gathers both data ranks' token rows and runs on the whole batch
  (fault N, repaired): the ranks' rows put together equal the two-shard
  oracle over the whole matrix under pressure and the single-host port
  and the reference at ample capacity; one data-axis all-gather forward,
  none backward.
* **The train step** — each policy on ``(expert 2, data 1)``, and
  ``afe`` / ``afe_bucket`` on ``(expert 2, data 2)`` (4 ranks): the
  params after 2 steps, gathered whole, within 2e-5 of the mesh-free port
  step and of the reference's single-device jitted step from the same
  state (the reference's after one step from its init); the data axis's collectives are the policies' own over the local
  tree, the expert axis's are counted apart and exactly.
* **remat** — gradients with ``remat`` bitwise equal to gradients
  without; the recompute re-issues the round's exchanges, also when the
  backward runs on a thread where the mesh context is unset (as the
  autograd engine's device thread is on the card).
* **Checkpoints** — a whole checkpoint written on ``(expert 2, data 1)``
  restores bitwise in one process and the reverse; the trainer crashes,
  resumes on the 2 ranks and ends where an uninterrupted run does.
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
    MeshShape, ep_summed, fsdp_layout, mesh_context,
    tp_assemble, tp_local_params, tp_owned,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sched import FixedCapacity  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
POLICIES = ("unopt", "lc", "afe", "afe_bucket")
WIDE = ("afe", "afe_bucket")                 # also on (expert 2, data 2)
SEQ, BATCH, MICRO, N_BUCKETS, STEPS = 16, 8, 2, 4, 2
T = 64                                       # tokens of the round tests
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
         "send_recv")


# ---------------------------------------------------------------------------
# The subprocess: 2 ranks at (expert 2, data 1), then 4 at (expert 2, data 2)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys, threading, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    POLICIES = ("unopt", "lc", "afe", "afe_bucket")
    WIDE = ("afe", "afe_bucket")
    SEQ, BATCH, MICRO, N_BUCKETS, STEPS, T = 16, 8, 2, 4, 2, 64


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


    def local_moe(p, cfg, rank):
        \"\"\"Expert rank ``rank``'s E/S experts of one MoE layer's weights
        (the router whole).\"\"\"
        from repro_torch.distributed.sharding import tp_local_params
        return tp_local_params({"moe": p}, cfg, rank, 2, "expert")["moe"]


    def round_grads(cfg, p, x, r, ep, *, stats=False, dp=None):
        \"\"\"The EP round's output and gradients (x, router, this rank's
        experts) against the cotangent ``r``, with the expert group's
        collectives (and the data group's, with ``dp``) counted apart for
        the forward and the backward.\"\"\"
        from repro_torch.ep.dispatch import ep_dispatch_combine

        local = local_moe(p, cfg, ep.rank)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in local.items()}
        xg = x.clone().requires_grad_(True)
        out = ep_dispatch_combine(leaves, cfg, xg, comm=ep, dp=dp,
                                  return_stats=stats)
        y, st = out if stats else (out, None)
        fwd = dict(ep.counts)
        dp_fwd = dict(dp.counts) if dp is not None else {}
        g = torch.autograd.grad((y * r).sum(), [xg] + [
            leaves[k] for k in ("router", "w1", "w3", "w2")])
        bwd = {k: ep.counts[k] - fwd[k] for k in fwd}
        dp_bwd = {k: dp.counts[k] - dp_fwd[k] for k in dp_fwd}
        return {"y": y.detach().numpy().tolist(),
                "grads": [t.numpy().tolist() for t in g],
                "fwd": fwd, "bwd": bwd, "dp_fwd": dp_fwd, "dp_bwd": dp_bwd,
                "stats": {k: float(v) for k, v in (st or {}).items()}}


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
        out = {"collectives": [], "ep_collectives": [], "grad_norm": [],
               "skipped": []}
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy=policy, q_chunk=8, k_chunk=8,
                n_buckets=N_BUCKETS), ocfg)
            params, opt = step.local_state(tree["params"], tree["opt"])
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                out["collectives"].append(m["collectives"])
                out["ep_collectives"].append(m["ep_collectives"])
                out["grad_norm"].append(float(m["grad_norm"]))
                out["skipped"].append(int(m["nonfinite_skipped"]))
            if mesh is not None:
                params, opt = step.whole_state(params, opt)
        out["params"] = np_leaves(params)
        return out


    def loss_grads(src, ep, remat, on_thread=False):
        \"\"\"One ``loss_fn`` backward of this rank's local params on its
        microbatch rows, counting the expert group's collectives; with
        ``on_thread`` the backward runs on a new thread, where the mesh
        context is unset.\"\"\"
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves, tree_unflatten

        cfg, _, _, tree, batch = reference_state(src)
        local = tp_local_params(tree["params"], cfg, ep.rank, ep.size,
                                "expert")
        leaves = [t.clone().requires_grad_(True)
                  for t in tree_leaves(local)]
        mb = {k: v[:BATCH // MICRO] for k, v in batch.items()}
        loss = TM.loss_fn(tree_unflatten(local, leaves), cfg, mb, ep=ep,
                          q_chunk=8, k_chunk=8, remat=remat)
        fwd = dict(ep.counts)
        got = {}
        run = lambda: got.update(g=torch.autograd.grad(loss, leaves))
        if on_thread:
            th = threading.Thread(target=run)
            th.start()
            th.join()
        else:
            run()
        return got["g"], fwd, {k: ep.counts[k] - fwd[k] for k in fwd}


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


    def world2(rank, tmp, src):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import (
            mesh_context, tp_local_params)
        from repro_torch.ep.dispatch import ep_dispatch_combine
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train import train_step as TT
        from repro_torch.tree import tree_leaves

        mesh = make_test_mesh(data=1, model=1, expert=2, device_type="cpu")
        group = mesh.get_group("expert")
        out = {}
        for name, hot in (("ample", False), ("pressure", True)):
            cfg, p, x, r = moe_case(hot)
            out[name] = round_grads(cfg, p, x, r, Collectives(group),
                                    stats=hot)
        # whole expert weights (sliced inside the round) give the same
        # output as this rank's; the stats all-reduce only when asked
        cfg, p, x, _ = moe_case(False)
        ep = Collectives(group)
        y_whole = ep_dispatch_combine(p, cfg, x, comm=ep)
        y_local = ep_dispatch_combine(local_moe(p, cfg, rank), cfg, x,
                                      comm=ep)
        out["whole_equals_local"] = bool(torch.equal(y_whole, y_local))
        out["no_stats_counts"] = dict(ep.counts)
        with mesh_context(mesh):
            from repro_torch.models import moe as MOE
            _, st = MOE.moe_apply(p, cfg, x, return_stats=True)
        out["stats_spawns"] = float(st["spawns"])

        out["steps"] = {pol: policy_steps(pol, src, mesh)
                        for pol in POLICIES}
        out["remat"] = {}
        with mesh_context(mesh):
            base = None
            for name, remat, th in (("off", False, False),
                                    ("on", True, False),
                                    ("on_thread", True, True)):
                g, fwd, bwd = loss_grads(src, Collectives(group), remat, th)
                if base is None:
                    base = g
                out["remat"][name] = {
                    "fwd": fwd, "bwd": bwd,
                    "bitwise": all(torch.equal(a, b)
                                   for a, b in zip(g, base))}
        # the recompute on a thread with no mesh context at all
        g, fwd, bwd = loss_grads(src, Collectives(group), True, True)
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
        with CheckpointManager(os.path.join(tmp, "ckpt_ep")) as mgr:
            mgr.save(1, {"params": whole_p, "opt": whole_o}, blocking=True)
        out["saved"] = {"params": np_leaves(whole_p),
                        "master": np_leaves(whole_o["master"])}
        # the one-process checkpoint (the reference's state) on the ranks
        _, back = CheckpointManager(src).restore(device="cpu")
        with mesh_context(mesh):
            lp, lo = step.local_state(back["params"], back["opt"])
            wp, wo = step.whole_state(lp, lo)
        want = tp_local_params(tree["params"], cfg, rank, 2, "expert")
        out["restored"] = {
            "local_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(lp), tree_leaves(want))),
            "whole_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(wp) + tree_leaves(wo["master"]),
                tree_leaves(tree["params"]) +
                tree_leaves(tree["opt"]["master"])))}
        return out


    def world4(rank, tmp, src):
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=2, model=1, expert=2, device_type="cpu")
        out = {"steps": {pol: policy_steps(pol, src, mesh)
                         for pol in WIDE}}
        # the round on this data rank's half of the tokens, at ample
        # capacity and under pressure: the rows of both data ranks
        # gathered over the data group, this rank's rows of the result
        from repro_torch.distributed.comm import Collectives
        d = dist.get_rank(mesh.get_group("data"))
        out["data_round"] = {}
        for name, hot in (("ample", False), ("pressure", True)):
            cfg, p, x, r = moe_case(hot)
            n = x.shape[0] // 2
            out["data_round"][name] = round_grads(
                cfg, p, x[d * n:(d + 1) * n], r[d * n:(d + 1) * n],
                Collectives(mesh.get_group("expert")),
                dp=Collectives(mesh.get_group("data")))
        out["data_rank"] = d
        out["expert_rank"] = dist.get_rank(mesh.get_group("expert"))
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


    def shard_oracle(cfg, p, x, r):
        \"\"\"Both shards' legs in one process, the exchange a plain tensor
        permutation: the output and the gradients of (x, router, w1, w3,
        w2), whole.\"\"\"
        from repro_torch.ep.dispatch import (
            _ep_combine, _ep_experts, _ep_pack)
        from repro_torch.ep.plan import lane_capacity
        from repro_torch.models.moe import capacity

        S, E, K = 2, cfg.n_experts, cfg.top_k
        n, El, cf = x.shape[0], cfg.n_experts // 2, cfg.moe_capacity_factor
        Tl = n // S
        C = lane_capacity(Tl, K, S, cf)
        ins = [t.clone().requires_grad_(True)
               for t in (x, p["router"], p["w1"], p["w3"], p["w2"])]
        xg, router, w1, w3, w2 = ins
        packed = [_ep_pack(xg[s * Tl:(s + 1) * Tl], router, E=E, S=S, K=K,
                           C_lane=C, reassign=True) for s in range(S)]
        perm = lambda bufs: [torch.cat([b[s * C:(s + 1) * C] for b in bufs])
                             for s in range(S)]
        recv = perm([sx for sx, _ in packed])
        sl = lambda w, s: w[s * El:(s + 1) * El]
        y_recv = [_ep_experts(recv[s], sl(w1, s), sl(w3, s), sl(w2, s),
                              C_local=capacity(n, E, K, cf), act=cfg.act,
                              use_kernel=True)[0] for s in range(S)]
        back = perm(y_recv)
        y = torch.cat([_ep_combine(back[s], packed[s][1], x.dtype)
                       for s in range(S)])
        g = torch.autograd.grad((y * r).sum(), ins)
        return y.detach(), g


    def diff(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(a, b))


    if __name__ == "__main__":
        tmp, src = sys.argv[1], sys.argv[2]
        from repro_torch.models import moe as MOE

        two = spawn(world2, 2, tmp, src, "2")
        four = spawn(world4, 4, tmp, src, "4")
        result = {"rounds": {}}
        for name, hot in (("ample", False), ("pressure", True)):
            cfg, p, x, r = moe_case(hot)
            got = [two[k][name] for k in range(2)]
            # the ranks' gradients put together: x's is whole on each
            # rank, the router's summed, the experts' stacked
            gx = [np.asarray(g["grads"][0]) for g in got]
            whole = [gx[0], sum(np.asarray(g["grads"][1]) for g in got)] + [
                np.concatenate([np.asarray(g["grads"][i]) for g in got])
                for i in (2, 3, 4)]
            if hot:
                y_want, g_want = shard_oracle(cfg, p, x, r)
            else:
                host = dataclasses.replace(cfg, expert_parallel=False)
                ins = [t.clone().requires_grad_(True)
                       for t in (x, p["router"], p["w1"], p["w3"], p["w2"])]
                y_want = MOE.moe_apply(dict(zip(
                    ("router", "w1", "w3", "w2"), ins[1:])), host, ins[0])
                g_want = torch.autograd.grad((y_want * r).sum(), ins)
                np.savez(os.path.join(tmp, "round_grads.npz"), *whole)
            result["rounds"][name] = {
                "y_err": max(diff(g["y"], y_want.detach().numpy())
                             for g in got),
                "x_grad_ranks_agree": bool(np.array_equal(gx[0], gx[1])),
                "grad_err": diff(whole, [t.numpy() for t in g_want]),
                "grad_scale": max(float(t.abs().max()) for t in g_want),
                "fwd": [g["fwd"] for g in got],
                "bwd": [g["bwd"] for g in got],
                "stats": got[0]["stats"]}
        for k in ("whole_equals_local", "no_stats_counts", "stats_spawns",
                  "remat", "trainer", "restored"):
            result[k] = [two[r][k] for r in range(2)]
        steps = {}
        for where, got, pols in (("e2d1", two, POLICIES),
                                 ("e2d2", four, WIDE)):
            for pol in pols:
                one = policy_steps(pol, src, None)
                ranks = [got[r]["steps"][pol] for r in range(len(got))]
                np.savez(os.path.join(tmp, f"params_{where}_{pol}.npz"),
                         *ranks[0]["params"])
                steps[f"{where}_{pol}"] = {
                    "ranks_agree": max(diff(ranks[0]["params"],
                                            x["params"]) for x in ranks),
                    "mesh_free_err": diff(ranks[0]["params"],
                                          one["params"]),
                    "grad_norm": [x["grad_norm"] for x in ranks],
                    "mesh_free_grad_norm": one["grad_norm"],
                    "skipped": [x["skipped"] for x in ranks],
                    "collectives": [x["collectives"] for x in ranks],
                    "ep_collectives": [x["ep_collectives"] for x in ranks]}
        result["steps"] = steps
        # (expert 2, data 2): the data ranks' rows of the round put
        # together against the round over the whole matrix (the
        # reference's layout: its shard_map hands each expert shard T/S
        # rows of the global batch) — under pressure the two-shard oracle
        # over all the rows, at ample capacity the single-host port; the
        # gradients assembled: x's rows by data rank, the router's summed
        # over all four ranks, each expert rank's experts summed over the
        # data ranks
        result["data_round"] = {}
        for name, hot in (("ample", False), ("pressure", True)):
            cfg, p, x, r = moe_case(hot)
            at = {(four[k]["expert_rank"], four[k]["data_rank"]):
                  four[k]["data_round"][name] for k in range(4)}
            arr = lambda s, d, i: np.asarray(at[(s, d)]["grads"][i])
            y = np.concatenate([np.asarray(at[(0, d)]["y"])
                                for d in range(2)])
            whole = [np.concatenate([arr(0, d, 0) for d in range(2)]),
                     sum(arr(s, d, 1) for s in range(2) for d in range(2))]
            whole += [np.concatenate([arr(s, 0, i) + arr(s, 1, i)
                                      for s in range(2)]) for i in (2, 3, 4)]
            if hot:
                y_want, g_want = shard_oracle(cfg, p, x, r)
            else:
                host = dataclasses.replace(cfg, expert_parallel=False)
                ins = [t.clone().requires_grad_(True)
                       for t in (x, p["router"], p["w1"], p["w3"], p["w2"])]
                y_want = MOE.moe_apply(dict(zip(
                    ("router", "w1", "w3", "w2"), ins[1:])), host, ins[0])
                g_want = torch.autograd.grad((y_want * r).sum(), ins)
                np.savez(os.path.join(tmp, "data_round_grads.npz"), *whole)
            result["data_round"][name] = {
                "whole_err": diff(y, y_want.detach().numpy()),
                "expert_ranks_agree": all(
                    np.array_equal(at[(0, d)]["y"], at[(1, d)]["y"]) and
                    np.array_equal(arr(0, d, 0), arr(1, d, 0))
                    for d in range(2)),
                "grad_err": diff(whole, [t.numpy() for t in g_want]),
                "scale": float(y_want.abs().max()),
                "grad_scale": max(float(t.abs().max()) for t in g_want),
                "fwd": [g["fwd"] for g in at.values()],
                "bwd": [g["bwd"] for g in at.values()],
                "dp_fwd": [g["dp_fwd"] for g in at.values()],
                "dp_bwd": [g["dp_bwd"] for g in at.values()]}
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.tree import tree_leaves
        _, back = CheckpointManager(os.path.join(tmp, "ckpt_ep")).restore(
            device="cpu")
        result["to_one_process"] = [
            all(np.array_equal(a, b.numpy()) for a, b in zip(
                two[r]["saved"]["params"] + two[r]["saved"]["master"],
                tree_leaves(back["params"]) +
                tree_leaves(back["opt"]["master"])))
            for r in range(2)]
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
    single-device jitted ``afe`` step taken ``STEPS`` more times (the oracle: without a mesh its
    ``moe_apply`` takes the single-host dispatch); and ``jax.grad`` of its
    single-host ``moe_apply`` on the round tests' weights."""
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

    # The state the steps start from is the reference's after one step
    # from its init (as ``tests/test_torch_train.py``'s): from init,
    # AdamW's first update is lr·g/(|g| + eps), which turns fp32 rounding
    # in a gradient element near zero into a difference of up to lr (the
    # mesh-free port against the reference: 4.0e-5 at one embedding
    # element whose gradient is ~1e-9).
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, ocfg)
    jp, js, _ = jstep(jp, js, {k: jnp.asarray(v)
                               for k, v in batch_of(0).items()})
    batch = batch_of(1)
    src = tmp_path_factory.mktemp("ep_state")
    with CheckpointManager(str(src)) as mgr:
        mgr.save(0, {"params": bridge.to_torch(jp, "cpu"),
                     "opt": bridge.to_torch(js, "cpu"),
                     "batch": {k: torch.tensor(v) for k, v in batch.items()}},
                 blocking=True)
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
            "params": [np.asarray(a, np.float32)
                       for a in jax.tree.leaves(jp)],
            "round_grads": [np.asarray(gx)] + [
                np.asarray(gp[k]) for k in ("router", "w1", "w3", "w2")]}


@pytest.fixture(scope="module")
def ep_results(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_train_ranks")
    script = tmp / "ep_train_ranks.py"
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
            for key in res["steps"]:
                with np.load(tmp / f"params_{key}.npz") as z:
                    res["steps"][key]["params"] = [
                        z[f"arr_{i}"] for i in range(len(z.files))]
            for key, name in (("round_grads", "round_grads"),
                              ("data_round_grads", "data_round_grads")):
                with np.load(tmp / f"{name}.npz") as z:
                    res[key] = [z[f"arr_{i}"] for i in range(len(z.files))]
            return res
    raise AssertionError("no RESULT line:\n" + out.stdout)


def _counts(**kw):
    return dict(dict.fromkeys(KINDS, 0), **kw)


# ---------------------------------------------------------------------------
# The round under autograd
# ---------------------------------------------------------------------------


def test_round_grads_match_single_host(ep_results):
    """Ample capacity: the EP round's output and gradients equal the
    single-host port's (x's gradient whole and alike on both ranks)."""
    r = ep_results["rounds"]["ample"]
    assert r["y_err"] <= 2e-5 and r["x_grad_ranks_agree"]
    assert r["grad_err"] <= 2e-5, r["grad_err"]
    assert r["stats"] == {}


def _data_round_counts(r):
    """The data round's collectives on each of the 4 ranks: the expert
    group's as on a data axis of 1 (two all-to-alls and the output
    all-gather each way), the data group's one all-gather of the token
    rows forward and nothing backward (the gather's backward is a
    slice)."""
    assert r["fwd"] == [_counts(all_to_all=2, all_gather=1)] * 4
    assert r["bwd"] == [_counts(all_to_all=2, all_gather=1)] * 4
    assert r["dp_fwd"] == [_counts(all_gather=1)] * 4
    assert r["dp_bwd"] == [_counts()] * 4


def test_data2_round_under_pressure_takes_the_whole_batch(ep_results):
    """At ``(expert 2, data 2)`` under pressure (a hot router, capacity
    factor 1) the data ranks' rows of the EP round, put together, equal
    the two-shard oracle over the whole token matrix: the output within
    1e-6, the gradients within 1e-6 of their largest value (the data
    ranks' partial weight gradients are summed in another order).  Each
    expert shard packs ``T/S`` rows of the whole batch into lanes of
    ``lane_capacity(T/S)`` against expert capacity
    ``capacity(T)``, as the reference's ``shard_map`` does (it cannot run
    here, ROADMAP Queue 3 B; the oracle stands for it).  Before fault N's
    repair each data rank's round took only its ``T/D`` rows, and the
    whole-matrix oracle differed by 1.4653 of 4.0532."""
    r = ep_results["data_round"]["pressure"]
    assert r["whole_err"] <= 1e-6, r
    assert r["grad_err"] <= 1e-6 * r["grad_scale"], r
    assert r["expert_ranks_agree"]
    _data_round_counts(r)


def test_data2_round_at_ample_capacity_matches_reference(ep_results,
                                                          reference):
    """At ample capacity the ``(expert 2, data 2)`` round, rows and
    gradients assembled over the four ranks, equals the single-host port
    and the reference's ``jax.grad`` of its single-host ``moe_apply``
    within 2e-5, as the ``(expert 2, data 1)`` round does."""
    r = ep_results["data_round"]["ample"]
    assert r["whole_err"] <= 2e-5 and r["grad_err"] <= 2e-5, r
    assert r["expert_ranks_agree"]
    _data_round_counts(r)
    for got, want in zip(ep_results["data_round_grads"],
                         reference["round_grads"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_round_grads_match_reference(ep_results, reference):
    """The same gradients against the reference's ``jax.grad`` of its
    single-host ``moe_apply`` on the same weights."""
    for got, want in zip(ep_results["round_grads"],
                         reference["round_grads"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_round_grads_under_pressure_match_shard_oracle(ep_results):
    """A hot router at capacity factor 1 (DLBC reassigns before the
    exchange): the gradients equal both shards' legs run in one process
    with the exchange as a plain tensor permutation."""
    r = ep_results["rounds"]["pressure"]
    assert r["stats"]["reassigned"] > 0
    assert r["y_err"] <= 1e-6 and r["x_grad_ranks_agree"]
    assert r["grad_err"] <= 1e-6, r["grad_err"]


@pytest.mark.parametrize("case", ["ample", "pressure"])
def test_round_collective_counts(ep_results, case):
    """Forward: the dispatch and combine all-to-alls and the output
    all-gather (and the stats' all-reduce when asked for); backward: the
    two all-to-alls again and the token block's all-gather, the output
    gather's backward issuing nothing."""
    r = ep_results["rounds"][case]
    stats = 1 if case == "pressure" else 0
    assert r["fwd"] == [_counts(all_to_all=2, all_gather=1,
                                all_reduce=stats)] * 2
    assert r["bwd"] == [_counts(all_to_all=2, all_gather=1)] * 2


def test_round_takes_whole_or_local_experts(ep_results):
    """Whole expert weights (sliced inside the round) and this rank's E/S
    give the same output; without stats no all-reduce is issued."""
    assert ep_results["whole_equals_local"] == [True, True]
    assert ep_results["no_stats_counts"] == [
        _counts(all_to_all=4, all_gather=2)] * 2
    assert ep_results["stats_spawns"] == [T * 2.0] * 2


# ---------------------------------------------------------------------------
# The train step per policy
# ---------------------------------------------------------------------------

STEP_CASES = [f"e2d1_{p}" for p in POLICIES] + [f"e2d2_{p}" for p in WIDE]


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_matches_mesh_free_and_reference(ep_results, reference, case):
    r = ep_results["steps"][case]
    n = 2 if case.startswith("e2d1") else 4
    assert r["ranks_agree"] == 0.0 and r["skipped"] == [[0] * STEPS] * n
    assert r["mesh_free_err"] <= 2e-5
    gj = reference["grad_norm"]
    for g in r["grad_norm"]:
        assert abs(g[-1] - gj) <= 2e-5 * gj
        assert all(abs(a - b) <= 2e-5 * b
                   for a, b in zip(g, r["mesh_free_grad_norm"]))
    assert len(r["params"]) == len(reference["params"])
    for got, want in zip(r["params"], reference["params"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _data_collectives(policy, data):
    """The data axis's collectives per step over one expert rank's local
    param tree, as ``tests/test_torch_tp.py`` derives them."""
    cfg = _t_cfg()
    shapes = tp_local_params(TM.param_shapes(cfg), cfg, 0, 2, "expert")
    leaves = tree_leaves(shapes)
    with mesh_context(MeshShape(("expert", "data", "model"), (2, data, 1))):
        dims = tree_leaves(fsdp_layout(shapes, cfg, 0, data).dims)
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


def _ep_collectives(n_layers):
    """The expert axis's collectives per step under ``remat``: per MoE
    layer and microbatch, the forward's two all-to-alls and output
    all-gather, the recompute's two all-to-alls (it stops at the layer's
    last saved tensor, the gate-combine's input, so the output gather is
    not re-issued), and the backward's two all-to-alls and token
    all-gather; per step, the router's gradient sum and the norm's."""
    per = MICRO * n_layers
    return _counts(all_to_all=6 * per, all_gather=2 * per, all_reduce=2)


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_collective_counts(ep_results, case):
    """The data and expert axes' collectives per step, exactly.  On
    ``(expert 2, data 2)`` the EP round gathers the token rows of both
    data ranks once per MoE layer and forward, remat's recompute included
    (fault N's repair), on top of the policy's own."""
    r = ep_results["steps"][case]
    data = 1 if case.startswith("e2d1") else 2
    want = _data_collectives(case.split("_", 1)[1], data)
    if data > 1:
        want["all_gather"] += 2 * MICRO * _t_cfg().n_layers
    ep = _ep_collectives(_t_cfg().n_layers)
    for counts, epc in zip(r["collectives"], r["ep_collectives"]):
        assert counts == [want] * STEPS
        assert epc == [ep] * STEPS


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["on", "on_thread", "no_context"])
def test_remat_grads_bitwise_and_recompute_takes_ep(ep_results, case):
    """Gradients with ``remat`` are bitwise those without; the recompute
    re-issues each layer's two exchanges (one microbatch, 2 layers), also
    with the backward on a new thread, where the mesh context is unset."""
    L = _t_cfg().n_layers
    for r in ep_results["remat"]:
        off, on = r["off"], r[case]
        assert on["bitwise"] and off["bitwise"]
        assert off["fwd"] == on["fwd"] == _counts(all_to_all=2 * L,
                                                  all_gather=L)
        assert off["bwd"] == _counts(all_to_all=2 * L, all_gather=L)
        assert on["bwd"] == _counts(all_to_all=4 * L, all_gather=L)


# ---------------------------------------------------------------------------
# Checkpoints and the trainer
# ---------------------------------------------------------------------------


def test_expert2_checkpoint_restores_in_one_process(ep_results):
    assert ep_results["to_one_process"] == [True, True]


def test_one_process_checkpoint_restores_on_expert2(ep_results):
    for r in ep_results["restored"]:
        assert r == {"local_bitwise": True, "whole_bitwise": True}


def test_trainer_resumes_on_expert2(ep_results):
    """``run_training`` on ``(expert 2, data 1)`` (``afe``: whole
    checkpoints) crashes after step 3, resumes from its step-2
    checkpoint, and ends where an uninterrupted run does."""
    for r in ep_results["trainer"]:
        assert r["crashed"] and r["resumed_from"] == 2 and \
            r["completed"] == 4
        assert r["last_loss_diff"] == 0.0 and r["grad_norm_diff"] == 0.0


# ---------------------------------------------------------------------------
# In process: the expert layout
# ---------------------------------------------------------------------------


def test_expert_local_params_assemble_bitwise():
    """The reference's weights cut to each expert rank's E/S experts and
    put back together are the bridged tree bit for bit; only the experts
    split, the router is summed, the rest whole."""
    cfg = _t_cfg()
    params = bridge.to_torch(JM.init_params(_cfg(), jax.random.PRNGKey(0)),
                             "cpu")
    pieces = [tp_local_params(params, cfg, r, 2, "expert")
              for r in range(2)]
    moe = pieces[0]["layers"]["moe"]
    assert moe["w1"].shape[-3] == cfg.n_experts // 2
    assert moe["router"].shape == params["layers"]["moe"]["router"].shape
    back = tp_assemble(pieces, cfg, "expert")
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    summed = ep_summed(TM.param_shapes(cfg), cfg, 2)
    assert [k for k, v in summed["layers"]["moe"].items() if v] == \
        ["router"]
    assert sum(tree_leaves(summed)) == 1


def test_expert_owned_leaves_count_every_element_once():
    cfg = _t_cfg()
    shapes = TM.param_shapes(cfg)
    total = sum(t.numel() for t in tree_leaves(shapes))
    counted = sum(t.numel()
                  for r in range(2)
                  for t, own in zip(tree_leaves(tp_local_params(
                      shapes, cfg, r, 2, "expert")), tree_leaves(tp_owned(
                          shapes, cfg, r, 2, "expert"))) if own)
    assert counted == total
