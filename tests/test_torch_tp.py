"""Tensor parallelism in the port (the ``"model"`` mesh axis) on the CPU.

One module-scoped subprocess spawns gloo ranks meeting at a ``file://``
store under the test's temporary directory (as
``tests/test_torch_distributed.py`` does); any rank's traceback fails it.

* **(data 2, model 2), 4 ranks** — phi3-mini SMOKE (fp32) from the
  reference's init and batch: each of the four sync policies' step on the
  mesh has the ``grad_norm`` and, gathered whole, the params of the
  reference's single-device jitted step (the oracle of the reference's
  ``tests/test_distributed.py``) within 2e-5; the data-axis collective
  counts are the policies' own (derived from the local param tree and the
  bucket plan), the model-axis all-reduces counted apart; the trainer
  crashes, resumes from its whole checkpoint on the mesh and ends where an
  uninterrupted run does.
* **(data 1, model 2), 2 ranks** — every family's SMOKE config (phi3
  dense, granite moe with E over the model axis and a copy with E = 3, so
  that d_ff goes over it, falcon-mamba ssm, hymba hybrid and a copy whose
  heads do not divide, whisper encdec, llama-vision vlm, and a phi3 copy
  with one KV head shared by both ranks), sequence-parallel at S 16: loss
  and every gradient (the leaves that see one rank's rows summed over the
  ranks, as the train step sums them) equal to the one-process port
  within 2e-5; the ranks route every MoE token
  alike; ``tp_gather_params`` of each rank's ``tp_local_params`` is the
  whole tree bit for bit; a checkpoint written on the ranks restores in
  one process bit for bit, and a one-process checkpoint restores on the
  ranks to the same shards.
* **In process** — the reference's weights through ``bridge.to_torch_tp``
  → ``tp_assemble`` are bitwise the bridged tree on every architecture;
  the norm's ownership flags count every element of the whole tree once.
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
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, fsdp_layout, mesh_context, tp_assemble, tp_local_config,
    tp_local_params, tp_owned,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sched import FixedCapacity  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3-mini-3.8b"
POLICIES = ("unopt", "lc", "afe", "afe_bucket")
SEQ, BATCH, MICRO, N_BUCKETS = 16, 8, 2, 4
#: the 2-rank family cases: (arch, config fields replaced)
CASES = {
    "dense": ("phi3-mini-3.8b", {}),
    "moe_experts": ("granite-moe-1b-a400m", {}),
    "moe_ff": ("granite-moe-1b-a400m", {"n_experts": 3}),
    "ssm": ("falcon-mamba-7b", {}),
    "hybrid": ("hymba-1.5b", {}),
    "hybrid_whole_attn": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "dense_shared_kv": ("phi3-mini-3.8b", {"n_kv_heads": 1}),
}


# ---------------------------------------------------------------------------
# The subprocess: 4 ranks at (data 2, model 2), then 2 at (data 1, model 2)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    POLICIES = ("unopt", "lc", "afe", "afe_bucket")
    SEQ, BATCH, MICRO, N_BUCKETS = 16, 8, 2, 4
    CASES = json.loads(sys.argv[3])


    def np_leaves(tree):
        from repro_torch.tree import tree_leaves
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]


    def phi3(src):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.train.optimizer import AdamWConfig

        cfg = dataclasses.replace(get_config("phi3-mini-3.8b", smoke=True),
                                  dtype="float32")
        _, tree = CheckpointManager(src).restore(device="cpu")
        batch = {k: v.long() for k, v in tree.pop("batch").items()}
        return (cfg, ShapeConfig("t", SEQ, BATCH, "train",
                                 microbatches=MICRO),
                AdamWConfig(lr=1e-3, warmup_steps=2), tree, batch)


    def policy_step(policy, src, mesh):
        \"\"\"One step of ``policy`` on ``mesh`` from the reference's state;
        the params and optimizer state gathered whole.\"\"\"
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train import train_step as TT

        cfg, shape, ocfg, tree, batch = phi3(src)
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy=policy, q_chunk=8, k_chunk=8,
                n_buckets=N_BUCKETS), ocfg)
            params, opt = step.local_state(tree["params"], tree["opt"])
            params, opt, m = step(params, opt, batch)
            params, opt = step.whole_state(params, opt)
        return {"params": np_leaves(params),
                "opt": {k: np_leaves(opt[k]) for k in ("m", "v", "master")},
                "grad_norm": float(m["grad_norm"]),
                "skipped": int(m["nonfinite_skipped"]),
                "collectives": m["collectives"],
                "tp_collectives": m["tp_collectives"]}


    def trainer_resume(mesh, src, base):
        \"\"\"``run_training`` (policy ``afe``) on the mesh: a run that
        crashes after step 3 of 4 (checkpoints every 2), the same run again
        (it resumes from step 2), and an uninterrupted run.\"\"\"
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train.trainer import (
            SimulatedFailure, TrainerConfig, run_training)
        from repro_torch.train.train_step import StepConfig

        cfg, shape, ocfg, _, _ = phi3(src)
        scfg = StepConfig(policy="afe", q_chunk=8, k_chunk=8)

        def run(d, **kw):
            dist.barrier()
            with mesh_context(mesh):
                return run_training(cfg, shape, TrainerConfig(
                    steps=4, ckpt_every=2, ckpt_dir=d, **kw), scfg, ocfg,
                    device="cpu")

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


    def case(name):
        \"\"\"A family's SMOKE config (fp32), port weights and a batch, all
        from seeds.\"\"\"
        from repro_torch.configs import get_config
        from repro_torch.models import model as TM

        arch, rep = CASES[name]
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", **rep)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, SEQ + 1), generator=g)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family in ("encdec", "vlm"):
            key, n = ("enc_frames", cfg.enc_seq) \\
                if cfg.family == "encdec" else ("vis_embed", cfg.vis_seq)
            batch[key] = torch.randn(2, n, cfg.d_model, generator=g)
        return cfg, params, batch


    def loss_grads(cfg, params, batch):
        \"\"\"Loss, gradients (numpy, leaf order) and each MoE layer's
        routing decisions (ids, keep) of one ``loss_fn`` backward.\"\"\"
        from repro_torch.models import model as TM
        from repro_torch.models import moe as M
        from repro_torch.tree import tree_leaves, tree_unflatten

        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(params)]
        routes, real = [], M.dispatch_combine

        def spy(x, gates, ids, pos, keep, *a, **k):
            routes.append([ids.tolist(), keep.tolist()])
            return real(x, gates, ids, pos, keep, *a, **k)

        M.dispatch_combine = spy
        try:
            loss = TM.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                              q_chunk=8, k_chunk=8, ssm_chunk=8)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            M.dispatch_combine = real
        return float(loss.detach()), [g.numpy().copy() for g in grads], \\
            routes


    def world4(rank, tmp, src):
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=2, model=2, device_type="cpu")
        out = {pol: policy_step(pol, src, mesh) for pol in POLICIES}
        out["trainer"] = trainer_resume(mesh, src,
                                        os.path.join(tmp, "trainer"))
        return out


    def world2(rank, tmp, src):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import (
            mesh_context, sp_summed, tp_gather_params, tp_local_params)
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train import train_step as TT
        from repro_torch.tree import tree_leaves

        mesh = make_test_mesh(data=1, model=2, device_type="cpu")
        tpc = Collectives(mesh.get_group("model"))
        out = {"cases": {}}
        for name in CASES:
            cfg, params, batch = case(name)
            local = tp_local_params(params, cfg, rank, 2)
            with mesh_context(mesh):
                loss, grads, routes = loss_grads(cfg, local, batch)
            enc = batch["enc_frames"].shape[1] if "enc_frames" in batch \
                else 0
            for i, f in enumerate(tree_leaves(sp_summed(local, 2, SEQ,
                                                        enc))):
                if f:
                    grads[i] = tpc.all_reduce(torch.from_numpy(
                        grads[i])).numpy()
            back = tp_gather_params(local, cfg, tpc)
            out["cases"][name] = {
                "loss": loss, "grads": grads, "routes": routes,
                "gather_bitwise": all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(back), tree_leaves(params)))}

        # a checkpoint written on the ranks (one afe step's whole state)
        cfg, shape, ocfg, tree, batch = phi3(src)
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy="afe", q_chunk=8, k_chunk=8), ocfg)
            params, opt = step.local_state(tree["params"], tree["opt"])
            params, opt, _ = step(params, opt, batch)
            whole_p, whole_o = step.whole_state(params, opt)
        with CheckpointManager(os.path.join(tmp, "ckpt_tp")) as mgr:
            mgr.save(1, {"params": whole_p, "opt": whole_o}, blocking=True)
        out["saved"] = {"params": np_leaves(whole_p),
                        "master": np_leaves(whole_o["master"])}

        # the one-process checkpoint (the reference's state) on the ranks
        _, back = CheckpointManager(src).restore(device="cpu")
        with mesh_context(mesh):
            lp, lo = step.local_state(back["params"], back["opt"])
            wp, wo = step.whole_state(lp, lo)
        want = tp_local_params(tree["params"], cfg, rank, 2)
        out["restored"] = {
            "local_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(lp), tree_leaves(want))),
            "whole_bitwise": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(wp) + tree_leaves(wo["master"]),
                tree_leaves(tree["params"]) +
                tree_leaves(tree["opt"]["master"])))}
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


    def diff(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


    if __name__ == "__main__":
        tmp, src = sys.argv[1], sys.argv[2]
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import tp_assemble
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves, tree_unflatten

        four = spawn(world4, 4, tmp, src, "4")
        two = spawn(world2, 2, tmp, src, "2")
        result = {"four": {pol: {
            "ranks_agree": max(diff(four[0][pol]["params"],
                                    four[r][pol]["params"])
                               for r in range(4)),
            "grad_norm": [four[r][pol]["grad_norm"] for r in range(4)],
            "skipped": [four[r][pol]["skipped"] for r in range(4)],
            "collectives": [four[r][pol]["collectives"] for r in range(4)],
            "tp_collectives": [four[r][pol]["tp_collectives"]
                               for r in range(4)]}
            for pol in POLICIES}}
        for pol in POLICIES:
            np.savez(os.path.join(tmp, f"params_{pol}.npz"),
                     *four[0][pol]["params"])
        result["trainer"] = [four[r]["trainer"] for r in range(4)]

        result["cases"] = {}
        for name in CASES:
            cfg, params, batch = case(name)
            loss, grads, routes = loss_grads(cfg, params, batch)
            got = [two[r]["cases"][name] for r in range(2)]
            like = tree_leaves(params)
            pieces = [tree_unflatten(params, [torch.from_numpy(g) for g in
                                              c["grads"]]) for c in got]
            whole = [g.numpy() for g in tree_leaves(tp_assemble(pieces,
                                                                cfg))]
            result["cases"][name] = {
                "loss": [c["loss"] for c in got], "single_loss": loss,
                "grad_err": max(float(np.abs(a - b).max()) for a, b in
                                zip(whole, grads)),
                "grad_scale": max(float(np.abs(b).max()) for b in grads),
                "leaves": len(like),
                "routes_agree": got[0]["routes"] == got[1]["routes"],
                "routed_layers": len(got[0]["routes"]),
                "routes_single": got[0]["routes"] == routes,
                "gather_bitwise": [c["gather_bitwise"] for c in got]}

        _, back = CheckpointManager(os.path.join(tmp, "ckpt_tp")).restore(
            device="cpu")
        result["ckpt"] = {
            "to_one_process": [
                all(np.array_equal(a, b.numpy()) for a, b in zip(
                    two[r]["saved"]["params"] + two[r]["saved"]["master"],
                    tree_leaves(back["params"]) +
                    tree_leaves(back["opt"]["master"])))
                for r in range(2)],
            "from_one_process": [two[r]["restored"] for r in range(2)]}
        print("RESULT " + json.dumps(result))
""")


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's phi3-mini SMOKE (fp32) init, optimizer state and a
    batch, written as a port checkpoint for the subprocess, and its
    single-device jitted ``afe`` step from them (the oracle)."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    shape = ShapeConfig("t", SEQ, BATCH, "train", microbatches=MICRO)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, ocfg)
    batch = _batch(cfg, 0)
    src = tmp_path_factory.mktemp("tp_state")
    with CheckpointManager(str(src)) as mgr:
        mgr.save(0, {"params": bridge.to_torch(jp, "cpu"),
                     "opt": bridge.to_torch(js, "cpu"),
                     "batch": {k: torch.tensor(v) for k, v in batch.items()}},
                 blocking=True)
    step, _ = JT.build_train_step(cfg, shape, JT.StepConfig(
        policy="afe", q_chunk=8, k_chunk=8), ocfg)
    jp2, _, jm = jax.jit(step)(jp, js, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    return {"src": src, "grad_norm": float(jm["grad_norm"]),
            "params": [np.asarray(x, np.float32)
                       for x in jax.tree.leaves(jp2)]}


@pytest.fixture(scope="module")
def tp_results(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    script = tmp / "tp_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(tmp),
                          str(reference["src"]), json.dumps(CASES)],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[len("RESULT "):])
            for pol in POLICIES:
                with np.load(tmp / f"params_{pol}.npz") as z:
                    res["four"][pol]["params"] = [z[f"arr_{i}"] for i in
                                                  range(len(z.files))]
            return res
    raise AssertionError("no RESULT line:\n" + out.stdout)


# ---------------------------------------------------------------------------
# (data 2, model 2): the policies against the reference's step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_data2_model2_step_matches_reference(tp_results, reference, policy):
    r = tp_results["four"][policy]
    assert r["ranks_agree"] == 0.0 and r["skipped"] == [0, 0, 0, 0]
    gj = reference["grad_norm"]
    for g in r["grad_norm"]:
        assert abs(g - gj) <= 2e-5 * gj
    assert len(r["params"]) == len(reference["params"])
    for got, want in zip(r["params"], reference["params"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _local_shapes(cfg):
    return tp_local_params(TM.param_shapes(cfg), cfg, 0, 2)


def _expected_collectives(policy):
    """The data axis's collectives per step, as
    ``tests/test_torch_distributed.py`` derives them, over one model
    rank's local param tree (whose sizes set ``afe_bucket``'s bins)."""
    cfg = dataclasses.replace(t_get_config(ARCH, smoke=True),
                              dtype="float32")
    shapes = _local_shapes(cfg)
    leaves = tree_leaves(shapes)
    with mesh_context(MeshShape(("data", "model"), (2, 2))):
        dims = tree_leaves(fsdp_layout(shapes, cfg, 0, 2).dims)
    sharded = [i for i, d in enumerate(dims) if d is not None]
    n, ns = len(leaves), len(sharded)
    out = dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                         "all_to_all", "send_recv"), 0)
    if policy == "unopt":
        out["all_reduce"] = MICRO * n
    elif policy == "lc":
        out["all_reduce"] = n
    elif policy == "afe":
        out.update(reduce_scatter=ns, all_gather=ns, all_reduce=n - ns + 1)
    else:
        bins = TT._bucket_bins(leaves, N_BUCKETS, "dlbc",
                               FixedCapacity(idle_n=N_BUCKETS - 1,
                                             total_n=N_BUCKETS))
        sh_bins = [[i for i in b if dims[i] is not None] for b in bins]
        out["reduce_scatter"] = sum(1 for b in sh_bins if b)
        out["all_reduce"] = (1 if n > ns else 0) + 1
        out["all_gather"] = sum(len({leaves[i].dtype for i in b})
                                for b in sh_bins)
    return out


def _expected_tp_collectives(cfg):
    """The model axis's collectives per step of a dense config under
    ``remat``, sequence-parallel (the model axis divides S).  Per
    microbatch and layer ``L`` of them:

    * forward: the embedding's reduce-scatter onto the sequence blocks;
      per layer the all-gathers of attention's and the MLP's normed
      inputs and the reduce-scatters of their outputs; the head input's
      all-gather; the cross entropy's three all-reduces (max, sum of
      exponentials, gold logit) — ``2L + 1`` all-gathers, ``2L + 1``
      reduce-scatters, 3 all-reduces;
    * the layer's recompute (it stops at the layer's last saved tensor,
      the MLP's ``w2`` input, so the MLP's output reduce-scatter is not
      re-issued): attention's all-gather and reduce-scatter and the MLP's
      all-gather — ``2L`` all-gathers, ``L`` reduce-scatters;
    * backward: each reduce-scatter's gradient all-gathered (``2L`` and
      the embedding's 1), each all-gather's reduce-scattered (``2L`` and
      the head input's 1).

    So ``6L + 2`` all-gathers, ``5L + 2`` reduce-scatters and 3
    all-reduces per microbatch (before sequence parallelism: ``5 + 5L``
    all-reduces).  Per step two more all-reduces: the sum of the norms'
    partial gradients over the model ranks and the gradient norm's."""
    L = cfg.n_layers
    return dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0) | {
        "all_reduce": MICRO * 3 + 2,
        "reduce_scatter": MICRO * (5 * L + 2),
        "all_gather": MICRO * (6 * L + 2)}


@pytest.mark.parametrize("policy", POLICIES)
def test_data2_model2_collective_counts(tp_results, policy):
    cfg = t_get_config(ARCH, smoke=True)
    r = tp_results["four"][policy]
    for counts, tp in zip(r["collectives"], r["tp_collectives"]):
        assert counts == _expected_collectives(policy)
        assert tp == _expected_tp_collectives(cfg)


def test_data2_model2_trainer_resumes(tp_results):
    """``run_training`` on the (data 2, model 2) mesh (``afe``: whole
    checkpoints gathered from the FSDP pieces of each model rank's shards)
    crashes after step 3, resumes from its step-2 checkpoint, and ends
    where an uninterrupted run does."""
    for r in tp_results["trainer"]:
        assert r["crashed"] and r["resumed_from"] == 2 and \
            r["completed"] == 4
        assert r["last_loss_diff"] == 0.0 and r["grad_norm_diff"] == 0.0


# ---------------------------------------------------------------------------
# (data 1, model 2): every family against the one-process port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_loss_and_grads_match_one_process(tp_results, name):
    r = tp_results["cases"][name]
    for loss in r["loss"]:
        assert abs(loss - r["single_loss"]) <= 2e-5
    assert r["grad_err"] <= 2e-5, r


@pytest.mark.parametrize("name", ["moe_experts", "moe_ff"])
def test_model2_ranks_route_alike(tp_results, name):
    r = tp_results["cases"][name]
    assert r["routed_layers"] == 4     # 2 layers, each again in its remat
    assert r["routes_agree"] and r["routes_single"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_gather_params_is_bitwise(tp_results, name):
    assert tp_results["cases"][name]["gather_bitwise"] == [True, True]


def test_model2_checkpoint_restores_in_one_process(tp_results):
    assert tp_results["ckpt"]["to_one_process"] == [True, True]


def test_one_process_checkpoint_restores_on_model2(tp_results):
    for r in tp_results["ckpt"]["from_one_process"]:
        assert r == {"local_bitwise": True, "whole_bitwise": True}


# ---------------------------------------------------------------------------
# In process: the compute layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_params_assemble_bitwise(arch):
    """The reference's SMOKE weights cut to each rank's compute shards
    (``bridge.to_torch_tp``), put back together by ``tp_assemble``, are
    the bridged tree bit for bit; every piece is contiguous."""
    cfg = t_get_config(arch, smoke=True)
    jp = JM.init_params(get_config(arch, smoke=True), jax.random.PRNGKey(0))
    params = bridge.to_torch(jp, "cpu")
    pieces = [bridge.to_torch_tp(jp, cfg, r, 2, "cpu") for r in range(2)]
    for p in pieces:
        assert all(t.is_contiguous() for t in tree_leaves(p))
    back = tp_assemble(pieces, cfg)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_owned_leaves_count_every_element_once(name):
    """Summed over the model ranks, the elements of the leaves each rank
    owns (``tp_owned``: what the gradient norm counts) are the whole
    tree's."""
    arch, rep = CASES[name]
    cfg = dataclasses.replace(t_get_config(arch, smoke=True), **rep)
    shapes = TM.param_shapes(cfg)
    total = sum(t.numel() for t in tree_leaves(shapes))
    counted = sum(t.numel()
                  for r in range(2)
                  for t, own in zip(tree_leaves(tp_local_params(
                      shapes, cfg, r, 2)), tree_leaves(tp_owned(
                          shapes, cfg, r, 2))) if own)
    assert counted == total


def test_in_proj_keeps_each_ranks_xi_and_z():
    """mamba's fused ``in_proj`` (D, 2·Di): rank r holds its slice of
    ``xi`` and its slice of ``z``, not one half of the fused columns."""
    cfg = t_get_config("falcon-mamba-7b", smoke=True)
    w = torch.arange(2 * cfg.d_inner, dtype=torch.float32).expand(
        cfg.d_model, -1)
    tree = {"layers": {"ssm": {"in_proj": {"w": w}}}}
    di, h = cfg.d_inner, cfg.d_inner // 2
    for r in range(2):
        got = tp_local_params(tree, cfg, r, 2)["layers"]["ssm"]["in_proj"]
        xi, z = torch.chunk(got["w"][0], 2)
        assert torch.equal(xi, torch.arange(r * h, (r + 1) * h).float())
        assert torch.equal(z, torch.arange(di + r * h,
                                           di + (r + 1) * h).float())


def _shapes_by_path(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _shapes_by_path(tree[k], f"{path}/{k}").items()}
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_config_has_the_local_params_shapes(name):
    """``tp_local_config(cfg, 2)``'s parameter shapes are each rank's
    compute shards' (``tp_local_params``), but for the vocab-parallel
    embedding and head and the replicated router, which it keeps whole."""
    arch, rep = CASES[name]
    cfg = dataclasses.replace(t_get_config(arch, smoke=True), **rep)
    local = _shapes_by_path(TM.param_shapes(tp_local_config(cfg, 2)))
    for r in range(2):
        cut = _shapes_by_path(tp_local_params(TM.param_shapes(cfg), cfg, r,
                                              2))
        assert sorted(cut) == sorted(local)
        for path, shape in cut.items():
            if path.split("/")[-1] not in ("embed", "lm_head", "router"):
                assert shape == local[path], path
