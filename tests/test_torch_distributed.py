"""Distribution in the port (``repro_torch.distributed``, the policies'
collectives in ``train/train_step.py``, per-rank checkpoints) on the CPU.

* **Spec parity** — for every architecture of the registry (SMOKE and
  full configs, ``dp_shard`` on and off, MoE configs also with
  ``expert_parallel``) and the meshes ``(data 2, model 2)``, ``(expert 2,
  data 2, model 2)`` and ``(pod 2, data 2, model 2)``, the port's
  ``param_specs_tree`` equals the reference's, as tuples.  The reference's
  specs come from the subprocess below, which builds its meshes the way
  its own tests do (``--xla_force_host_platform_device_count=8``).
* **Policies on 2 gloo ranks** — one module-scoped subprocess runs phi3-mini
  SMOKE (the reference's ``test_distributed.py`` model), fp32, from the
  reference's state after one AdamW step (written by the port's
  checkpoint manager, so the ranks also exercise the restore at another
  world size).  On a ``(data 2, model 1)`` mesh each policy's next step
  equals the single-process port step (params, ``grad_norm``, and the
  optimizer state gathered from the ranks' FSDP pieces, within 2e-5);
  on a ``(data 1, model 1)`` mesh, one rank, it is bitwise equal.  The
  collective counts are exact (derived here from the param tree and the
  bucket plan) and follow the reference's ladder.  The ``afe`` step's
  2-rank checkpoint, restored at world size 1, equals the 2-rank state;
  ``run_training`` on the 2 ranks crashes, resumes from its per-rank
  checkpoint and ends where an uninterrupted run does; a model axis of 2
  raises.
* **Single process vs the reference** — each policy's step against the
  reference's, at ``tests/test_torch_train.py``'s tolerances.
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
from repro_torch.configs.base import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, fsdp_layout, mesh_context, param_specs_tree,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sched import FixedCapacity  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3-mini-3.8b"
POLICIES = ("unopt", "lc", "afe", "afe_bucket")
MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "expert2_data2_model2": ((2, 2, 2), ("expert", "data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
SEQ, BATCH, MICRO = 16, 8, 2
N_BUCKETS = 4


def _spec_cases(cfg):
    """(label, config) pairs whose specs are compared."""
    out = [("", cfg)]
    if cfg.n_experts:
        out.append(("+ep", dataclasses.replace(cfg, expert_parallel=True)))
    return out


def _jsonable(specs):
    return json.loads(json.dumps(specs))


# ---------------------------------------------------------------------------
# The subprocess: reference specs (jax, 8 host devices), then 2 gloo ranks
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    WORLD = 2
    POLICIES = ("unopt", "lc", "afe", "afe_bucket")
    SEQ, BATCH, MICRO, N_BUCKETS = 16, 8, 2, 4


    def reference_specs():
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        from repro.configs.registry import ARCH_IDS, get_config
        from repro.distributed.sharding import mesh_context, param_specs_tree
        from repro.models import model as MDL

        meshes = {"data2_model2": ((2, 2), ("data", "model")),
                  "expert2_data2_model2": ((2, 2, 2),
                                           ("expert", "data", "model")),
                  "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
        out = {}
        for mname, (shape, axes) in meshes.items():
            mesh = jax.make_mesh(shape, axes)
            for arch in ARCH_IDS:
                for smoke in (True, False):
                    cfg = get_config(arch, smoke=smoke)
                    cases = [("", cfg)]
                    if cfg.n_experts:
                        cases.append(("+ep", dataclasses.replace(
                            cfg, expert_parallel=True)))
                    for label, c in cases:
                        shapes = MDL.param_shapes(c)
                        for dp in (True, False):
                            with mesh_context(mesh):
                                specs = param_specs_tree(shapes, c,
                                                         dp_shard=dp)
                            specs = jax.tree.map(
                                tuple, specs, is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec))
                            key = f"{mname}|{arch}|{smoke}{label}|{dp}"
                            out[key] = json.loads(json.dumps(specs))
        return out


    def setup(src):
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


    def one_step(policy, src, mesh=None, ckpt=None):
        \"\"\"The policy's step from the checkpointed state, under ``mesh``;
        params whole, optimizer state as this rank holds it.\"\"\"
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train import train_step as TT
        from repro_torch.tree import tree_leaves

        cfg, shape, ocfg, tree, batch = setup(src)
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, shape, TT.StepConfig(
                policy=policy, q_chunk=8, k_chunk=8,
                n_buckets=N_BUCKETS), ocfg)
            params, opt = tree["params"], tree["opt"]
            if step.layout is not None:
                for k in ("m", "v", "master"):
                    opt[k] = step.layout.local_tree(opt[k])
            params, opt, m = step(params, opt, batch)
        if ckpt is not None:
            with CheckpointManager(ckpt) as mgr:
                mgr.save(2, {"params": params, "opt": opt}, blocking=True,
                         splits=step.layout.splits(params))
        np_ = lambda t: [x.detach().numpy().copy() for x in tree_leaves(t)]
        return {"params": np_(params),
                "opt": {k: np_(opt[k]) for k in ("m", "v", "master")},
                "grad_norm": float(m["grad_norm"]),
                "skipped": int(m["nonfinite_skipped"]),
                "collectives": m["collectives"]}


    def trainer_resume(mesh, src, base):
        \"\"\"``run_training`` under the mesh (policy ``afe``): a run that
        crashes after step 3 of 4 (checkpoints every 2), the same run
        again (it resumes from step 2), and an uninterrupted run.\"\"\"
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.train.trainer import (
            SimulatedFailure, TrainerConfig, run_training)
        from repro_torch.train.train_step import StepConfig

        cfg, shape, ocfg, _, _ = setup(src)
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


    def ranks_run(rank, world, src, ckpt):
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.train import train_step as TT

        mesh = make_test_mesh(data=world, model=1, device_type="cpu")
        out = {pol: one_step(pol, src, mesh, ckpt if pol == "afe" and
                              world > 1 else None) for pol in POLICIES}
        if world > 1:
            out["trainer"] = trainer_resume(mesh, src, ckpt + "_trainer")
            cfg, shape, ocfg, _, _ = setup(src)
            tp = make_test_mesh(data=1, model=world, device_type="cpu")
            try:
                with mesh_context(tp):
                    TT.build_train_step(cfg, shape, TT.StepConfig(), ocfg)
                out["model_axis_raises"] = False
            except NotImplementedError as e:
                out["model_axis_raises"] = "tensor-parallel" in str(e)
        return out


    def worker(rank, store, src, ckpt, q):
        try:
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=WORLD)
            q.put((rank, ranks_run(rank, WORLD, src, ckpt)))
        except BaseException:
            q.put((rank, {"error": traceback.format_exc()}))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


    def diff(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


    if __name__ == "__main__":
        tmp, src = sys.argv[1], sys.argv[2]
        result = {"specs": reference_specs()}
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.distributed.sharding import fsdp_layout, MeshShape
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves

        single = {pol: one_step(pol, src) for pol in POLICIES}

        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        ckpt = os.path.join(tmp, "ckpt")
        procs = [ctx.Process(target=worker, args=(r, os.path.join(
            tmp, "store2"), src, ckpt, q)) for r in range(WORLD)]
        for pr in procs:
            pr.start()
        got = {}
        try:
            while len(got) < WORLD:
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

        # the ranks' FSDP pieces, gathered back into whole tensors
        cfg = setup(src)[0]
        with mesh_context(MeshShape(("data", "model"), (WORLD, 1))):
            dims = tree_leaves(fsdp_layout(TM.param_shapes(cfg), cfg, 0,
                                           WORLD).dims)
        shapes = [x.shape for x in single["afe"]["params"]]

        def whole(pol, k):
            out = []
            for i, (d, shp) in enumerate(zip(dims, shapes)):
                if d is None or pol in ("unopt", "lc"):
                    out.append(got[0][pol]["opt"][k][i])
                else:
                    out.append(np.concatenate(
                        [got[r][pol]["opt"][k][i] for r in range(WORLD)],
                        axis=d)[(slice(None),) * d + (slice(0, shp[d]),)])
            return out

        two = {}
        for pol in POLICIES:
            s = single[pol]
            two[pol] = {
                "params": max(diff(got[r][pol]["params"], s["params"])
                              for r in range(WORLD)),
                "ranks_agree": max(diff(got[0][pol]["params"],
                                        got[r][pol]["params"])
                                   for r in range(WORLD)),
                "opt": {k: diff(whole(pol, k), s["opt"][k])
                        for k in ("m", "v", "master")},
                "grad_norm": [got[r][pol]["grad_norm"]
                              for r in range(WORLD)],
                "single_grad_norm": s["grad_norm"],
                "skipped": [got[r][pol]["skipped"] for r in range(WORLD)],
                "collectives": [got[r][pol]["collectives"]
                                for r in range(WORLD)],
            }
        result["two_ranks"] = two
        result["trainer"] = [got[r]["trainer"] for r in range(WORLD)]
        result["model_axis_raises"] = [got[r]["model_axis_raises"]
                                       for r in range(WORLD)]

        # the afe step's 2-rank checkpoint, restored at world size 1
        _, back = CheckpointManager(ckpt).restore(device="cpu")
        result["restore"] = {
            "params": diff([x.numpy() for x in tree_leaves(back["params"])],
                           got[0]["afe"]["params"]),
            "opt": {k: diff([x.numpy() for x in tree_leaves(back["opt"][k])],
                            whole("afe", k)) for k in ("m", "v", "master")},
            "shapes": [list(x.shape) for x in
                       tree_leaves(back["opt"]["master"])] ==
                      [list(x) for x in shapes]}

        # world size 1: every collective a copy, the step bitwise equal
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "store1"), rank=0, world_size=1)
        one = ranks_run(0, 1, src, None)
        dist.destroy_process_group()
        result["one_rank"] = {pol: {
            "params": diff(one[pol]["params"], single[pol]["params"]),
            "opt": max(diff(one[pol]["opt"][k], single[pol]["opt"][k])
                       for k in ("m", "v", "master")),
            "grad_norm": one[pol]["grad_norm"] == single[pol]["grad_norm"],
            "collectives": one[pol]["collectives"]} for pol in POLICIES}
        print("RESULT " + json.dumps(result))
""")


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """The reference's state after one AdamW step from its own init on
    phi3-mini SMOKE (fp32) and the next batch, also written as a port
    checkpoint for the subprocess."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    shape = ShapeConfig("t", SEQ, BATCH, "train", microbatches=MICRO)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, ocfg)
    step, _ = JT.build_train_step(cfg, shape, JT.StepConfig(
        q_chunk=8, k_chunk=8), ocfg)
    jp, js, _ = jax.jit(step)(jp, js, {k: jnp.asarray(v) for k, v in
                                       _batch(cfg, 0).items()})
    batch = _batch(cfg, 1)
    src = tmp_path_factory.mktemp("dist_state")
    with CheckpointManager(str(src)) as mgr:
        mgr.save(1, {"params": bridge.to_torch(jp, "cpu"),
                     "opt": bridge.to_torch(js, "cpu"),
                     "batch": {k: torch.tensor(v) for k, v in batch.items()}},
                 blocking=True)
    return cfg, shape, ocfg, jp, js, batch, src


@pytest.fixture(scope="module")
def dist_results(stepped, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ranks")
    script = tmp / "dist_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(tmp),
                          str(stepped[-1])], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError("no RESULT line:\n" + out.stdout)


# ---------------------------------------------------------------------------
# Spec parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(dist_results, arch, mesh):
    shape, axes = MESHES[mesh]
    for smoke in (True, False):
        for label, cfg in _spec_cases(t_get_config(arch, smoke=smoke)):
            shapes = TM.param_shapes(cfg)
            for dp in (True, False):
                with mesh_context(MeshShape(axes, shape)):
                    got = _jsonable(param_specs_tree(shapes, cfg,
                                                     dp_shard=dp))
                want = dist_results["specs"][f"{mesh}|{arch}|{smoke}"
                                             f"{label}|{dp}"]
                assert got == want, (arch, mesh, smoke, label, dp)


def test_phi3_smoke_first_specs():
    """The first leaves of phi3-mini SMOKE on ``(data 2, model 2)``, as
    the reference gives them."""
    cfg = t_get_config(ARCH, smoke=True)
    with mesh_context(MeshShape(("data", "model"), (2, 2))):
        specs = tree_leaves(param_specs_tree(TM.param_shapes(cfg), cfg))
    assert specs[:3] == [("model", "data"), (None,),
                         (None, "data", "model")]


def test_named_shardings_are_the_specs_as_placements():
    """Each leaf's DTensor placements, one per mesh axis: ``Shard`` of the
    dim the spec puts on that axis, else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import named_shardings

    cfg = t_get_config(ARCH, smoke=True)
    with mesh_context(MeshShape(("data", "model"), (2, 2))):
        shapes = TM.param_shapes(cfg)
        got = named_shardings(shapes, cfg)
        specs = param_specs_tree(shapes, cfg)
    assert got["embed"] == (Shard(1), Shard(0))       # ("model", "data")
    for spec, placed in zip(tree_leaves(specs), tree_leaves(got)):
        for axis, pl in zip(("data", "model"), placed):
            dims = [d for d, e in enumerate(spec) if e == axis]
            assert pl == (Shard(dims[0]) if dims else Replicate())


# ---------------------------------------------------------------------------
# The policies on 2 gloo ranks and on 1
# ---------------------------------------------------------------------------


def _expected_collectives(policy):
    """Per step, from the param tree and the bucket plan: unopt all-reduces
    every leaf per microbatch, lc once; afe reduce-scatters and
    all-gathers each FSDP-sharded leaf and all-reduces each replicated
    one and the norm's sums; afe_bucket reduce-scatters each bucket's
    sharded leaves, all-reduces the replicated ones as one bucket and the
    norm's sums, and all-gathers each bucket's sharded params by dtype."""
    cfg = dataclasses.replace(t_get_config(ARCH, smoke=True),
                              dtype="float32")
    leaves = tree_leaves(TM.param_shapes(cfg))
    with mesh_context(MeshShape(("data", "model"), (2, 1))):
        dims = tree_leaves(fsdp_layout(TM.param_shapes(cfg), cfg, 0, 2).dims)
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


@pytest.mark.parametrize("policy", POLICIES)
def test_two_ranks_match_single_process(dist_results, policy):
    r = dist_results["two_ranks"][policy]
    assert r["params"] <= 2e-5 and r["ranks_agree"] == 0.0
    for k, err in r["opt"].items():
        assert err <= 2e-5, k
    for g in r["grad_norm"]:
        assert abs(g - r["single_grad_norm"]) <= 2e-5 * r["single_grad_norm"]
    assert r["skipped"] == [0, 0]


@pytest.mark.parametrize("policy", POLICIES)
def test_one_rank_is_bitwise_equal(dist_results, policy):
    r = dist_results["one_rank"][policy]
    assert r["params"] == 0.0 and r["opt"] == 0.0 and r["grad_norm"]
    assert r["collectives"] == _expected_collectives(policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_collective_counts_are_exact(dist_results, policy):
    for counts in dist_results["two_ranks"][policy]["collectives"]:
        assert counts == _expected_collectives(policy)


def test_policy_ladder_collective_mix(dist_results):
    """The reference's ladder: unopt all-reduces at least as often as lc;
    afe reduce-scatters and all-gathers; afe_bucket issues fewer
    collectives than afe (finish fusion)."""
    c = {p: dist_results["two_ranks"][p]["collectives"][0] for p in POLICIES}
    assert c["unopt"]["all_reduce"] >= c["lc"]["all_reduce"] > 0
    assert c["afe"]["reduce_scatter"] > 0 and c["afe"]["all_gather"] > 0
    assert 0 < sum(c["afe_bucket"].values()) < sum(c["afe"].values())


def test_checkpoint_two_ranks_restore_at_one(dist_results):
    r = dist_results["restore"]
    assert r["params"] == 0.0 and r["shapes"]
    assert r["opt"] == {"m": 0.0, "v": 0.0, "master": 0.0}


def test_trainer_resumes_on_two_ranks(dist_results):
    """``run_training`` on the 2-rank mesh (``afe``: every rank saves and
    restores its own FSDP pieces) crashes after step 3, resumes from its
    step-2 checkpoint, and ends where an uninterrupted run does."""
    for r in dist_results["trainer"]:
        assert r["crashed"] and r["resumed_from"] == 2 and \
            r["completed"] == 4
        assert r["last_loss_diff"] == 0.0 and r["grad_norm_diff"] == 0.0


def test_model_axis_raises(dist_results):
    assert dist_results["model_axis_raises"] == [True, True]


# ---------------------------------------------------------------------------
# Single process against the reference
# ---------------------------------------------------------------------------


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("policy", POLICIES)
def test_single_process_step_matches_reference(stepped, policy):
    cfg, shape, ocfg, jp, js, batch, _ = stepped
    scfg = dict(policy=policy, q_chunk=8, k_chunk=8, n_buckets=N_BUCKETS)
    jstep, _ = JT.build_train_step(cfg, shape, JT.StepConfig(**scfg), ocfg)
    jp2, js2, jm = jax.jit(jstep)(jp, js, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tcfg = dataclasses.replace(t_get_config(ARCH, smoke=True),
                               dtype="float32")
    tstep, _ = TT.build_train_step(
        tcfg, TShapeConfig("t", SEQ, BATCH, "train", microbatches=MICRO),
        TT.StepConfig(**scfg), TO.AdamWConfig(lr=1e-3, warmup_steps=2))
    tp2, ts2, tm = tstep(bridge.to_torch(jp, "cpu"),
                         bridge.to_torch(js, "cpu"),
                         {k: torch.tensor(v) for k, v in batch.items()})
    gj, gt = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(gt - gj) <= 1e-5 * gj
    for k in ("m", "v", "master"):
        for g, r in zip(_np_leaves(ts2[k]), _np_leaves(js2[k])):
            assert float(np.abs(g - r).max()) <= \
                2e-5 * max(float(np.abs(r).max()), 1e-30), k
    for g, r in zip(_np_leaves(tp2), _np_leaves(jp2)):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=0)
