"""Sequence parallelism on the ``"model"`` axis, and multi-pod meshes with
a model axis (fault K), on the CPU.

Where the model axis's ``m`` divides the sequence, a model rank holds
rows ``[j·S/m, (j+1)·S/m)`` of the residual stream between layers (the
reference's ``shard_act``), each layer gathering its normed input and
reduce-scattering its output.  One module-scoped subprocess spawns gloo
ranks meeting at a ``file://`` store under the test's temporary
directory (as ``tests/test_torch_tp.py`` does); any rank's traceback
fails it.  While it runs, this process computes the oracles.

* **(data 2, model 2), 4 ranks** — every family's SMOKE config (fp32:
  phi3 dense, granite moe, falcon-mamba ssm, hymba hybrid, whisper
  encdec, llama-vision vlm) from the reference's init, optimizer state
  and batch: 2 steps (phi3 under each sync policy, the others under
  ``afe``; granite at capacity factor E / top_k and, since fault M's
  repair, at its own factor 1.25 and at 0.25, with ``dlbc`` and ``lc``
  dispatch: capacity and slot positions over the whole microbatch)
  whose gradient norms and whole params are the reference's
  single-device jitted steps' within 2e-5; every layer's input on a rank
  is ``(B/D, S/m, d)`` (whisper's encoder ``(B/D, enc_seq/m, d)``);
  phi3's collectives exact per axis, granite's data-axis all-gathers
  exactly one (``lc``) or two (``dlbc``) per MoE layer and forward,
  ``remat``'s recompute included.
* **(data 1, model 2), 2 ranks** — phi3's policies and granite at its
  own capacity factor against the reference likewise; the family cases
  of ``tests/test_torch_tp.py``, one under capacity pressure and one ragged-S case (S 7, which falls
  back to whole activations): loss and gradients against the one-process
  port within 2e-5, the leaves whose gradients are partial on each rank
  exactly those ``sp_summed`` flags, routes equal to one process's (MoE
  routes on the gathered tokens), whole attention leaving by a slice
  (hymba's 25-head shape), and exact forward counts; span prefill chunked
  == whole at 0.0 with a sequence-parallel chunk, counts exact.
* **(pod 2, data 2, model 2), 8 ranks** (fault K: two wide data axes that
  do not span the world) — phi3's four policies' 2 steps against the
  reference at 2e-5 with exact counts per axis, each rank's data group
  the one ``axis_groups`` gives; granite's four fault M cases likewise;
  granite's closed batch through the
  ``ContinuousBatcher``: every request finished, tokens those of one
  process, collectives exact.
"""

import dataclasses
import os
import pickle
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
from repro_torch.distributed.comm import axis_groups  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, attn_split, fsdp_layout, mesh_context, sp_summed,
    tp_assemble, tp_local_params, tp_owned,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.sched import FixedCapacity  # noqa: E402
from repro_torch.serve import batcher as TB  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("unopt", "lc", "afe", "afe_bucket")
SEQ, BATCH, MICRO, N_BUCKETS = 8, 8, 2, 4
#: the runs stepped against the reference: (arch, config fields replaced).
#: Every family on (data 2, model 2); granite there at capacity factor E /
#: top_k and (fault M: capacity and positions over the whole microbatch)
#: at its own factor 1.25 and at 0.25, dispatched ``dlbc`` and ``lc``
FAMILIES = {"dense": ("phi3-mini-3.8b", {}),
            "moe": ("granite-moe-1b-a400m", {}),
            "moe_ample": ("granite-moe-1b-a400m",
                          {"moe_capacity_factor": 2.0}),
            "moe_lc": ("granite-moe-1b-a400m", {"moe_dispatch": "lc"}),
            "moe_tight": ("granite-moe-1b-a400m",
                          {"moe_capacity_factor": 0.25}),
            "moe_tight_lc": ("granite-moe-1b-a400m",
                             {"moe_capacity_factor": 0.25,
                              "moe_dispatch": "lc"}),
            "ssm": ("falcon-mamba-7b", {}),
            "hybrid": ("hymba-1.5b", {}),
            "encdec": ("whisper-medium", {}),
            "vlm": ("llama-3.2-vision-90b", {})}
#: granite's fault M cases, run on (data 2, model 2) and (pod 2, data 2,
#: model 2)
FAULT_M = ("moe", "moe_lc", "moe_tight", "moe_tight_lc")
#: the runs of each world: (family, policy)
RUNS = {4: [("dense", p) for p in ("unopt", "lc", "afe", "afe_bucket")]
        + [(f, "afe") for f in ("moe_ample", "ssm", "hybrid", "encdec",
                                "vlm")]
        + [(f, "afe") for f in FAULT_M],
        2: [("dense", p) for p in ("unopt", "lc", "afe", "afe_bucket")]
        + [("moe", "afe")],
        8: [("dense", p) for p in ("unopt", "lc", "afe", "afe_bucket")]
        + [(f, "afe") for f in FAULT_M]}
#: the 2-rank gradient cases: (arch, config fields replaced, S)
CASES = {
    "dense": ("phi3-mini-3.8b", {}, SEQ),
    "moe_experts": ("granite-moe-1b-a400m", {}, SEQ),
    "moe_ff": ("granite-moe-1b-a400m", {"n_experts": 3}, SEQ),
    "moe_pressure": ("granite-moe-1b-a400m", {"moe_capacity_factor": 0.25},
                     2 * SEQ),
    "ssm": ("falcon-mamba-7b", {}, SEQ),
    "hybrid": ("hymba-1.5b", {}, SEQ),
    "hybrid_whole_attn": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5},
                          SEQ),
    "encdec": ("whisper-medium", {}, SEQ),
    "vlm": ("llama-3.2-vision-90b", {}, SEQ),
    "dense_shared_kv": ("phi3-mini-3.8b", {"n_kv_heads": 1}, SEQ),
    "dense_ragged": ("phi3-mini-3.8b", {}, 7),
}
#: span prefill: a 11-token prompt in a 12-wide buffer (m 2 divides it)
PREFILL = {"dense": "phi3-mini-3.8b", "moe": "granite-moe-1b-a400m"}
CHUNKINGS = ([11], [8, 3], [1] * 11)
PREFILL_C = 12
#: the 8-rank batcher run: (rid, arrive step, prompt length, max new)
SERVE_SPEC = [(0, 0, 2, 5), (1, 0, 9, 4), (2, 0, 5, 6), (3, 1, 13, 3),
              (4, 2, 3, 5), (5, 4, 7, 2), (6, 5, 1, 4), (7, 7, 11, 3)]
SERVE = dict(n_slots=4, cache_len=32, policy="dlbc", prefill_chunk=4)
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
         "send_recv")


def _cfg(arch, rep=None, ref=False):
    get = get_config if ref else t_get_config
    return dataclasses.replace(get(arch, smoke=True), dtype="float32",
                               **(rep or {}))


def _counts(**kw):
    return dict(dict.fromkeys(KINDS, 0), **kw)


# ---------------------------------------------------------------------------
# The subprocess: 4 ranks at (data 2, model 2), 2 at (data 1, model 2),
# 8 at (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    SEQ, BATCH, MICRO, N_BUCKETS = 8, 8, 2, 4


    def np_leaves(tree):
        from repro_torch.tree import tree_leaves
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]


    def cfg_of(arch, rep=None):
        from repro_torch.configs import get_config
        return dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32", **(rep or {}))


    def steps(setup, fam, policy, mesh, shapes=None):
        \"\"\"2 steps of ``policy`` on ``mesh`` from the reference's state
        of family ``fam``: the whole params after them, the gradient norms
        and each step's collectives per axis; with ``shapes`` (a list),
        every layer input's shape of the first step appended to it.\"\"\"
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.models import blocks as TB
        from repro_torch.train import train_step as TT
        from repro_torch.train.optimizer import AdamWConfig

        cfg = cfg_of(*setup["families"][fam])
        _, tree = CheckpointManager(setup["src"][fam]).restore(device="cpu")
        batch = tree.pop("batch")
        batch = {k: v.long() if k in ("tokens", "labels") else v
                 for k, v in batch.items()}
        real = TB.layer_apply

        def spy(p, c, x, kind, **kw):
            shapes.append((kind, tuple(x.shape)))
            return real(p, c, x, kind, **kw)

        out = {"grad_norm": [], "collectives": []}
        with mesh_context(mesh):
            step, _ = TT.build_train_step(cfg, ShapeConfig(
                "t", SEQ, BATCH, "train", microbatches=MICRO),
                TT.StepConfig(policy=policy, q_chunk=8, k_chunk=8,
                              ssm_chunk=8, n_buckets=N_BUCKETS),
                AdamWConfig(lr=1e-3, warmup_steps=2))
            params, opt = step.local_state(tree["params"], tree["opt"])
            for i in range(2):
                if shapes is not None and i == 0:
                    TB.layer_apply = spy
                try:
                    params, opt, m = step(params, opt, batch)
                finally:
                    TB.layer_apply = real
                out["grad_norm"].append(float(m["grad_norm"]))
                out["collectives"].append(
                    [m["collectives"], m["tp_collectives"],
                     m["ep_collectives"]])
            params, _ = step.whole_state(params, opt)
        out["params"] = np_leaves(params)
        return out


    def loss_grads(case, rank, mesh):
        \"\"\"This model rank's loss, raw gradients (numpy, leaf order), MoE
        routes (ids, keep per layer call) and the model axis's counts of
        one ``loss_fn`` backward and of one forward without grad.\"\"\"
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM
        from repro_torch.models import moe as M
        from repro_torch.tree import tree_leaves, tree_unflatten

        cfg = cfg_of(*case["cfg"])
        local = tp_local_params(case["params"], cfg, rank, 2)
        batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(local)]
        routes, real = [], M.dispatch_combine

        def spy(x, gates, ids, pos, keep, *a, **k):
            routes.append([ids.tolist(), keep.tolist()])
            return real(x, gates, ids, pos, keep, *a, **k)

        tp = Collectives(mesh.get_group("model"))
        M.dispatch_combine = spy
        try:
            loss = TM.loss_fn(tree_unflatten(local, leaves), cfg, batch,
                              tp=tp, q_chunk=8, k_chunk=8, ssm_chunk=8)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            M.dispatch_combine = real
        fwd = Collectives(tp.group)
        with torch.no_grad():
            TM.forward(local, cfg, batch, tp=fwd, ssm_chunk=8)
        return {"loss": float(loss.detach()),
                "grads": [g.numpy().copy() for g in grads],
                "routes": routes, "counts": dict(tp.counts),
                "fwd_counts": dict(fwd.counts)}


    def prefill(case, rank, mesh):
        \"\"\"The prompt prefilled through a (2, PREFILL_C) buffer in each
        chunking (row 0; row 1 inert), then one decode step: the local
        caches and logits, and one round's model-axis collectives.\"\"\"
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM
        from repro_torch.tree import tree_leaves

        cfg = cfg_of(case["arch"])
        params = tp_local_params(case["params"], cfg, rank, 2)
        prompt, C = case["prompt"], case["C"]
        group = mesh.get_group("model")
        runs, counts = [], None
        with torch.no_grad():
            for sizes in case["chunkings"]:
                cache = TM.init_cache(cfg, 2, 32, device="cpu", mesh=mesh)
                pos = 0
                for s in sizes:
                    toks = np.zeros((2, C), np.int64)
                    toks[0, :s] = prompt[pos:pos + s]
                    tp = Collectives(group)
                    TM.prefill_step(params, cfg, cache, {
                        "tokens": torch.tensor(toks),
                        "cache_index": torch.tensor([pos, 0]),
                        "count": torch.tensor([s, 0])}, tp=tp)
                    counts = counts or dict(tp.counts)
                    pos += s
                lg, _ = TM.decode_step(params, cfg, cache, {
                    "tokens": torch.tensor([[prompt[-1]]] * 2),
                    "cache_index": torch.tensor([pos, 0])},
                    tp=Collectives(group))
                runs.append([t.numpy().copy() for t in tree_leaves(cache)]
                            + [lg.numpy().copy()])
        return {"delta": max(float(np.abs(a - b).max()) for run in runs[1:]
                             for a, b in zip(run, runs[0])),
                "counts": counts}


    def serve(setup, mesh):
        \"\"\"The closed batch through the ``ContinuousBatcher`` on this
        rank's shards: tokens, finished requests, launches by kind and
        the model and data axes' collectives.\"\"\"
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM
        from repro_torch.serve import batcher as TB

        srv = setup["serve"]
        cfg = cfg_of(srv["arch"])
        params = tp_local_params(srv["params"], cfg,
                                 dist.get_rank(mesh.get_group("model")), 2)
        b = TB.ContinuousBatcher(cfg, params, device="cpu", mesh=mesh,
                                 **srv["kw"])
        reqs = [TB.Request(rid=r, prompt=list(p), max_new=n, arrive_step=t)
                for r, t, p, n in srv["trace"]]
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
                "finished": sum(r.done_step is not None for r in reqs),
                "calls": calls, "tp": b.tp.counts, "dp": b.dp.counts}


    def world4(rank, setup):
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=2, model=2, device_type="cpu")
        out = {"steps": {}, "shapes": {}}
        for fam, pol in setup["runs"][4]:
            shapes = [] if pol == "afe" else None
            out["steps"][f"{fam}|{pol}"] = steps(setup, fam, pol, mesh,
                                                 shapes)
            if shapes is not None:
                out["shapes"][fam] = sorted(set(shapes))
        return out


    def world2(rank, setup):
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=1, model=2, device_type="cpu")
        return {"steps": {f"{fam}|{pol}": steps(setup, fam, pol, mesh)
                          for fam, pol in setup["runs"][2]},
                "cases": {n: loss_grads(c, rank, mesh)
                          for n, c in setup["cases"].items()},
                "prefill": {n: prefill(c, rank, mesh)
                            for n, c in setup["prefill"].items()}}


    def world8(rank, setup):
        from repro_torch.distributed.comm import mesh_group
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(pod=2, data=2, model=2, device_type="cpu")
        group = mesh_group(mesh, ("pod", "data"))
        return {"data_group": dist.get_process_group_ranks(group),
                "steps": {f"{fam}|{pol}": steps(setup, fam, pol, mesh)
                          for fam, pol in setup["runs"][8]},
                "serve": serve(setup, mesh)}


    def worker(fn, rank, world, store, tmp, q):
        try:
            torch.set_num_threads(1)
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=world)
            with open(os.path.join(tmp, "setup.pkl"), "rb") as f:
                setup = pickle.load(f)
            res = fn(rank, setup)
            dist.barrier()
            with open(os.path.join(tmp, f"rank_{world}_{rank}.pkl"),
                      "wb") as f:
                pickle.dump(res, f)
            q.put((rank, {}))
        except BaseException:
            q.put((rank, {"error": traceback.format_exc()}))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


    def spawn(fn, world, tmp):
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        store = os.path.join(tmp, f"store_{world}")
        procs = [ctx.Process(target=worker, args=(fn, r, world, store, tmp,
                                                  q)) for r in range(world)]
        for pr in procs:
            pr.start()
        got = {}
        try:
            while len(got) < world:
                r, res = q.get(timeout=300)
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


    if __name__ == "__main__":
        tmp = sys.argv[1]
        for fn, world in ((world4, 4), (world2, 2), (world8, 8)):
            spawn(fn, world, tmp)
        print("RESULT ok")
""")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "vlm"):
        key, n = ("enc_frames", cfg.enc_seq) if cfg.family == "encdec" \
            else ("vis_embed", cfg.vis_seq)
        batch[key] = rng.standard_normal((BATCH, n, cfg.d_model)).astype(
            np.float32)
    return batch


def _case_batch(cfg, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(2, S + 1)).astype(np.int64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "vlm"):
        key, n = ("enc_frames", cfg.enc_seq) if cfg.family == "encdec" \
            else ("vis_embed", cfg.vis_seq)
        batch[key] = rng.standard_normal((2, n, cfg.d_model)).astype(
            np.float32)
    return batch


def _loss_grads(cfg, params, batch):
    """The one-process port's loss, gradients and MoE routes."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    routes, real = [], TMoE.dispatch_combine

    def spy(x, gates, ids, pos, keep, *a, **k):
        routes.append([ids.tolist(), keep.tolist()])
        return real(x, gates, ids, pos, keep, *a, **k)

    TMoE.dispatch_combine = spy
    try:
        loss = TM.loss_fn(tree_unflatten(params, leaves), cfg,
                          {k: torch.tensor(v) for k, v in batch.items()},
                          q_chunk=8, k_chunk=8, ssm_chunk=8)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        TMoE.dispatch_combine = real
    return float(loss.detach()), [g.numpy() for g in grads], routes


def _reference_steps(fam, jp, js, batch):
    """The reference's single-device jitted ``afe`` step, twice: the
    gradient norms and the params after them."""
    cfg = _cfg(*FAMILIES[fam], ref=True)
    step, _ = JT.build_train_step(cfg, ShapeConfig(
        "t", SEQ, BATCH, "train", microbatches=MICRO), JT.StepConfig(
        policy="afe", q_chunk=8, k_chunk=8, ssm_chunk=8),
        JO.AdamWConfig(lr=1e-3, warmup_steps=2))
    fn = jax.jit(step)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    norms = []
    for _ in range(2):
        jp, js, m = fn(jp, js, b)
        norms.append(float(m["grad_norm"]))
    return {"grad_norm": norms,
            "params": [np.asarray(x, np.float32)
                       for x in jax.tree.leaves(jp)]}


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """Writes each family's reference state for the subprocess, starts it,
    computes the oracles meanwhile (the reference's 2 jitted steps per
    family, the one-process port's gradients and batcher run), then
    reads every rank's results."""
    tmp = tmp_path_factory.mktemp("sp_ranks")
    setup = {"families": FAMILIES, "runs": RUNS, "src": {}, "cases": {},
             "prefill": {}}
    ref_state = {}
    for fam, (arch, rep) in FAMILIES.items():
        cfg = _cfg(arch, rep, ref=True)
        ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
        jp = JM.init_params(cfg, jax.random.PRNGKey(0))
        js = JO.init_opt_state(jp, ocfg)
        batch = _batch(cfg, 0)
        src = tmp / f"state_{fam}"
        with CheckpointManager(str(src)) as mgr:
            mgr.save(0, {"params": bridge.to_torch(jp, "cpu"),
                         "opt": bridge.to_torch(js, "cpu"),
                         "batch": {k: torch.tensor(v)
                                   for k, v in batch.items()}},
                     blocking=True)
        setup["src"][fam] = str(src)
        ref_state[fam] = (jp, js, batch)
    for name, (arch, rep, S) in CASES.items():
        cfg = _cfg(arch, rep)
        setup["cases"][name] = {
            "cfg": (arch, rep), "batch": _case_batch(cfg, S),
            "params": TM.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")}
    for name, arch in PREFILL.items():
        cfg = _cfg(arch)
        setup["prefill"][name] = {
            "arch": arch, "chunkings": CHUNKINGS, "C": PREFILL_C,
            "params": TM.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"),
            "prompt": np.random.default_rng(7).integers(
                0, cfg.vocab, size=12).tolist()}
    cfg = _cfg("granite-moe-1b-a400m")
    rng = np.random.default_rng(1)
    trace = [(r, t, rng.integers(0, cfg.vocab, size=n).tolist(), m)
             for r, t, n, m in SERVE_SPEC]
    setup["serve"] = {"arch": "granite-moe-1b-a400m", "trace": trace,
                      "kw": SERVE,
                      "params": TM.init_params(
                          cfg, torch.Generator().manual_seed(0),
                          device="cpu")}
    with open(tmp / "setup.pkl", "wb") as f:
        pickle.dump(setup, f)
    script = tmp / "sp_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(script), str(tmp)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        want = {"ref": {fam: _reference_steps(fam, *ref_state[fam])
                        for fam in FAMILIES}, "cases": {}}
        for name, case in setup["cases"].items():
            want["cases"][name] = _loss_grads(_cfg(*case["cfg"]),
                                              case["params"], case["batch"])
        one = TB.ContinuousBatcher(cfg, setup["serve"]["params"],
                                   device="cpu", **SERVE)
        reqs = [TB.Request(rid=r, prompt=list(p), max_new=n, arrive_step=t)
                for r, t, p, n in trace]
        one.run(reqs)
        want["serve"] = [r.tokens for r in reqs]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    ranks = {}
    for world in (4, 2, 8):
        ranks[world] = []
        for r in range(world):
            with open(tmp / f"rank_{world}_{r}.pkl", "rb") as f:
                ranks[world].append(pickle.load(f))
    return {"want": want, "ranks": ranks, "setup": setup}


# ---------------------------------------------------------------------------
# The policies' 2 steps against the reference
# ---------------------------------------------------------------------------

STEP_RUNS = [(w, f"{fam}|{pol}") for w in sorted(RUNS)
             for fam, pol in RUNS[w]]


@pytest.mark.parametrize("world,run", STEP_RUNS)
def test_steps_match_reference(sp, world, run):
    """The ranks' gradient norms and whole params after 2 steps are the
    reference's single-device jitted steps' within 2e-5; every rank
    holds the same whole params."""
    want = sp["want"]["ref"][run.split("|")[0]]
    got = [r["steps"][run] for r in sp["ranks"][world]]
    for g in got:
        for a, b in zip(g["grad_norm"], want["grad_norm"]):
            assert abs(a - b) <= 2e-5 * b, (a, b)
        assert len(g["params"]) == len(want["params"])
        for a, b in zip(g["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
        for a, b in zip(g["params"], got[0]["params"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("fam", [f for f, p in RUNS[4] if p == "afe"])
def test_residual_stream_is_sequence_sharded(sp, fam):
    """On (data 2, model 2) every layer's input on every rank is its rows
    of the microbatch over the data axis and its ``S/m`` rows of the
    sequence: ``(B/(M·D), S/2, d)``; whisper's encoder layers hold their
    ``enc_seq/2`` frames."""
    cfg = _cfg(*FAMILIES[fam])
    rows = BATCH // MICRO // 2
    want = {(rows, SEQ // 2, cfg.d_model)}
    if cfg.family == "encdec":
        want.add((rows, cfg.enc_seq // 2, cfg.d_model))
    for r in sp["ranks"][4]:
        shapes = r["shapes"][fam]
        assert {s for _, s in shapes} == want, shapes
        if cfg.family == "encdec":
            assert ("enc", (rows, cfg.enc_seq // 2, cfg.d_model)) in \
                [tuple(s) for s in shapes]


def _data_collectives(policy, mesh, rows, fam="dense"):
    """The data axes' collectives per step over one model rank's local
    tree of ``fam`` (phi3 by default), as
    ``tests/test_torch_distributed.py`` derives them: the FSDP layout over
    ``rows`` data ranks, the bucket plan over the local leaves."""
    cfg = _cfg(*FAMILIES[fam])
    shapes = tp_local_params(TM.param_shapes(cfg), cfg, 0, 2)
    leaves = tree_leaves(shapes)
    with mesh_context(mesh):
        dims = tree_leaves(fsdp_layout(shapes, cfg, 0, rows).dims)
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
    """The model axis's per step, sequence-parallel under ``remat``
    (``tests/test_torch_tp.py``'s ``_expected_tp_collectives``): ``6L +
    2`` all-gathers, ``5L + 2`` reduce-scatters and 3 all-reduces per
    microbatch, two all-reduces per step."""
    L = n_layers
    return _counts(all_reduce=MICRO * 3 + 2,
                   reduce_scatter=MICRO * (5 * L + 2),
                   all_gather=MICRO * (6 * L + 2))


MESHES = {4: (MeshShape(("data", "model"), (2, 2)), 2),
          2: (MeshShape(("data", "model"), (1, 2)), 1),
          8: (MeshShape(("pod", "data", "model"), (2, 2, 2)), 4)}


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_dense_collectives_exact_per_axis(sp, world, policy):
    """phi3's collectives on each mesh, per step and axis: the data axes'
    of the policy (at 8 ranks over the group of ``("pod", "data")``, 4
    ranks), the model axis's sequence-parallel ones, no expert axis."""
    mesh, rows = MESHES[world]
    data = _data_collectives(policy, mesh, rows)
    model = _tp_collectives(_cfg(*FAMILIES["dense"]).n_layers)
    for r in sp["ranks"][world]:
        for d, m, e in r["steps"][f"dense|{policy}"]["collectives"]:
            assert d == data
            assert m == model
            assert e == {}


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("fam", FAULT_M)
def test_moe_data_axis_all_gathers_exact(sp, world, fam):
    """granite's fault M runs, per step: the data axes' collectives of
    ``afe`` over the local tree plus, per MoE layer and forward (each
    microbatch's and its ``remat`` recompute), one all-gather of the
    ranks' pair counts under ``lc`` and two under ``dlbc``; the model
    axis's the sequence-parallel ones and, per MoE layer and microbatch,
    the all-reduce of the gates' gradient (``copy_to_tp``); no expert
    axis."""
    mesh, rows = MESHES[world]
    cfg = _cfg(*FAMILIES[fam])
    rounds = 1 if cfg.moe_dispatch == "lc" else 2
    data = _data_collectives("afe", mesh, rows, fam)
    data["all_gather"] += MICRO * 2 * cfg.n_layers * rounds
    for r in sp["ranks"][world]:
        for d, m, e in r["steps"][f"{fam}|afe"]["collectives"]:
            assert d == data
            model = _tp_collectives(cfg.n_layers)
            model["all_reduce"] += MICRO * cfg.n_layers
            assert m == model
            assert e == {}


def test_multi_pod_data_groups(sp):
    """On (pod 2, data 2, model 2) each rank's data-parallel group (over
    ``("pod", "data")``, which neither spans the world nor is one axis)
    holds the 4 ranks of its model coordinate, as ``axis_groups``
    computes them."""
    groups = axis_groups(MESHES[8][0], ("pod", "data"))
    for rank, r in enumerate(sp["ranks"][8]):
        assert r["data_group"] == [g for g in groups if rank in g][0]
        assert r["data_group"] == [rank % 2 + 2 * k for k in range(4)]


# ---------------------------------------------------------------------------
# (data 1, model 2): gradients, routes and the layout's exits
# ---------------------------------------------------------------------------


def _summed(name):
    arch, rep, S = CASES[name]
    cfg = _cfg(arch, rep)
    enc = cfg.enc_seq if cfg.family == "encdec" else 0
    local = tp_local_params(TM.param_shapes(cfg), cfg, 0, 2)
    return cfg, tree_leaves(sp_summed(local, 2, S, enc))


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_loss_and_grads_match_one_process(sp, name):
    """Each rank's loss, and the gradients put back together (the leaves
    ``sp_summed`` flags summed over the ranks), within 2e-5 of the
    one-process port's."""
    cfg, flags = _summed(name)
    loss, grads, _ = sp["want"]["cases"][name]
    got = [r["cases"][name] for r in sp["ranks"][2]]
    for g in got:
        assert abs(g["loss"] - loss) <= 2e-5
    raw = [g["grads"] for g in got]
    summed = [[a + b if f else x for a, b, f, x in zip(raw[0], raw[1], flags,
                                                         raw[k])]
              for k in range(2)]
    shapes = TM.param_shapes(cfg)
    pieces = [tree_unflatten(shapes, [torch.from_numpy(np.asarray(x))
                                      for x in s]) for s in summed]
    whole = tree_leaves(tp_assemble(pieces, cfg))
    for a, b in zip(whole, grads):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_partial_gradients_are_the_summed_leaves(sp, name):
    """Of the leaves that both ranks hold whole (replicated, or a shared
    KV head), the ones whose gradients differ between the ranks — partial
    sums over each rank's rows of the sequence — are exactly those
    ``sp_summed`` flags: the norms and ``b2`` where S (and whisper's
    frames) shard, none where S is ragged; every other one is the same
    whole gradient on both ranks."""
    cfg, flags = _summed(name)
    shapes = TM.param_shapes(cfg)
    held = [not o for o in tree_leaves(tp_owned(shapes, cfg, 1, 2))]
    g0, g1 = (r["cases"][name]["grads"] for r in sp["ranks"][2])
    partial = [h and not np.array_equal(a, b)
               for h, a, b in zip(held, g0, g1)]
    assert partial == [h and f for h, f in zip(held, flags)]
    assert any(flags) == (CASES[name][2] % 2 == 0)


@pytest.mark.parametrize("name", ["moe_experts", "moe_ff", "moe_pressure"])
def test_model2_moe_routes_on_the_gathered_tokens(sp, name):
    """Both ranks route every token of the microbatch, as one process does
    (ids and admission, also when capacity drops pairs): routing on a
    rank's sequence block would route half of them against a capacity of
    half the tokens."""
    _, _, routes = sp["want"]["cases"][name]
    assert len(routes) == 4          # 2 layers, each again in its remat
    for r in sp["ranks"][2]:
        assert r["cases"][name]["routes"] == routes
    if name == "moe_pressure":
        assert not all(all(k) for _, keep in routes for k in keep)


def _fwd_counts(name):
    """The model axis's collectives of one forward without grad on 2 ranks
    (S 8, one scan chunk).  Sequence-parallel: the embedding's
    reduce-scatter; per layer one all-gather per norm, one reduce-scatter
    per row-parallel exit (attention's only where its heads split: whole
    attention leaves by a slice) and the mamba heads' ``x_proj``
    all-reduce; the head input's all-gather.  Ragged S: the embedding's
    all-reduce and one per row-parallel exit."""
    arch, rep, S = CASES[name]
    cfg = _cfg(arch, rep)
    L, attn = cfg.n_layers, 1 if attn_split(cfg, 2) else 0
    if S % 2:
        return _counts(all_reduce=1 + L * (attn + 1))
    ag, rs, ar = {"dense": (2, attn + 1, 0), "moe": (2, attn + 1, 0),
                  "ssm": (1, 1, 1), "hybrid": (2, attn + 2, 1)}[cfg.family]
    return _counts(all_gather=L * ag + 1, reduce_scatter=L * rs + 1,
                   all_reduce=L * ar)


@pytest.mark.parametrize("name", ["dense", "moe_experts", "ssm", "hybrid",
                                  "hybrid_whole_attn", "dense_ragged"])
def test_model2_forward_collectives_exact(sp, name):
    """One forward's model-axis counts: hymba with 5 heads over 2 runs its
    attention whole and leaves it by a slice (one reduce-scatter per
    layer fewer than with 4 heads, none that would sum two equal
    copies); ragged S issues the all-reduces of whole activations."""
    for r in sp["ranks"][2]:
        assert r["cases"][name]["fwd_counts"] == _fwd_counts(name)


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_model2_chunked_prefill_is_bitwise_whole(sp, name):
    """An 11-token prompt through a 12-wide buffer (sequence-parallel over
    2) whole, in 8 + 3 and in 11 × 1: every local cache leaf and the next
    decode step's logits equal (max |Δ| 0.0); one round's collectives
    exact: the embedding's reduce-scatter, per layer two all-gathers and
    two reduce-scatters, the head input's all-gather."""
    L = _cfg(PREFILL[name]).n_layers
    for r in sp["ranks"][2]:
        got = r["prefill"][name]
        assert got["delta"] == 0.0
        assert got["counts"] == _counts(all_gather=2 * L + 1,
                                        reduce_scatter=2 * L + 1)


# ---------------------------------------------------------------------------
# (pod 2, data 2, model 2): the batcher
# ---------------------------------------------------------------------------


def test_multi_pod_batcher_finishes_like_one_process(sp):
    """granite's closed batch on the 8 ranks (one slot per data rank, 4
    data ranks over two wide axes): every request finished, every rank's
    tokens those of one process; per prefill round (chunk 4,
    sequence-parallel) the model axis's all-gathers and reduce-scatters,
    per decode step its all-reduces and the argmax's all-gather, and the
    tokens' all-gather over the data group, with per MoE layer and launch
    the two all-gathers of ``dlbc``'s pair counts (fault M)."""
    L = _cfg("granite-moe-1b-a400m").n_layers
    for r in sp["ranks"][8]:
        got = r["serve"]
        assert got["finished"] == len(SERVE_SPEC)
        assert got["tokens"] == sp["want"]["serve"]
        n_pre, n_dec = got["calls"]["prefill"], got["calls"]["decode"]
        assert n_pre > 0 and n_dec > 0
        assert got["tp"] == _counts(
            all_reduce=(1 + 2 * L) * n_dec,
            reduce_scatter=(1 + 2 * L) * n_pre,
            all_gather=n_dec + (1 + 2 * L) * n_pre)
        assert got["dp"] == _counts(
            all_gather=n_dec + 2 * L * (n_pre + n_dec))
