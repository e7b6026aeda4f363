"""Context-parallel decode caches in the port (the reference's
``_cache_shardings`` layout and decode over a context group) on the CPU.

* **The layout** — for every arch × ``decode_32k`` / ``long_500k`` cell
  that ``shape_applicable`` admits, on ``16x16`` and ``2x16x16``: the
  port's per-rank shard of every self-attention KV leaf
  (``init_cache(..., context=True)`` on the production ``MeshShape``,
  ``sharding.cache_layout``) has the shape that the reference's
  ``launch/dryrun.py`` ``_cache_shardings`` gives it on an
  ``AbstractMesh`` (no devices, no compile); the mamba leaves equal it
  too; ``cross_kv``, whose heads the port splits over the model ranks
  where the reference holds it whole, is no larger.
* **Decode on gloo ranks** — one module-scoped subprocess spawns 2 gloo
  ranks (``(data 1, model 2)`` at B 2 with per-row indices, then
  ``(data 2, model 1)`` at B 1) and 4 (``(data 2, model 2)`` at B 1),
  meeting at a ``file://`` store under the test's temporary directory, as
  ``tests/test_torch_tp_serve.py`` does.  granite-moe SMOKE (heads split
  over the model ranks), qwen2.5-32b SMOKE with 6 / 3 heads (they do not
  split: every rank runs every head), phi3-mini SMOKE with one KV head
  (``KV < m``) and hymba SMOKE (its 32-slot ring wraps), fp32, weights
  from the reference's ``init_params`` through ``bridge``: a seeded whole
  cache cut to each rank's block (``cp_local_cache``), 8 decode steps
  that cross a block boundary.  The logits equal one process's
  ``decode_step`` on the whole cache and the reference's within 2e-5; the
  ranks' blocks put back together (``cp_assemble_cache``) equal one
  process's cache within 2e-5, and bit for bit at every position the
  steps did not write; the context group's collectives (two all-reduces
  per attention layer) and the model axis's are exact.  A rank whose
  block holds no valid position adds nothing and no NaN.
* **In process** — the layout rule's cases, cut and assembly bit for
  bit, and the traced decode's collectives on a ``MeshGroup``.
"""

import dataclasses
import math
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
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SHAPES, shape_applicable  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.distributed.comm import (  # noqa: E402
    Collectives, MeshGroup, context_comm,
)
from repro_torch.distributed.sharding import (  # noqa: E402
    CacheLayout, MeshShape, attn_split, cache_layout, cp_assemble_cache,
    cp_local_cache, tp_local_params,
)
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 2e-5
T, STEPS = 32, 8
#: the decode cases: (arch, config fields)
CASES = {
    "moe": ("granite-moe-1b-a400m", {}),
    "dense_whole_heads": ("qwen2.5-32b", {"n_heads": 6, "n_kv_heads": 3,
                                          "d_head": 16}),
    "dense_shared_kv": ("phi3-mini-3.8b", {"n_kv_heads": 1}),
    "hybrid_ring": ("hymba-1.5b", {}),
}
#: the meshes: (data, model) sizes, the batch, each row's first index
#: (a few positions before a block boundary of the 2·T flat cache or the
#: T-slot ring, or with the ring's wrap ahead: the STEPS steps cross it)
MESHES = {
    "d1m2": ((1, 2), 2, {"ring": [28, 13], "flat": [28, 29]}),
    "d2m1": ((2, 1), 1, {"ring": [28], "flat": [28]}),
    "d2m2": ((2, 2), 1, {"ring": [28], "flat": [12]}),
}


def _cfg(arch, rep, ref=False):
    get = get_config if ref else t_get_config
    return dataclasses.replace(get(arch, smoke=True), dtype="float32", **rep)


# ---------------------------------------------------------------------------
# The layout against the reference's _cache_shardings
# ---------------------------------------------------------------------------


def _reference_shardings():
    """The reference's ``_cache_shardings`` and ``AbstractMesh``.  Its
    module sets ``XLA_FLAGS`` for 512 host devices on import; the flag is
    put back as it was, so that nothing else in this process (or a
    subprocess it starts) sees it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _cache_shardings
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    from jax.sharding import AbstractMesh
    return _cache_shardings, AbstractMesh


def _cells():
    return [(a, s, mp) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
            if shape_applicable(t_get_config(a), SHAPES[s])[0]
            for mp in (False, True)]


def _paths(tree, at=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{at}/{k}")]
    return [(at, tree)]


@pytest.mark.parametrize("arch,shape,multi_pod", _cells())
def test_cache_shards_equal_the_reference(arch, shape, multi_pod):
    """Every self-attention KV leaf's per-rank shape is the reference's
    shard shape; the mamba leaves' too; ``cross_kv`` no larger (the port
    splits its heads, the reference's rule only its time axis).  On
    ``16x16`` qwen2.5-32b's ``decode_32k`` cache is 4,294,967,296 bytes
    per rank (every KV head on every rank: 68.72 GB before this layout)."""
    cache_shardings, AbstractMesh = _reference_shardings()
    sh = SHAPES[shape]
    B, L = sh.global_batch, sh.seq_len
    mesh = production_mesh_shape(multi_pod=multi_pod)
    amesh = AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    shapes = JM.cache_shapes(get_config(arch), B, L)
    specs = cache_shardings(shapes, amesh, get_config(arch))
    want = {p: tuple(specs_leaf.shard_shape(leaf.shape))
            for (p, leaf), (_, specs_leaf) in zip(_paths(shapes),
                                                  _paths(specs))}
    got = {p: tuple(t.shape) for p, t in _paths(TM.init_cache(
        t_get_config(arch), B, L, device="meta", mesh=mesh, context=True))}
    assert sorted(got) == sorted(want)
    for p in got:
        if "cross_kv" in p:
            assert all(a <= b for a, b in zip(got[p], want[p])), p
        else:
            assert got[p] == want[p], (p, got[p], want[p])
    if (arch, shape, multi_pod) == ("qwen2.5-32b", "decode_32k", False):
        assert sum(t.numel() * t.element_size()
                   for t in tree_leaves(TM.init_cache(
                       t_get_config(arch), B, L, device="meta", mesh=mesh,
                       context=True))) == 4_294_967_296


@pytest.mark.parametrize("B,T,shape,want", [
    (128, 32768, (16, 16), (("data",), ("model",))),   # decode_32k
    (1, 4096, (16, 16), ((), ("data", "model"))),      # long_500k's ring
    (1, 32, (16, 16), ((), ("data",))),                # T over data only
    (1, 20, (16, 16), ((), ())),                       # T whole
    (32, 24, (16, 16), (("data",), ())),               # T % m != 0
    (2, 32, (1, 2), (("data",), ("model",))),
    (1, 32, (2, 1), ((), ("data", "model"))),
])
def test_cache_layout_rule(B, T, shape, want):
    mesh = MeshShape(("data", "model"), shape)
    assert cache_layout(t_get_config("phi3-mini-3.8b"), B, T, mesh) == \
        CacheLayout(*want)


def test_cache_layout_nested_and_multi_pod():
    """vlm's 6-d ``self_layers``: B and T decided apart (T over
    ``"model"`` only); on ``2x16x16`` the data axes are ``("pod",
    "data")``."""
    cfg = t_get_config("llama-3.2-vision-90b")
    mesh = production_mesh_shape(multi_pod=True)
    assert cache_layout(cfg, 1, 4096, mesh, nested=True) == \
        CacheLayout((), ("model",))
    assert cache_layout(cfg, 1, 4096, mesh) == \
        CacheLayout((), ("pod", "data", "model"))
    assert cache_layout(cfg, 64, 4096, mesh) == \
        CacheLayout(("pod", "data"), ("model",))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cut_and_assemble_bitwise(name, mesh_name):
    """A seeded whole cache cut into every rank's block and put back
    together is the same tree bit for bit; each block has
    ``init_cache(..., context=True)``'s shapes."""
    cfg = _cfg(*CASES[name])
    (D, m), B, _ = MESHES[mesh_name]
    mesh = MeshShape(("data", "model"), (D, m))
    whole = _seeded_cache(cfg, B, 3)
    pieces = [cp_local_cache(whole, cfg, mesh, r) for r in range(D * m)]
    shapes = TM.init_cache(cfg, B, 2 * T, device=CPU, mesh=mesh,
                           context=True)
    for piece in pieces:
        assert [tuple(t.shape) for t in tree_leaves(piece)] == \
            [tuple(t.shape) for t in tree_leaves(shapes)]
    back = cp_assemble_cache(pieces, cfg, mesh, B, 2 * T)
    for (p, a), (_, b) in zip(_paths(back), _paths(whole)):
        assert torch.equal(a, b), p


def test_traced_decode_counts_on_a_mesh_group():
    """granite SMOKE's decode traced on the meta device over
    ``(data 2, model 2)`` at B 1 (``T`` over both axes): the context
    group is a ``MeshGroup`` of 4, its ``all_reduce(op="max")`` and sum
    issue nothing; per layer two all-reduces on it and one head
    all-gather on the model axis."""
    cfg = _cfg(*CASES["moe"])
    mesh = MeshShape(("data", "model"), (2, 2))
    lay = cache_layout(cfg, 1, 2 * T, mesh)
    cp = context_comm(mesh, lay.time)
    assert isinstance(cp.group, MeshGroup) and cp.size == 4
    assert cp.axes == ("data", "model")
    tp = Collectives(MeshGroup(mesh, ("model",)))
    params = tp_local_params(TM.param_shapes(cfg), cfg, 0, 2)
    cache = TM.init_cache(cfg, 1, 2 * T, device="meta", mesh=mesh,
                          context=True)
    assert cache["layers"]["k"].shape[2] == 2 * T // 4
    logits, _ = TM.decode_step(params, cfg, cache, {
        "tokens": torch.zeros((1, 1), dtype=torch.long, device="meta"),
        "cache_index": torch.tensor(5, device="meta")}, tp=tp, cp=cp)
    assert logits.shape == (1, cfg.padded_vocab // 2)
    L = cfg.n_layers
    assert cp.counts == _counts(all_reduce=2 * L)
    assert tp.counts["all_gather"] == L


def _counts(**kw):
    return dict(dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                               "all_to_all", "send_recv"), 0), **kw)


# ---------------------------------------------------------------------------
# The subprocess: 2 ranks at (data 1, model 2) and (data 2, model 1), then
# 4 at (data 2, model 2)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def cfg_of(arch, rep):
        from repro_torch.configs import get_config
        return dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32", **rep)


    def np_tree(tree):
        if isinstance(tree, dict):
            return {k: np_tree(v) for k, v in tree.items()}
        return tree.detach().numpy().copy()


    def decode_case(case, mesh, rank):
        \"\"\"The steps on this rank's shards and block of the seeded
        cache: the local logits per step, the local cache after them and
        the context and model groups' collectives over all the steps.\"\"\"
        from repro_torch import bridge
        from repro_torch.distributed.comm import Collectives, context_comm
        from repro_torch.distributed.sharding import (
            axis_sizes, cache_layout, cp_local_cache)
        from repro_torch.models import model as TM

        cfg = cfg_of(*case["cfg"])
        m = axis_sizes(mesh)["model"]
        mr = dist.get_rank(mesh.get_group("model"))
        params = bridge.to_torch_tp(case["ref_params"], cfg, mr, m, "cpu") \\
            if m > 1 else bridge.to_torch(case["ref_params"], "cpu")
        cache = cp_local_cache(case["cache"], cfg, mesh, rank)
        B = case["tokens"].shape[0]
        win = cfg.sliding_window
        lay = cache_layout(cfg, B, min(case["cache_len"], win) if win
                           else case["cache_len"], mesh)
        cp = context_comm(mesh, lay.time)
        tp = Collectives(mesh.get_group("model")) if m > 1 else None
        logits = []
        for t in range(len(case["index"])):
            lg, cache = TM.decode_step(params, cfg, cache, {
                "tokens": torch.tensor(case["tokens"][:, t:t + 1]),
                "cache_index": torch.tensor(case["index"][t])}, tp=tp,
                cp=cp)
            logits.append(lg.numpy().copy())
        return {"logits": logits, "cache": np_tree(cache),
                "cp": cp.counts, "cp_axes": list(cp.axes),
                "tp": tp.counts if tp is not None else None}


    def empty_blocks(rank, mesh):
        \"\"\"``decode_attention_cp`` over the 4 ranks of (data 2, model 2)
        with every valid position in rank 0's block: against
        ``decode_attention`` on the whole cache, and finite.\"\"\"
        from repro_torch.distributed.comm import context_comm
        from repro_torch.models import layers as L

        g = torch.Generator().manual_seed(11)
        q = torch.randn(2, 1, 4, 16, generator=g)
        k = torch.randn(2, 32, 2, 16, generator=g)
        v = torch.randn(2, 32, 2, 16, generator=g)
        valid = torch.tensor([5, 8])
        cp = context_comm(mesh, ("data", "model"))
        n = 32 // cp.size
        blk = slice(cp.rank * n, (cp.rank + 1) * n)
        got = L.decode_attention_cp(q, k[:, blk], v[:, blk], valid, cp)
        want = L.decode_attention(q, k, v, valid)
        return {"err": float((got - want).abs().max()),
                "finite": bool(torch.isfinite(got).all()),
                "counts": cp.counts}


    def run_meshes(rank, tmp, meshes):
        from repro_torch.launch.mesh import make_test_mesh

        with open(os.path.join(tmp, "setup.pkl"), "rb") as f:
            setup = pickle.load(f)
        out = {}
        for name in meshes:
            D, m = setup["meshes"][name]
            mesh = make_test_mesh(data=D, model=m, device_type="cpu")
            out[name] = {c: decode_case(setup["cases"][(name, c)], mesh,
                                        rank)
                         for c in setup["names"]}
            if (D, m) == (2, 2):
                out["empty_blocks"] = empty_blocks(rank, mesh)
        return out


    def world2(rank, tmp):
        return run_meshes(rank, tmp, ("d1m2", "d2m1"))


    def world4(rank, tmp):
        return run_meshes(rank, tmp, ("d2m2",))


    def worker(fn, rank, world, store, tmp, q):
        try:
            torch.set_num_threads(1)
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=world)
            res = fn(rank, tmp)
            dist.barrier()
            q.put((rank, res))
        except BaseException:
            q.put((rank, {"error": traceback.format_exc()}))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


    def spawn(fn, world, tmp, tag):
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        store = os.path.join(tmp, "store_" + tag)
        procs = [ctx.Process(target=worker, args=(fn, r, world, store, tmp,
                                                  q)) for r in range(world)]
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
        return [got[r] for r in range(world)]


    if __name__ == "__main__":
        tmp = sys.argv[1]
        out = {"two": spawn(world2, 2, tmp, "2"),
               "four": spawn(world4, 4, tmp, "4")}
        with open(os.path.join(tmp, "ranks.pkl"), "wb") as f:
            pickle.dump(out, f)
        print("RESULT ok")
""")


def _seeded_cache(cfg, B, seed):
    """A whole cache of ``B`` rows and ``2·T`` positions (a ring keeps its
    window) of seeded values."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return torch.tensor(rng.normal(size=tuple(node.shape))
                            .astype(np.float32) * 0.5)

    return fill(TM.init_cache(cfg, B, 2 * T, device=CPU, mesh=None))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _inputs(cfg, mesh_name, seed):
    """The tokens and per-step cache indices of one case: ``STEPS`` steps
    from each row's first index (the ring's or the flat cache's)."""
    _, B, first = MESHES[mesh_name]
    start = first["ring" if cfg.sliding_window else "flat"]
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, STEPS)).astype(np.int64)
    index = [np.array(start, np.int64) + t for t in range(STEPS)]
    return tokens, index


@pytest.fixture(scope="module")
def cp_results(tmp_path_factory):
    """Inputs from seeds; one process's decode (the port's and the
    reference's) on the whole cache; the ranks' (from one subprocess)."""
    tmp = tmp_path_factory.mktemp("cp_decode")
    setup = {"meshes": {k: v[0] for k, v in MESHES.items()},
             "names": sorted(CASES), "cases": {}}
    want = {}
    for name, (arch, rep) in CASES.items():
        cfg, rcfg = _cfg(arch, rep), _cfg(arch, rep, ref=True)
        jp = jax.tree.map(np.asarray, JM.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
        params = bridge.to_torch(jp, CPU)
        for mesh_name, (_, B, _) in MESHES.items():
            cache = _seeded_cache(cfg, B, 3)
            tokens, index = _inputs(cfg, mesh_name, 4)
            setup["cases"][(mesh_name, name)] = {
                "cfg": (arch, rep), "cache": _clone(cache),
                "cache_len": 2 * T, "tokens": tokens, "index": index,
                "ref_params": jp}
            # copies: jnp.asarray would alias the numpy views of the
            # cache, which the port's decode below updates in place
            jc = jax.tree.map(jnp.array, bridge.to_numpy(cache))
            one, ref = [], []
            for t in range(STEPS):
                batch = {"tokens": torch.tensor(tokens[:, t:t + 1]),
                         "cache_index": torch.tensor(index[t])}
                lg, cache = TM.decode_step(params, cfg, cache, batch)
                one.append(lg.numpy().copy())
                jl, jc = JM.decode_step(jp, rcfg, jc, {
                    "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                    "cache_index": jnp.asarray(index[t], jnp.int32)})
                ref.append(np.asarray(jl))
            want[(mesh_name, name)] = {"logits": one, "cache": cache,
                                       "ref_logits": ref}
    with open(tmp / "setup.pkl", "wb") as f:
        pickle.dump(setup, f)
    script = tmp / "cp_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(script), str(tmp)], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(tmp / "ranks.pkl", "rb") as f:
        ranks = pickle.load(f)
    return {"setup": setup, "want": want, "ranks": ranks}


def _ranks(res, mesh_name):
    return res["ranks"]["four" if mesh_name == "d2m2" else "two"]


def _gathered(res, mesh_name, name):
    """The ranks' logits per step over the whole vocab (model ranks'
    shards of data rank 0, checked equal on every data rank), and their
    blocks put back together into the whole cache."""
    cfg = _cfg(*CASES[name])
    (D, m), B, _ = MESHES[mesh_name]
    got = [r[mesh_name][name] for r in _ranks(res, mesh_name)]
    logits = []
    for t in range(STEPS):
        rows = [np.concatenate([got[d * m + j]["logits"][t]
                                for j in range(m)], -1) for d in range(D)]
        for other in rows[1:]:
            np.testing.assert_array_equal(other, rows[0])
        logits.append(rows[0])
    mesh = MeshShape(("data", "model"), (D, m))
    cache = cp_assemble_cache([bridge.to_torch(g["cache"], CPU)
                               for g in got], cfg, mesh, B, 2 * T)
    return logits, cache, got


CP_CASES = [(mn, n) for mn in sorted(MESHES) for n in sorted(CASES)]


@pytest.mark.parametrize("mesh_name,name", CP_CASES)
def test_cp_decode_logits_match_one_process(cp_results, mesh_name, name):
    logits, _, _ = _gathered(cp_results, mesh_name, name)
    want = cp_results["want"][(mesh_name, name)]["logits"]
    cfg = _cfg(*CASES[name])
    for got, ref in zip(logits, want):
        assert got.shape == ref.shape == (ref.shape[0], cfg.padded_vocab)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mesh_name,name", CP_CASES)
def test_cp_decode_logits_match_reference(cp_results, mesh_name, name):
    """The same logits against the reference's single-device
    ``decode_step`` on the reference's weights and the same cache."""
    logits, _, _ = _gathered(cp_results, mesh_name, name)
    want = cp_results["want"][(mesh_name, name)]["ref_logits"]
    for got, ref in zip(logits, want):
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def _written(cfg, index, T_ring):
    """The cache positions each row's steps wrote (clamped, or modulo the
    ring)."""
    rows = np.stack(index, -1)                     # (B, STEPS)
    return np.remainder(rows, T_ring) if cfg.sliding_window else \
        np.minimum(rows, T_ring - 1)


@pytest.mark.parametrize("mesh_name,name", CP_CASES)
def test_cp_decode_caches_match_one_process(cp_results, mesh_name, name):
    """The blocks put back together: within 2e-5 of one process's cache
    after the same steps, and bit for bit where no step wrote (the masked
    writes leave every other position, on every rank, as the cut left
    it).  The written positions come from each layer's input, which the
    blocks' combined softmax sums round otherwise than one process's
    single sum past the first layer: not bit for bit."""
    cfg = _cfg(*CASES[name])
    (D, m), B, _ = MESHES[mesh_name]
    _, cache, _ = _gathered(cp_results, mesh_name, name)
    want = cp_results["want"][(mesh_name, name)]["cache"]
    start = cp_results["setup"]["cases"][(mesh_name, name)]["cache"]
    index = cp_results["setup"]["cases"][(mesh_name, name)]["index"]
    for (path, a), (_, b), (_, s) in zip(_paths(cache), _paths(want),
                                         _paths(start)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=path)
        keep = torch.ones(a.shape, dtype=torch.bool)
        if path.split("/")[-1] in ("k", "v"):
            wrote = _written(cfg, index, a.shape[-3])
            # the steps' writes move from one rank's block into another's
            lay = cache_layout(cfg, B, a.shape[-3],
                               MeshShape(("data", "model"), (D, m)))
            c = math.prod({"data": D, "model": m}[x] for x in lay.time)
            owners = wrote // (a.shape[-3] // c)
            assert c > 1 and any(len(set(o.tolist())) > 1 for o in owners), \
                (path, owners)
            for row, ts in enumerate(wrote):
                keep[..., row, ts.tolist(), :, :] = False
            assert torch.equal(a[keep], s[keep]), path
            assert not torch.equal(a[~keep], s[~keep]), path


@pytest.mark.parametrize("mesh_name,name", CP_CASES)
def test_cp_decode_collectives_exact(cp_results, mesh_name, name):
    """Per decode step, on every rank: two all-reduces per attention layer
    on the context group (the max, then the sums and values together);
    on the model axis the tensor-parallel decode's all-reduces and, where
    ``T`` is over ``"model"`` and the heads split over it, one all-gather
    of the query and new K/V heads per attention layer."""
    from test_torch_tp_serve import _expected_serve_all_reduces

    cfg = _cfg(*CASES[name])
    (D, m), B, _ = MESHES[mesh_name]
    mesh = MeshShape(("data", "model"), (D, m))
    win = cfg.sliding_window
    lay = cache_layout(cfg, B, min(2 * T, win) if win else 2 * T, mesh)
    L = cfg.n_layers
    heads = m > 1 and attn_split(cfg, m) and "model" in lay.time
    for r in _ranks(cp_results, mesh_name):
        got = r[mesh_name][name]
        assert got["cp_axes"] == list(lay.time)
        assert got["cp"] == _counts(all_reduce=2 * L * STEPS)
        if m == 1:
            assert got["tp"] is None
            continue
        assert got["tp"] == _counts(
            all_reduce=_expected_serve_all_reduces(cfg, m) * STEPS,
            all_gather=(L if heads else 0) * STEPS)


def test_cp_layouts_cover_each_head_path():
    """The cases take every path: heads split and gathered (granite,
    phi3's shared KV head, hymba), heads whole (qwen at 6 / 3), ``T`` over
    the model ranks, the data ranks and both."""
    lay = {mn: cache_layout(_cfg(*CASES["moe"]), MESHES[mn][1], 2 * T,
                            MeshShape(("data", "model"), MESHES[mn][0]))
           for mn in MESHES}
    assert lay["d1m2"].time == ("model",) and lay["d1m2"].batch == ("data",)
    assert lay["d2m1"].time == ("data", "model")
    assert lay["d2m2"].time == ("data", "model")
    assert attn_split(_cfg(*CASES["moe"]), 2)
    assert not attn_split(_cfg(*CASES["dense_whole_heads"]), 2)
    assert _cfg(*CASES["dense_shared_kv"]).n_kv_heads < 2
    assert _cfg(*CASES["hybrid_ring"]).sliding_window == T


def test_empty_blocks_add_nothing(cp_results):
    """Every valid position in rank 0's block of 4 (the other three mask
    all theirs): the combine equals one process's attention within 1e-6,
    finite, one max and one sum all-reduce."""
    for r in cp_results["ranks"]["four"]:
        e = r["empty_blocks"]
        assert e["finite"] and e["err"] <= 1e-6, e
        assert e["counts"] == _counts(all_reduce=2)
