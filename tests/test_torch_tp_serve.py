"""Tensor-parallel serving in the port (``decode_step``, span prefill and
the ``ContinuousBatcher`` on a ``(data, model)`` mesh) on the CPU.

One module-scoped subprocess spawns gloo ranks meeting at a ``file://``
store under the test's temporary directory (as ``tests/test_torch_tp.py``
does); any rank's traceback fails it.

* **(data 1, model 2), 2 ranks** — each of ``tests/test_torch_tp.py``'s
  nine family cases (SMOKE, fp32): four decode steps from a seeded whole
  cache (``cross_kv`` included) cut to each rank's layout
  (``tp_local_cache``), at per-row indices; the logits gathered over the
  vocab shards and the caches put back together (``tp_assemble_cache``)
  within 2e-5 of the one-process port, and for the dense, moe, hybrid,
  encdec and vlm cases, whose weights come from the reference's
  ``init_params`` through ``bridge.to_torch_tp``, within 2e-5 of the
  reference's single-device ``decode_step``.  The model axis's
  all-reduces per decode step and per prefill round are exact.  Chunked
  span prefill equals whole prefill on the ranks, max |Δ| 0.0.  The
  vocab-parallel argmax equals ``torch.argmax`` on rows whose ties cross
  the shard boundary.
* **(data 2, model 2), 4 ranks** — granite-moe SMOKE (fp32) through the
  ``ContinuousBatcher``: its tokens, admission trace, decode costs and
  stats equal the one-process batcher's exactly, on every rank, at its
  own capacity factor and at 0.25, where capacity binds (fault M: the
  MoE layers size it over every data rank's slots); each axis's
  collectives are exact per prefill round and decode step.
* **In process** — cache cuts put back together bit for bit, and
  ``init_cache`` on a mesh has the cut layout's shapes.
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
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshShape, tp_assemble_cache, tp_local_cache,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import batcher as TB  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 2e-5
B, T, STEPS = 2, 12, 4
#: the 2-rank family cases of tests/test_torch_tp.py: (arch, fields)
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
#: the cases whose weights come from the reference, held to its decode too
REF_CASES = ("dense", "moe_experts", "hybrid", "encdec", "vlm")
#: span prefill cases (dense/moe only, as the reference); the moe one at
#: capacity factor E / top_k, where no token is dropped whatever shares
#: its launch buffer
PREFILL_CASES = {
    "dense": ("phi3-mini-3.8b", {}),
    "moe_experts": ("granite-moe-1b-a400m", {"moe_capacity_factor": 2.0}),
    "dense_shared_kv": ("phi3-mini-3.8b", {"n_kv_heads": 1}),
}
CHUNKINGS = ([11], [1] * 11, [8, 3])
#: the 4-rank batcher run: (rid, arrive step, prompt length, max new)
SERVE_SPEC = [(0, 0, 2, 5), (1, 0, 9, 4), (2, 0, 5, 6), (3, 1, 13, 3),
              (4, 2, 3, 5), (5, 4, 7, 2), (6, 5, 1, 4), (7, 7, 11, 3)]
SERVE = dict(n_slots=4, cache_len=32, policy="dlbc", prefill_chunk=4)
#: the batcher runs: (config fields, batcher arguments) — granite's own
#: capacity factor, and 0.25 with 8-token chunks, where a prefill round
#: routes 64 pairs into 4 experts of 8 slots (per data rank alone, 32)
SERVE_CFG = {"own": ({}, SERVE),
             "tight": ({"moe_capacity_factor": 0.25},
                       dict(SERVE, prefill_chunk=8))}


def _cfg(arch, rep, ref=False):
    get = get_config if ref else t_get_config
    return dataclasses.replace(get(arch, smoke=True), dtype="float32", **rep)


# ---------------------------------------------------------------------------
# The subprocess: 2 ranks at (data 1, model 2), then 4 at (data 2, model 2)
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


    def decode_case(case, rank, tpc):
        \"\"\"STEPS decode steps on this rank's shards from the seeded
        cache: the local logits per step, the local cache after them and
        the model axis's collectives of the first step.\"\"\"
        from repro_torch import bridge
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import (
            tp_local_cache, tp_local_params)
        from repro_torch.models import model as TM

        cfg = cfg_of(*case["cfg"])
        if case["ref_params"] is not None:
            params = bridge.to_torch_tp(case["ref_params"], cfg, rank, 2,
                                        "cpu")
        else:
            params = tp_local_params(case["params"], cfg, rank, 2)
        cache = tp_local_cache(case["cache"], cfg, rank, 2)
        logits, counts = [], None
        for t in range(len(case["index"])):
            tp = Collectives(tpc.group)
            lg, cache = TM.decode_step(params, cfg, cache, {
                "tokens": torch.tensor(case["tokens"][:, t:t + 1]),
                "cache_index": torch.tensor(case["index"][t])}, tp=tp)
            logits.append(lg.numpy().copy())
            counts = counts or dict(tp.counts)
        return {"logits": logits, "cache": np_tree(cache), "counts": counts}


    def prefill_case(case, rank, tpc, mesh):
        \"\"\"Whole and chunked prefill of one prompt (row 0; row 1 inert)
        on this rank's shards, then one decode step: the local caches and
        logits of each chunking, and one round's collectives.\"\"\"
        from repro_torch.distributed.comm import Collectives
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM

        cfg = cfg_of(*case["cfg"])
        params = tp_local_params(case["params"], cfg, rank, 2)
        prompt = case["prompt"]
        runs, counts = [], None
        for sizes in case["chunkings"]:
            cache = TM.init_cache(cfg, 2, 32, device="cpu", mesh=mesh)
            pos = 0
            for s in sizes:
                toks = np.zeros((2, 16), np.int64)
                toks[0, :s] = prompt[pos:pos + s]
                tp = Collectives(tpc.group)
                TM.prefill_step(params, cfg, cache, {
                    "tokens": torch.tensor(toks),
                    "cache_index": torch.tensor([pos, 0]),
                    "count": torch.tensor([s, 0])}, tp=tp)
                counts = counts or dict(tp.counts)
                pos += s
            lg, _ = TM.decode_step(params, cfg, cache, {
                "tokens": torch.tensor([[prompt[-1]], [prompt[-1]]]),
                "cache_index": torch.tensor([pos, 0])}, tp=tpc)
            runs.append({"cache": np_tree(cache), "logits": lg.numpy()})
        return {"runs": runs, "counts": counts}


    def argmax_rows(rank, tpc, rows, vocab):
        \"\"\"``vocab_argmax`` of this rank's shard of ``rows``.\"\"\"
        from repro_torch.models import model as TM

        V = rows.shape[1] // 2
        shard = torch.tensor(rows[:, rank * V:(rank + 1) * V])
        return TM.vocab_argmax(shard, vocab, tpc).tolist()


    def world2(rank, tmp):
        from repro_torch.distributed.comm import Collectives
        from repro_torch.launch.mesh import make_test_mesh

        with open(os.path.join(tmp, "setup.pkl"), "rb") as f:
            setup = pickle.load(f)
        mesh = make_test_mesh(data=1, model=2, device_type="cpu")
        tpc = Collectives(mesh.get_group("model"))
        out = {"decode": {n: decode_case(c, rank, tpc)
                          for n, c in setup["decode"].items()},
               "prefill": {n: prefill_case(c, rank, tpc, mesh)
                           for n, c in setup["prefill"].items()},
               "argmax": [argmax_rows(rank, tpc, rows, vocab)
                          for rows, vocab in setup["argmax"]]}
        return out


    def world4(rank, tmp):
        from repro_torch.launch.mesh import make_test_mesh

        with open(os.path.join(tmp, "setup.pkl"), "rb") as f:
            setup = pickle.load(f)
        mesh = make_test_mesh(data=2, model=2, device_type="cpu")
        out = serve(setup["serve"], mesh)
        out["tight"] = serve(setup["serve_tight"], mesh)
        return out


    def serve(srv, mesh):
        from repro_torch.distributed.sharding import tp_local_params
        from repro_torch.models import model as TM
        from repro_torch.serve import batcher as TB

        cfg = cfg_of(*srv["cfg"])
        m_rank = dist.get_rank(mesh.get_group("model"))
        params = tp_local_params(srv["params"], cfg, m_rank, 2)
        b = TB.ContinuousBatcher(cfg, params, device="cpu", mesh=mesh,
                                 **srv["kw"])
        reqs = [TB.Request(rid=r, prompt=list(p), max_new=n,
                           arrive_step=t) for r, t, p, n in srv["trace"]]
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
                "admissions": b.admissions,
                "costs": b.stats.decode_step_costs,
                "summary": b.stats.summary(),
                "calls": calls, "rows": [b._rows.start, b._rows.stop],
                "tp": b.tp.counts, "dp": b.dp.counts,
                "cache_rows": int(b.cache["layers"]["k"].shape[1]),
                "cache_heads": int(b.cache["layers"]["k"].shape[3])}


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


def _seeded_cache(cfg, seed):
    """A whole cache of seeded values (self caches and ``cross_kv``)."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return torch.tensor(rng.normal(size=tuple(node.shape))
                            .astype(np.float32) * 0.5)

    return fill(TM.init_cache(cfg, B, T, device=CPU, mesh=None))


def _decode_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, STEPS)).astype(np.int64)
    index = [np.array([5 + t, 2 + t], np.int64) for t in range(STEPS)]
    return tokens, index


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _one_process_decode(params, cfg, cache, tokens, index):
    logits = []
    for t in range(STEPS):
        lg, cache = TM.decode_step(params, cfg, cache, {
            "tokens": torch.tensor(tokens[:, t:t + 1]),
            "cache_index": torch.tensor(index[t])})
        logits.append(lg.numpy().copy())
    return logits, cache


def _reference_decode(jp, cfg, cache, tokens, index):
    jc = jax.tree.map(jnp.asarray, bridge.to_numpy(cache))
    logits = []
    for t in range(STEPS):
        jl, jc = JM.decode_step(jp, cfg, jc, {
            "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
            "cache_index": jnp.asarray(index[t], jnp.int32)})
        logits.append(np.asarray(jl))
    return logits, jax.tree.map(np.asarray, jc)


def _argmax_rows():
    """Rows of 2 × 8 logits (two shards of 8) with ties across the shard
    boundary, a maximum in the padded tail, and all-equal rows; with the
    real vocab 13 (rank 1's tail padding) and 6 (rank 1 all padding)."""
    rows = np.zeros((6, 16), np.float32)
    rows[0, [7, 8]] = 3.0               # tie across the boundary
    rows[1, [3, 10]] = 2.0              # tie, rank 0 lower
    rows[2, 9] = 1.5                    # maximum on rank 1 only
    rows[3, 14] = 9.0                   # maximum in the padding
    rows[3, 12] = 4.0
    rows[4] = 1.0                       # every entry tied
    rows[5, [2, 11, 12]] = [0.5, 0.7, 0.7]
    return [(rows, 13), (rows, 6)]


@pytest.fixture(scope="module")
def serve_results(tmp_path_factory):
    """Inputs from seeds, the one-process port's and the reference's
    results, and the ranks' (from one subprocess)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    setup = {"decode": {}, "prefill": {}, "argmax": _argmax_rows()}
    want = {"decode": {}, "ref": {}, "prefill": {}}
    for name, (arch, rep) in CASES.items():
        cfg = _cfg(arch, rep)
        ref_params = None
        if name in REF_CASES:
            rcfg = _cfg(arch, rep, ref=True)
            jp = JM.init_params(rcfg, jax.random.PRNGKey(0))
            ref_params = jax.tree.map(np.asarray, jp)
            params = bridge.to_torch(ref_params, CPU)
        else:
            params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=CPU)
        cache = _seeded_cache(cfg, 3)
        tokens, index = _decode_inputs(cfg, 4)
        setup["decode"][name] = {
            "cfg": (arch, rep), "cache": _clone(cache), "tokens": tokens,
            "index": index, "ref_params": ref_params,
            "params": None if ref_params is not None else params}
        want["decode"][name] = _one_process_decode(params, cfg, cache,
                                                   tokens, index)
        if name in REF_CASES:
            want["ref"][name] = _reference_decode(
                jp, rcfg, setup["decode"][name]["cache"], tokens, index)
    for name, (arch, rep) in PREFILL_CASES.items():
        cfg = _cfg(arch, rep)
        setup["prefill"][name] = {
            "cfg": (arch, rep), "chunkings": CHUNKINGS,
            "params": TM.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=CPU),
            "prompt": np.random.default_rng(7).integers(
                0, cfg.vocab, size=12).tolist()}
    for key, (rep, kw) in SERVE_CFG.items():
        cfg = _cfg("granite-moe-1b-a400m", rep)
        rng = np.random.default_rng(1)
        trace = [(r, t, rng.integers(0, cfg.vocab, size=n).tolist(), m)
                 for r, t, n, m in SERVE_SPEC]
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device=CPU)
        name = "serve" if key == "own" else f"serve_{key}"
        setup[name] = {"cfg": ("granite-moe-1b-a400m", rep),
                       "params": params, "trace": trace, "kw": kw}
        one = TB.ContinuousBatcher(cfg, params, device="cpu", **kw)
        reqs = [TB.Request(rid=r, prompt=list(p), max_new=n, arrive_step=t)
                for r, t, p, n in trace]
        one.run(reqs)
        want[name] = {"tokens": [r.tokens for r in reqs],
                      "admissions": one.admissions,
                      "costs": one.stats.decode_step_costs,
                      "summary": one.stats.summary()}
    with open(tmp / "setup.pkl", "wb") as f:
        pickle.dump(setup, f)
    script = tmp / "tp_serve_ranks.py"
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


def _gathered(res, name):
    """The 2 ranks' decode of case ``name``: logits per step over the whole
    vocab, and the whole cache (numpy)."""
    cfg = _cfg(*CASES[name])
    got = [res["ranks"]["two"][r]["decode"][name] for r in range(2)]
    logits = [np.concatenate([g["logits"][t] for g in got], -1)
              for t in range(STEPS)]
    cache = tp_assemble_cache([[bridge.to_torch(g["cache"], CPU)
                                for g in got]], cfg)
    return logits, cache


def _leaves(tree):
    """(path, numpy) leaves of a cache tree, empty dicts skipped."""
    if isinstance(tree, dict):
        return [(f"/{k}{p}", v) for k in sorted(tree)
                for p, v in _leaves(tree[k])]
    return [("", np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                            else tree))]


# ---------------------------------------------------------------------------
# (data 1, model 2): decode and prefill against one process and the
# reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_decode_logits_match_one_process(serve_results, name):
    logits, _ = _gathered(serve_results, name)
    want, _ = serve_results["want"]["decode"][name]
    cfg = _cfg(*CASES[name])
    for got, ref in zip(logits, want):
        assert got.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_decode_caches_match_one_process(serve_results, name):
    _, cache = _gathered(serve_results, name)
    _, want = serve_results["want"]["decode"][name]
    got, ref = _leaves(cache), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=path)


@pytest.mark.parametrize("name", REF_CASES)
def test_model2_decode_matches_reference(serve_results, name):
    """Weights from the reference's ``init_params`` through
    ``bridge.to_torch_tp`` on each rank: the gathered logits and caches of
    every step within 2e-5 of the reference's single-device decode."""
    logits, cache = _gathered(serve_results, name)
    want_logits, want_cache = serve_results["want"]["ref"][name]
    for got, ref in zip(logits, want_logits):
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    got, ref = _leaves(cache), _leaves(want_cache)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=path)


def _layer_reduces(cfg, kind: str, m: int) -> int:
    """A layer's model-axis all-reduces in one decode step or prefill
    round: attention's ``wo`` (and the cross attention's) where the heads
    split over ``m``, the mamba mixer's ``x_proj`` and ``out_proj``, the
    FFN's output."""
    from repro_torch.distributed.sharding import attn_split

    attn = 1 if attn_split(cfg, m) else 0
    return {"dense": attn + 1, "moe": attn + 1, "ssm": 2,
            "hybrid": attn + 2 + 1, "dec": 2 * attn + 1,
            "cross": attn + 1}[kind]


def _expected_serve_all_reduces(cfg, m: int = 2) -> int:
    """The model axis's all-reduces per decode step (S = 1, so never
    sequence-parallel): the embedding's, then every layer's; the head is
    column-parallel and issues none."""
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_every
        layers = g * ((cfg.cross_every - 1) * _layer_reduces(
            cfg, "dense", m) + _layer_reduces(cfg, "cross", m))
    elif cfg.family == "encdec":
        layers = cfg.n_layers * _layer_reduces(cfg, "dec", m)
    else:
        layers = cfg.n_layers * _layer_reduces(cfg, cfg.family, m)
    return 1 + layers


def _expected_prefill_collectives(cfg, m: int = 2) -> dict:
    """The model axis's collectives per prefill round of a dense or moe
    config whose chunk ``m`` divides, sequence-parallel: the embedding's
    reduce-scatter onto the sequence blocks; per layer the all-gathers
    of attention's and the FFN's normed inputs, and the reduce-scatters of
    the FFN's output and of attention's where its heads split over ``m``
    (whole attention leaves by a slice); the head input's all-gather.
    No all-reduce (before sequence parallelism: ``1 + 2L``)."""
    from repro_torch.distributed.sharding import attn_split

    L = cfg.n_layers
    attn = 1 if attn_split(cfg, m) else 0
    return dict.fromkeys(("all_reduce", "reduce_scatter", "all_gather",
                          "all_to_all", "send_recv"), 0) | {
        "reduce_scatter": 1 + L * (attn + 1), "all_gather": 1 + 2 * L}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model2_decode_collectives_exact(serve_results, name):
    cfg = _cfg(*CASES[name])
    for r in range(2):
        counts = serve_results["ranks"]["two"][r]["decode"][name]["counts"]
        assert counts == dict(dict.fromkeys(counts, 0),
                              all_reduce=_expected_serve_all_reduces(cfg))


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_model2_chunked_prefill_is_bitwise_whole(serve_results, name):
    """Whole prefill of 11 tokens against 11 × 1 and 8 + 3 on the ranks:
    every local cache leaf and the next decode step's logits equal, max
    |Δ| == 0.0, and one prefill round's collectives exact."""
    cfg = _cfg(*PREFILL_CASES[name])
    for r in range(2):
        got = serve_results["ranks"]["two"][r]["prefill"][name]
        whole = got["runs"][0]
        for run in got["runs"][1:]:
            for (path, a), (_, b) in zip(_leaves(run["cache"]),
                                         _leaves(whole["cache"])):
                assert float(np.abs(a - b).max()) == 0.0, path
            assert float(np.abs(run["logits"] - whole["logits"]).max()) \
                == 0.0
        assert got["counts"] == _expected_prefill_collectives(cfg)


@pytest.mark.parametrize("case", [0, 1])
def test_vocab_argmax_equals_torch_argmax_across_shards(serve_results,
                                                        case):
    rows, vocab = serve_results["setup"]["argmax"][case]
    want = torch.argmax(torch.tensor(rows)[:, :vocab], dim=-1).tolist()
    for r in range(2):
        assert serve_results["ranks"]["two"][r]["argmax"][case] == want


# ---------------------------------------------------------------------------
# (data 2, model 2): the batcher against one process
# ---------------------------------------------------------------------------


def test_data2_model2_batcher_tokens_match_one_process(serve_results):
    want = serve_results["want"]["serve"]
    for got in serve_results["ranks"]["four"]:
        assert got["tokens"] == want["tokens"]
        assert all(len(t) > len(p) for t, (_, _, p, _) in zip(
            got["tokens"], serve_results["setup"]["serve"]["trace"]))


def test_data2_model2_batcher_schedule_matches_one_process(serve_results):
    """The same admissions, decode costs and stats on every rank: the host
    scheduler is replicated and sees every slot."""
    want = serve_results["want"]["serve"]
    for got in serve_results["ranks"]["four"]:
        assert [tuple(a) for a in got["admissions"]] == \
            [tuple(a) for a in want["admissions"]]
        assert got["costs"] == want["costs"]
        assert got["summary"] == want["summary"]


def test_data2_model2_batcher_rows_and_cache_layout(serve_results):
    """Data rank d launches on slots [2d, 2d + 2) with a cache of those
    rows and its one KV head (granite SMOKE: KV 2 over 2 model ranks)."""
    for g, got in enumerate(serve_results["ranks"]["four"]):
        d = g // 2
        assert got["rows"] == [2 * d, 2 * d + 2]
        assert got["cache_rows"] == 2 and got["cache_heads"] == 1


def test_data2_model2_batcher_collectives_exact(serve_results):
    """Per prefill round (chunk 4, sequence-parallel) the model axis's
    all-gathers and reduce-scatters; per decode step its all-reduces, the
    argmax's all-gather over the model ranks and the tokens' all-gather
    over the data ranks, and per MoE layer and launch the two all-gathers
    of ``dlbc``'s pair counts over the data ranks (fault M)."""
    cfg = _cfg("granite-moe-1b-a400m", {})
    per = _expected_serve_all_reduces(cfg)
    pre = _expected_prefill_collectives(cfg)
    zero = dict.fromkeys(pre, 0)
    for got in serve_results["ranks"]["four"]:
        n_pre, n_dec = got["calls"]["prefill"], got["calls"]["decode"]
        assert n_pre > 0 and n_dec > 0
        assert got["tp"] == dict(
            zero, all_reduce=per * n_dec,
            reduce_scatter=pre["reduce_scatter"] * n_pre,
            all_gather=n_dec + pre["all_gather"] * n_pre)
        assert got["dp"] == dict(
            zero, all_gather=n_dec + 2 * cfg.n_layers * (n_pre + n_dec))


def test_data2_model2_batcher_tight_capacity_matches_one_process(
        serve_results):
    """At capacity factor 0.25, where the MoE layers drop pairs in every
    launch, every rank's tokens, admissions, decode costs and stats equal
    the one-process batcher's: capacity and slot positions are sized
    over every data rank's slots, as one process sizes them over all of
    its slots."""
    want = serve_results["want"]["serve_tight"]
    for got in (r["tight"] for r in serve_results["ranks"]["four"]):
        assert got["tokens"] == want["tokens"]
        assert [tuple(a) for a in got["admissions"]] == \
            [tuple(a) for a in want["admissions"]]
        assert got["costs"] == want["costs"]
        assert got["summary"] == want["summary"]


# ---------------------------------------------------------------------------
# In process: the cache layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_cut_assembles_bitwise(arch):
    """A seeded whole cache cut to every rank of (data 2, model 2)
    (``tp_local_cache``) and put back together is the whole cache bit for
    bit."""
    cfg = _cfg(arch, {})
    cache = _seeded_cache(cfg, 9)
    pieces = [[tp_local_cache(cache, cfg, r, 2, d, 2) for r in range(2)]
              for d in range(2)]
    back = tp_assemble_cache(pieces, cfg)
    for (p, a), (_, b) in zip(_leaves(back), _leaves(cache)):
        assert a.shape == b.shape and np.array_equal(a, b), p


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_cache_on_mesh_has_local_layout(name):
    """``init_cache`` on a (data 2, model 2) mesh has the shapes of a whole
    cache's ``tp_local_cache``: B / 2 rows, the rank's KV heads (one where
    KV < 2, all where the heads do not split) and d_inner / 2."""
    cfg = _cfg(*CASES[name])
    mesh = MeshShape(("data", "model"), (2, 2))
    local = TM.init_cache(cfg, 4, T, device=CPU, mesh=mesh)
    cut = tp_local_cache(TM.init_cache(cfg, 4, T, device=CPU, mesh=None),
                         cfg, 1, 2, 1, 2)
    assert [(p, a.shape, a.dtype) for p, a in _leaves(local)] == \
        [(p, a.shape, a.dtype) for p, a in _leaves(cut)]
    assert len(tree_leaves(local)) == len(tree_leaves(cut))
