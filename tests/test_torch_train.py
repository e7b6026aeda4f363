"""The port's training path (optimizer, train step, checkpoints, trainer,
launcher, data pipeline) against the JAX reference, on the CPU.

Weights and optimizer state come from the reference through the bridge,
in fp32, on the granite-moe SMOKE config (and a tiny dense config for the
loss curve).  One AdamW step of every policy arm: grad norm within rel
1e-5, m and v within 2e-5 × their largest value, params within 2e-5.
Adam's first update is sign-like where a gradient is near zero, so the
step compared is the second one, from a state the reference's first step
wrote (m, not the sign of a first update).  Bucket plans and schedule
counts are equal exactly; checkpoints round-trip bitwise in both
directions between the packages.
"""

import dataclasses
import json
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.launch import train as JLaunch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch import train as TLaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    SimulatedFailure, TrainerConfig, run_training,
)
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = torch.device("cpu")
ARCH = "granite-moe-1b-a400m"
SCHED_POLICIES = ("serial", "lc", "dlbc", "dcafe")


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp()
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _cfgs(arch=ARCH):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32"))


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _np_leaves(tree):
    """Leaves of a JAX or torch tree as fp32 numpy, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


def _close_to_max(got, ref, tol, what):
    for i, (g, r) in enumerate(zip(_np_leaves(got), _np_leaves(ref))):
        assert g.shape == r.shape, (what, i)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol}×{scale}"


def _close_after_bf16_rounding(ts2, js2, js, ocfg):
    """m and v of the bf16-compressed arm: within 2e-5 × max, except where
    the two packages' fp32 gradients (equal to ~1e-7) round to neighbouring
    bf16 values — those elements may differ by the moment's share of one
    bf16 step of the gradient (2^-7 relative), and they must be rare."""
    b1, b2 = ocfg.b1, ocfg.b2
    for i, (tm, jm, jm1, tv, jv) in enumerate(zip(
            _np_leaves(ts2["m"]), _np_leaves(js2["m"]), _np_leaves(js["m"]),
            _np_leaves(ts2["v"]), _np_leaves(js2["v"]))):
        g = np.abs(jm - b1 * jm1) / (1 - b1)      # the reference's |grad|
        step = 2.0 ** -7 * g
        for got, ref, share, what in (
                (tm, jm, (1 - b1) * step, "m"),
                (tv, jv, (1 - b2) * step * (2 * g + step), "v")):
            base = 2e-5 * float(np.abs(ref).max())
            err = np.abs(got - ref)
            assert bool(np.all(err <= base + share * 1.01)), (what, i)
            assert float(np.mean(err > base)) <= 0.01, (what, i)


@pytest.fixture(scope="module")
def stepped():
    """The reference's state after one step from its own init: params,
    optimizer state (m, v, master, step 1) and the next batch."""
    cfg, tcfg = _cfgs()
    shape = ShapeConfig("s", 16, 4, "train", microbatches=2)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jp, ocfg)
    step, _ = JT.build_train_step(cfg, shape, JT.StepConfig(), ocfg)
    b0 = _batch(cfg, 4, 16, 0)
    jp, js, _ = jax.jit(step)(jp, js, {k: jnp.asarray(v)
                                       for k, v in b0.items()})
    return cfg, tcfg, shape, ocfg, jp, js, _batch(cfg, 4, 16, 1)


@pytest.mark.parametrize("policy,compress", [
    ("unopt", "none"), ("lc", "none"), ("afe", "none"),
    ("afe_bucket", "none"), ("afe_bucket", "bf16")])
def test_one_step_matches_reference(stepped, policy, compress):
    cfg, tcfg, shape, ocfg, jp, js, batch = stepped
    scfg = dict(policy=policy, grad_compress=compress, q_chunk=8, k_chunk=8)
    jstep, jshard = JT.build_train_step(cfg, shape, JT.StepConfig(**scfg),
                                        ocfg)
    jp2, js2, jm = jax.jit(jstep)(jp, js, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tp, ts = bridge.to_torch(jp, CPU), bridge.to_torch(js, CPU)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    tstep, tshard = TT.build_train_step(
        tcfg, TShapeConfig("s", 16, 4, "train", microbatches=2),
        TT.StepConfig(**scfg), TO.AdamWConfig(lr=1e-3, warmup_steps=2))
    assert tshard == jshard
    tp2, ts2, tm = tstep(tp, ts, {k: torch.tensor(v)
                                  for k, v in batch.items()})
    gj, gt = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(gt - gj) <= 1e-5 * gj
    assert int(tm["nonfinite_skipped"]) == int(jm["nonfinite_skipped"]) == 0
    assert int(ts2["step"]) == int(js2["step"]) == 2
    if compress == "bf16":
        _close_after_bf16_rounding(ts2, js2, js, ocfg)
    else:
        _close_to_max(ts2["m"], js2["m"], 2e-5, "m")
        _close_to_max(ts2["v"], js2["v"], 2e-5, "v")
    for g, r in zip(_np_leaves(tp2), _np_leaves(jp2)):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=0)
    _close_to_max(ts2["master"], js2["master"], 2e-5, "master")


@pytest.mark.parametrize("sched_policy", SCHED_POLICIES)
def test_bucket_plans_and_sched_counts_match_reference(sched_policy):
    cfg, tcfg = _cfgs()
    jp = JM.init_params(cfg, jax.random.PRNGKey(3))
    tp = bridge.to_torch(jp, CPU)
    for n_buckets in (1, 2, 4, 7):
        jflat, _ = JT._bucketize(jp, n_buckets, policy=sched_policy)
        tflat, tunflat = TT._bucketize(tp, n_buckets, policy=sched_policy)
        jb = jflat(jax.tree.leaves(jp))
        tb = tflat(tree_leaves(tp))
        assert [b.shape[0] for b in tb] == [b.shape[0] for b in jb]
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        back = tunflat(tb)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                      tree_leaves(tp)))
    for policy in TT.POLICIES:
        for M in (1, 2, 4):
            jshape = ShapeConfig("s", 16, 8, "train", microbatches=M)
            tshape = TShapeConfig("s", 16, 8, "train", microbatches=M)
            js, _ = JT.build_train_step(
                cfg, jshape, JT.StepConfig(policy=policy,
                                           sched_policy=sched_policy),
                JO.AdamWConfig())
            ts, _ = TT.build_train_step(
                tcfg, tshape, TT.StepConfig(policy=policy,
                                            sched_policy=sched_policy),
                TO.AdamWConfig())
            assert ts.sched_counts == js.sched_counts


def _opt_case(seed, scale=1.0, nan=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 6), "b": {"c": (5,), "d": (3, 2, 2)}}

    def tree(f):
        return {"a": f(shapes["a"]),
                "b": {"c": f(shapes["b"]["c"]), "d": f(shapes["b"]["d"])}}
    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = tree(lambda s: (rng.normal(size=s) * scale).astype(np.float32))
    if nan:
        grads["b"]["c"][2] = np.nan
    return params, grads


@pytest.mark.parametrize("case", ["warmup", "clip", "nonfinite"])
def test_adamw_update_matches_reference(case):
    kw = {"warmup": dict(warmup_steps=10, grad_clip=100.0),
          "clip": dict(warmup_steps=1, grad_clip=0.5),
          "nonfinite": dict(warmup_steps=1)}[case]
    params, grads = _opt_case(5, scale=3.0, nan=case == "nonfinite")
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init_opt_state(jp, jo)
    tp = bridge.to_torch(params, CPU)
    ts = TO.init_opt_state(tp, to)
    for i in range(3):  # three updates, the state carried between them
        g = grads if i == 2 else _opt_case(10 + i, scale=3.0)[1]
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     jo)
        tp, ts, tm = TO.adamw_update(tp, bridge.to_torch(g, CPU), ts, to)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
        assert int(tm["nonfinite_skipped"]) == int(jm["nonfinite_skipped"])
        if int(jm["nonfinite_skipped"]) == 0:
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
                <= 1e-6 * float(jm["grad_norm"])
        for got, ref in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"]),
                         (ts["master"], js["master"])):
            for a, b in zip(_np_leaves(got), _np_leaves(ref)):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    if case == "nonfinite":
        assert int(tm["nonfinite_skipped"]) == 1
    if case == "clip":
        assert float(jm["grad_norm"]) > 0.5


def test_nonfinite_step_is_skipped_atomically():
    params, grads = _opt_case(6, nan=True)
    to = TO.AdamWConfig(warmup_steps=1)
    tp = bridge.to_torch(params, CPU)
    ts = TO.init_opt_state(tp, to)
    before = [t.clone() for t in tree_leaves(tp) + tree_leaves(ts["master"])]
    tp, ts, tm = TO.adamw_update(tp, bridge.to_torch(grads, CPU), ts, to)
    after = tree_leaves(tp) + tree_leaves(ts["master"])
    assert int(tm["nonfinite_skipped"]) == 1 and int(ts["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert all(float(t.abs().sum()) == 0.0
               for t in tree_leaves(ts["m"]) + tree_leaves(ts["v"]))


def test_optimizer_state_shapes_follow_params():
    _, tcfg = _cfgs()
    shapes = TM.param_shapes(tcfg)
    st = TO.opt_state_shapes(shapes, TO.AdamWConfig())
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    real = TO.init_opt_state(params, TO.AdamWConfig())
    for name in ("m", "v", "master"):
        assert [(t.shape, t.dtype) for t in tree_leaves(st[name])] == \
            [(t.shape, t.dtype) for t in tree_leaves(real[name])]
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == \
        [tuple(t.shape) for t in tree_leaves(params)]
    cfg, _ = _cfgs()
    assert [tuple(s.shape) for s in jax.tree.leaves(JM.param_shapes(cfg))] \
        == [tuple(t.shape) for t in tree_leaves(shapes)]


def test_bridge_carries_optimizer_state_both_ways():
    cfg, _ = _cfgs()
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    js = JO.init_opt_state(jp, JO.AdamWConfig())
    js["step"] = jnp.asarray(7, jnp.int32)
    ts = bridge.to_torch(js, CPU)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 7
    back = bridge.to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eval_prefill_and_decode_builders_match_reference():
    cfg, tcfg = _cfgs()
    jp = JM.init_params(cfg, jax.random.PRNGKey(2))
    tp = bridge.to_torch(jp, CPU)
    b = _batch(cfg, 2, 12, 4)
    jl = JT.build_eval_loss(cfg, JT.StepConfig(q_chunk=4, k_chunk=4))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl = TT.build_eval_loss(tcfg, TT.StepConfig())(
        tp, {k: torch.tensor(v) for k, v in b.items()})
    assert abs(float(tl) - float(jl)) <= 1e-5
    jn = JT.build_prefill_step(cfg, JT.StepConfig(q_chunk=4, k_chunk=4))(
        jp, {"tokens": jnp.asarray(b["tokens"])})
    tn = TT.build_prefill_step(tcfg, TT.StepConfig())(
        tp, {"tokens": torch.tensor(b["tokens"])})
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4,
                               rtol=1e-4)
    cache = TM.init_cache(tcfg, 2, 8, device="cpu")
    logits, _ = TT.build_decode_step(tcfg)(tp, cache, {
        "tokens": torch.tensor(b["tokens"][:, :1]),
        "cache_index": torch.tensor(0)})
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_training_loss_decreases():
    """Mirror of ``tests/test_system.py::test_training_loss_decreases``."""
    cfg = TModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    shape = TShapeConfig("t", 64, 8, "train", microbatches=2)
    d = tempfile.mkdtemp()
    try:
        rep = run_training(
            cfg, shape, TrainerConfig(steps=30, ckpt_every=100, ckpt_dir=d),
            TT.StepConfig(q_chunk=32, k_chunk=32),
            TO.AdamWConfig(lr=1e-3, warmup_steps=5), device="cpu")
        assert rep.completed == 30
        assert rep.losses[-1] < rep.losses[0]
        assert len(rep.grad_norms) == 30
        assert all(np.isfinite(rep.grad_norms))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_checkpoint_roundtrip_bf16(tmpdir):
    """bf16 and int32 round-trip bitwise; one join per save under dcafe."""
    mgr = CheckpointManager(tmpdir, keep=2)
    a = torch.randn(8).to(torch.bfloat16)
    tree = {"a": a, "b": {"c": torch.ones((3, 3)),
                          "s": torch.tensor(3, dtype=torch.int32)}}
    joins0 = mgr.telemetry.joins
    mgr.save(5, tree, blocking=True)
    assert mgr.telemetry.joins - joins0 == 1
    step, out = mgr.restore(device="cpu")
    mgr.close()
    assert step == 5
    assert out["a"].dtype == torch.bfloat16 and torch.equal(
        out["a"].view(torch.int16), a.view(torch.int16))
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["s"].dtype == torch.int32 and int(out["b"]["s"]) == 3


def test_checkpoint_gc_and_latest(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(2)}, blocking=True)
    mgr.close()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_incomplete_checkpoint_ignored(tmpdir):
    mgr = CheckpointManager(tmpdir, keep=3)
    mgr.save(1, {"x": torch.ones(2)}, blocking=True)
    mgr.close()
    # fake a torn write: a step dir without COMMIT
    (mgr.dir / "step_0000000002").mkdir()
    assert mgr.latest_step() == 1


def test_snapshot_is_a_copy(tmpdir):
    """The optimizer updates in place: a non-blocking save must have
    copied the tensors before the caller changes them."""
    mgr = CheckpointManager(tmpdir)
    x = torch.zeros(64)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    mgr.close()
    assert float(mgr.restore(device="cpu")[1]["x"].abs().sum()) == 0.0


def test_reference_checkpoint_restores_in_the_port(tmpdir):
    jm = JCkpt(tmpdir)
    tree = {"p": {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
                  "b": jnp.linspace(0, 1, 5, dtype=jnp.float32)},
            "step": jnp.asarray(9, jnp.int32)}
    jm.save(3, tree, blocking=True)
    jm.close()
    step, out = CheckpointManager(tmpdir).restore(device="cpu")
    assert step == 3
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(out)),
                    jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_checkpoint_restores_in_the_reference(tmpdir):
    tm = CheckpointManager(tmpdir)
    tree = {"w": torch.arange(12).reshape(3, 4).to(torch.bfloat16),
            "step": torch.tensor(4, dtype=torch.int32)}
    tm.save(2, tree, blocking=True)
    tm.close()
    step, out = JCkpt(tmpdir).restore()
    assert step == 2
    assert out["w"].dtype == jnp.bfloat16 and out["step"].dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(out["w"], np.float32),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    assert int(out["step"]) == 4


def test_failure_injection_and_exact_resume(tmpdir):
    """Mirror of ``tests/test_fault_tolerance.py``: a crash after step 5,
    a resume from the step-4 checkpoint, and the final eval loss of an
    uninterrupted run within 1e-5."""
    cfg = t_get_config("phi3-mini-3.8b", smoke=True)
    shape = TShapeConfig("s", 64, 4, "train", microbatches=2)
    with pytest.raises(SimulatedFailure):
        run_training(cfg, shape, TrainerConfig(
            steps=8, ckpt_every=2, ckpt_dir=tmpdir, failure_at=5),
            device="cpu")
    rep = run_training(cfg, shape, TrainerConfig(
        steps=8, ckpt_every=2, ckpt_dir=tmpdir), device="cpu")
    assert rep.resumed_from == 4
    assert rep.completed == 8
    d2 = tempfile.mkdtemp()
    try:
        ref = run_training(cfg, shape, TrainerConfig(
            steps=8, ckpt_every=100, ckpt_dir=d2), device="cpu")
        assert rep.losses[-1] == pytest.approx(ref.losses[-1], abs=1e-5)
    finally:
        shutil.rmtree(d2, ignore_errors=True)


def test_data_pipeline_restart_determinism():
    cfg = DataConfig(seq_len=32, global_batch=8, vocab=100, seed=7,
                     n_shards=4)
    p1 = SyntheticPipeline(cfg)
    p2 = SyntheticPipeline(cfg)
    for step in (0, 3, 17):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_batches_equal_the_reference():
    kw = dict(seq_len=48, global_batch=8, vocab=49155, seed=3, n_shards=4)
    tp, jp = SyntheticPipeline(DataConfig(**kw)), JPipeline(JDataConfig(**kw))
    for step in (0, 1, 9):
        t, j = tp.batch_at(step), jp.batch_at(step)
        for k in ("tokens", "labels"):
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_train_cli_prints_the_reference_keys(tmpdir, capsys):
    common = ["--arch", "qwen2.5-32b", "--smoke", "--steps", "2",
              "--seq-len", "16", "--global-batch", "2", "--microbatches",
              "1", "--ckpt-every", "1"]
    JLaunch.main(common + ["--ckpt-dir", tmpdir + "/ref"])
    ref = json.loads(capsys.readouterr().out)
    out = TLaunch.main(common + ["--ckpt-dir", tmpdir + "/port",
                                 "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert sorted(printed) == sorted(ref)
    assert sorted(printed["sched"]) == sorted(ref["sched"])
    assert printed["completed"] == ref["completed"] == 2
    assert printed["sched"]["train_step"]["spawns"] == \
        ref["sched"]["train_step"]["spawns"]
