"""The encoder-decoder (whisper-medium) and vision-language
(llama-3.2-vision-90b) families of the port against the JAX reference, on
the CPU.

Weights come from the reference's ``init_params`` through the bridge, in
fp32, on both SMOKE configs; ``enc_frames`` and ``vis_embed`` are seeded
numpy arrays.  Logits, loss and every updated cache leaf within 2e-5;
parameter and cache trees key for key with the same shapes and dtypes.
Port-only: token-by-token decode, with ``cross_kv`` filled from the
encoder output (or the vision embeddings) through each cross layer's own
``wk`` / ``wv`` (``chip_smoke.fill_cross_kv``, harness code: neither
package has such an API), reproduces ``forward`` position by position.
One AdamW step per family against the reference's ``build_train_step``
(the second step, from a state the reference's first step wrote; grad
norm within rel 1e-5, m, v and master within 2e-5 × their largest value,
params within 2e-5) with the same bucket plans, and the training CLI's
crash and exact resume.
"""

import dataclasses
import shutil
import tempfile

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
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.launch import train as TLaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.trainer import SimulatedFailure  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from chip_smoke import fill_cross_kv  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("whisper-medium", "llama-3.2-vision-90b")
TOL = 2e-5


def _cfgs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32"))


def _ctx_key(cfg):
    return ("enc_frames", cfg.enc_seq) if cfg.family == "encdec" \
        else ("vis_embed", cfg.vis_seq)


def _batch(cfg, B, S, seed):
    """Seeded tokens, labels and frame / patch embeddings (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    key, n = _ctx_key(cfg)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            key: rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, empty dicts kept as leaves and JAX
    arrays made numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v if isinstance(v, (dict, torch.Tensor)) \
                else np.asarray(v)
    return out


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, bridge.to_torch(jp, CPU)


def test_forward_matches_reference(pair):
    cfg, tcfg, jp, tp = pair
    batch = _batch(cfg, 2, 24, 0)
    del batch["labels"]
    jl = JM.forward(jp, cfg, _jb(batch), q_chunk=8, k_chunk=8)
    tl = TM.forward(tp, tcfg, _tb(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jlast = JM.forward(jp, cfg, _jb(batch), last_only=True)
    tlast = TM.forward(tp, tcfg, _tb(batch), last_only=True)
    assert tuple(tlast.shape) == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=TOL,
                               rtol=TOL)


def test_loss_matches_reference(pair):
    cfg, tcfg, jp, tp = pair
    batch = _batch(cfg, 2, 16, 1)
    jl = JM.loss_fn(jp, cfg, _jb(batch))
    tl = TM.loss_fn(tp, tcfg, _tb(batch))
    assert abs(float(tl) - float(jl)) <= TOL


def test_bf16_frames_are_cast_to_the_activations(pair):
    """The reference casts ``enc_frames`` / ``vis_embed`` to the
    activations' dtype: bf16 frames in an fp32 model give the logits of
    the same values in fp32."""
    cfg, tcfg, jp, tp = pair
    batch = _tb(_batch(cfg, 1, 8, 2))
    key, _ = _ctx_key(cfg)
    as_bf16 = dict(batch, **{key: batch[key].to(torch.bfloat16)})
    rounded = dict(batch, **{key: as_bf16[key].float()})
    torch.testing.assert_close(TM.forward(tp, tcfg, as_bf16),
                               TM.forward(tp, tcfg, rounded), atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_tree(arch):
    """Key for key, with the reference's shapes and dtypes: no encoder
    cache, an empty ``cross_layers`` dict for vlm, the nested (g, k-1)
    self caches and ``cross_kv``."""
    cfg, tcfg = get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    jc = _flat(JM.init_cache(cfg, 3, 20))
    tc = _flat(TM.init_cache(tcfg, 3, 20, device=CPU))
    assert sorted(jc) == sorted(tc)
    for k, v in jc.items():
        if isinstance(v, dict):
            assert tc[k] == {}, k
            continue
        assert tuple(tc[k].shape) == v.shape, k
        assert str(tc[k].dtype).split(".")[-1] == v.dtype.name, k
        assert not bool(tc[k].any()), k
    assert {"/cross_kv/k", "/cross_kv/v"} <= set(tc)
    assert not any(k.startswith("/enc") for k in tc)


def _seeded_cache(cfg, B, T, seed):
    """A cache tree of seeded values: self caches and ``cross_kv``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5,
        jax.tree.map(np.asarray, JM.init_cache(cfg, B, T)))


def test_decode_step_matches_reference(pair):
    """Two decode steps (a scalar index, then per-row indices) from the
    same seeded caches, non-zero ``cross_kv`` included: the logits and
    every cache leaf agree after each step."""
    cfg, tcfg, jp, tp = pair
    B, T = 2, 12
    jc = jax.tree.map(jnp.asarray, _seeded_cache(cfg, B, T, 3))
    tc = bridge.to_torch(jax.tree.map(np.asarray, jc), CPU)
    toks = _batch(cfg, B, 2, 4)["tokens"]
    for t, idx in enumerate((np.int32(5), np.array([6, 9], np.int32))):
        jl, jc = JM.decode_step(jp, cfg, jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_index": jnp.asarray(idx)})
        tl, tc = TM.decode_step(tp, tcfg, tc, {
            "tokens": torch.tensor(toks[:, t:t + 1]),
            "cache_index": torch.tensor(idx)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        jf, tf = _flat(jc), _flat(tc)
        assert sorted(jf) == sorted(tf)
        for k in jf:
            if isinstance(jf[k], dict):  # vlm's empty cross_layers
                assert jf[k] == tf[k] == {}, k
                continue
            np.testing.assert_allclose(tf[k].numpy(), jf[k], atol=TOL,
                                       rtol=TOL, err_msg=k)


def test_decode_with_filled_cross_kv_matches_forward(pair):
    """``cross_kv`` filled from the encoder output / vision embeddings,
    then the tokens fed one by one: each step's logits equal the
    forward's at that position."""
    _, tcfg, _, tp = pair
    B, S = 2, 10
    batch = _tb(_batch(tcfg, B, S, 5))
    full = TM.forward(tp, tcfg, batch)
    cache = TM.init_cache(tcfg, B, S, device=CPU)
    fill_cross_kv(torch, tp, tcfg, batch, cache)
    with torch.no_grad():
        for t in range(S):
            logits, cache = TM.decode_step(tp, tcfg, cache, {
                "tokens": batch["tokens"][:, t:t + 1],
                "cache_index": torch.tensor(t)})
            torch.testing.assert_close(logits, full[:, t], atol=TOL,
                                       rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_params_cache_and_state(arch):
    """Parameters (``enc_norm``, the nested vlm stacks), caches (an empty
    ``cross_layers`` dict, ``cross_kv``) and the AdamW state go to the
    port and back bitwise, in the SMOKE configs' bf16."""
    cfg = get_config(arch, smoke=True)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    ocfg = JO.AdamWConfig()
    for tree in (jp, JM.init_cache(cfg, 2, 8), JO.init_opt_state(jp, ocfg)):
        back = bridge.to_numpy(bridge.to_torch(tree, CPU))
        jf = _flat(tree)
        bf = _flat(back)
        assert sorted(jf) == sorted(bf)
        for k, v in jf.items():
            if isinstance(v, dict):
                assert bf[k] == {}, k
                continue
            assert bf[k].dtype == v.dtype, k
            np.testing.assert_array_equal(np.atleast_1d(bf[k]).view(np.uint8),
                                          np.atleast_1d(v).view(np.uint8),
                                          err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_plans_match_reference(arch):
    """The leaf list of ``param_shapes`` and the gradient buckets built
    from the two packages' trees are the reference's, exactly, and so are
    the step's schedule counts (``afe_bucket`` counts its leaves)."""
    cfg, tcfg = _cfgs(arch)
    jp = JM.init_params(cfg, jax.random.PRNGKey(3))
    tp = bridge.to_torch(jp, CPU)
    assert [tuple(t.shape) for t in tree_leaves(TM.param_shapes(tcfg))] == \
        [s.shape for s in jax.tree.leaves(JM.param_shapes(cfg))]
    for n_buckets in (1, 4):
        jflat, _ = JT._bucketize(jp, n_buckets, policy="dlbc")
        tflat, _ = TT._bucketize(tp, n_buckets, policy="dlbc")
        jb, tb = jflat(jax.tree.leaves(jp)), tflat(tree_leaves(tp))
        assert [b.shape[0] for b in tb] == [b.shape[0] for b in jb]
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for policy in ("afe", "afe_bucket"):
        js, _ = JT.build_train_step(
            cfg, ShapeConfig("s", 16, 4, "train", microbatches=2),
            JT.StepConfig(policy=policy), JO.AdamWConfig())
        ts, _ = TT.build_train_step(
            tcfg, TShapeConfig("s", 16, 4, "train", microbatches=2),
            TT.StepConfig(policy=policy), TO.AdamWConfig())
        assert ts.sched_counts == js.sched_counts


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_reference(arch):
    """Policy ``afe``, two microbatches: the frames or patch embeddings
    are split with the tokens, and the cross-attention gradients reach
    the encoder (encdec) through ``ctx``."""
    cfg, tcfg = _cfgs(arch)
    scfg = dict(q_chunk=8, k_chunk=8)
    shape = ShapeConfig("s", 16, 4, "train", microbatches=2)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    js = JO.init_opt_state(jp, ocfg)
    jstep, _ = JT.build_train_step(cfg, shape, JT.StepConfig(**scfg), ocfg)
    jstep = jax.jit(jstep)
    jp, js, _ = jstep(jp, js, _jb(_batch(cfg, 4, 16, 0)))
    batch = _batch(cfg, 4, 16, 1)
    jp2, js2, jm = jstep(jp, js, _jb(batch))
    tp, ts = bridge.to_torch(jp, CPU), bridge.to_torch(js, CPU)
    tstep, _ = TT.build_train_step(
        tcfg, TShapeConfig("s", 16, 4, "train", microbatches=2),
        TT.StepConfig(**scfg), TO.AdamWConfig(lr=1e-3, warmup_steps=2))
    tp2, ts2, tm = tstep(tp, ts, _tb(batch))
    gj, gt = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(gt - gj) <= 1e-5 * gj
    assert int(tm["nonfinite_skipped"]) == int(jm["nonfinite_skipped"]) == 0
    assert int(ts2["step"]) == int(js2["step"]) == 2
    _close_to_max(ts2["m"], js2["m"], 2e-5, "m")
    _close_to_max(ts2["v"], js2["v"], 2e-5, "v")
    for g, r in zip(_np_leaves(tp2), _np_leaves(jp2)):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=0)
    _close_to_max(ts2["master"], js2["master"], 2e-5, "master")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_crash_and_resume(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu``: a crash after step 3, a resume from the step-2 checkpoint, and
    the final loss of an uninterrupted run within 1e-5."""
    common = ["--arch", arch, "--smoke", "--steps", "6", "--ckpt-every", "2",
              "--seq-len", "32", "--device", "cpu"]
    d = tempfile.mkdtemp()
    try:
        with pytest.raises(SimulatedFailure):
            TLaunch.main(common + ["--ckpt-dir", d + "/a", "--failure-at",
                                   "3"])
        resumed = TLaunch.main(common + ["--ckpt-dir", d + "/a"])
        whole = TLaunch.main(common + ["--ckpt-dir", d + "/b"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    capsys.readouterr()
    assert resumed["resumed_from"] == 2 and resumed["completed"] == 6
    assert np.isfinite(whole["last_loss"])
    assert whole["last_loss"] < whole["first_loss"]
    assert resumed["last_loss"] == pytest.approx(whole["last_loss"],
                                                 abs=1e-5)
