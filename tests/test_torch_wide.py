"""phi3-mini-3.8b and mixtral-8x7b on the port, against the JAX reference.

These two models need what the port's kernels first refused: head dim 96
(phi3-mini: d_model 3072 over 32 heads) in ``flash_attention`` and
d_model 4096 (mixtral-8x7b) in ``moe_gmm``.  On the CPU every wrapper
runs its plain version, so this file holds the model path (weights from
the reference's ``init_params`` through the bridge, fp32) and the plain
versions at those shapes against the reference; the CUDA kernels are
held against the plain versions on the card by
``tests/test_torch_cuda.py``.  Tolerances: logits 1e-4, loss 1e-5, KV
caches 1e-5 (as ``tests/test_torch_model.py``); kernels 2e-5 fp32 /
2e-2 bf16 and 5× for the grouped FFN (the reference's own).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention  # noqa: E402
from repro.kernels.moe_dispatch.ref import moe_gmm_ref as j_gmm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_gmm as MG  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}

# phi3-mini SMOKE (head dim 16) and the same model at phi3-mini's head
# dim 96 (d_model 192 over 2 heads)
PHI3 = {"phi3-smoke": {}, "phi3-dh96": {"d_model": 192, "n_heads": 2,
                                        "n_kv_heads": 2}}


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32", **kw),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32", **kw))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape) \
        .astype(np.int32)


def _pair(a, jdtype):
    """One numpy draw as a JAX array and the bitwise-equal torch tensor."""
    j = jnp.asarray(a, jdtype)
    return j, bridge.leaf_to_torch(j, CPU)


@pytest.fixture(scope="module", params=sorted(PHI3))
def phi3(request):
    cfg, tcfg = _cfgs("phi3-mini-3.8b", **PHI3[request.param])
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, bridge.to_torch(jp, CPU)


@pytest.fixture(scope="module")
def mixtral():
    cfg, tcfg = _cfgs("mixtral-8x7b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(2))
    return cfg, tcfg, jp, bridge.to_torch(jp, CPU)


def test_phi3_forward_matches_reference(phi3):
    cfg, tcfg, jp, tp = phi3
    toks = _tokens(cfg, (2, 24), 0)
    jl = JM.forward(jp, cfg, {"tokens": jnp.asarray(toks)}, q_chunk=8,
                    k_chunk=8)
    tl = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_phi3_loss_matches_reference(phi3):
    cfg, tcfg, jp, tp = phi3
    toks, labels = _tokens(cfg, (2, 16), 1), _tokens(cfg, (2, 16), 2)
    jl = JM.loss_fn(jp, cfg, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tl = TM.loss_fn(tp, tcfg, {"tokens": torch.tensor(toks),
                               "labels": torch.tensor(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_phi3_prefill_then_decode_matches_reference(phi3):
    """A batched prefill (row 1 shorter) then two decode steps: logits
    within 1e-4, KV caches within 1e-5."""
    cfg, tcfg, jp, tp = phi3
    toks = _tokens(cfg, (2, 16), 3)
    count = np.array([16, 9], np.int32)
    jc = JM.init_cache(cfg, 2, 32)
    tc = TM.init_cache(tcfg, 2, 32, device=CPU)
    batch = {"tokens": toks, "cache_index": np.zeros(2, np.int32),
             "count": count}
    jlp, jc = JM.prefill_step(jp, cfg, jc, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    tlp, tc = TM.prefill_step(tp, tcfg, tc, {k: torch.tensor(v)
                                             for k, v in batch.items()})
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4,
                               rtol=1e-4)
    for step in range(2):
        dec = {"tokens": _tokens(cfg, (2, 1), 4 + step),
               "cache_index": count + step}
        jld, jc = JM.decode_step(jp, cfg, jc, {k: jnp.asarray(v)
                                               for k, v in dec.items()})
        tld, tc = TM.decode_step(tp, tcfg, tc, {k: torch.tensor(v)
                                                for k, v in dec.items()})
        np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-4,
                                   rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][k].numpy(),
                                   np.asarray(jc["layers"][k]), atol=1e-5,
                                   rtol=1e-5)


def test_mixtral_forward_matches_reference(mixtral):
    """48 tokens against the SMOKE config's 32-token window, so the band
    cuts the early keys of the late queries."""
    cfg, tcfg, jp, tp = mixtral
    assert cfg.sliding_window < 48
    toks = _tokens(cfg, (2, 48), 5)
    jl = JM.forward(jp, cfg, {"tokens": jnp.asarray(toks)}, q_chunk=16,
                    k_chunk=16)
    tl = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jlast = JM.forward(jp, cfg, {"tokens": jnp.asarray(toks)},
                       last_only=True)
    tlast = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)},
                       last_only=True)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)


def test_mixtral_loss_matches_reference(mixtral):
    cfg, tcfg, jp, tp = mixtral
    toks, labels = _tokens(cfg, (2, 40), 6), _tokens(cfg, (2, 40), 7)
    jl = JM.loss_fn(jp, cfg, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tl = TM.loss_fn(tp, tcfg, {"tokens": torch.tensor(toks),
                               "labels": torch.tensor(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_mixtral_windowed_decode_matches_reference(mixtral):
    """40 decode steps at a scalar cache index wrap the 32-entry ring
    buffer; every step's logits and the final caches match the
    reference."""
    cfg, tcfg, jp, tp = mixtral
    toks = _tokens(cfg, (1, 40), 8)
    jc = JM.init_cache(cfg, 1, 64)
    tc = TM.init_cache(tcfg, 1, 64, device=CPU)
    jstep = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    for t in range(40):
        jl, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                "cache_index": jnp.asarray(t, jnp.int32)})
        tl, tc = TM.decode_step(tp, tcfg, tc, {
            "tokens": torch.tensor(toks[:, t:t + 1]),
            "cache_index": torch.tensor(t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][k].numpy(),
                                   np.asarray(jc["layers"][k]), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("H,KV,causal,window", [
    (4, 4, True, 0), (4, 2, False, 0), (10, 2, True, 0), (4, 1, True, 24),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_head_dim_96_matches_reference(H, KV, causal, window,
                                                 dtype):
    """The plain version at phi3-mini's head dim (G = 1, 2, 5, 4), ragged
    S against T."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(9)
    q, tq = _pair(rng.normal(size=(2, 70, H, 96)), jdt)
    k, tk = _pair(rng.normal(size=(2, 70, KV, 96)), jdt)
    v, tv = _pair(rng.normal(size=(2, 70, KV, 96)), jdt)
    n0 = FA.launches
    out = FA.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert FA.launches == n0          # CPU tensors: the plain version
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(j_attention(q, k, v, causal=causal, window=window),
                   np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("E,C,d,f", [(3, 13, 1152, 96), (2, 8, 2048, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_wide_d_matches_reference(E, C, d, f, dtype):
    """The plain version at d past 1024 (mixtral-8x7b's d is 4096)."""
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(10)
    buf, tbuf = _pair(rng.normal(size=(E, C, d)) * 0.5, jdt)
    w1, tw1 = _pair(rng.normal(size=(E, d, f)) * d ** -0.5, jdt)
    w3, tw3 = _pair(rng.normal(size=(E, d, f)) * d ** -0.5, jdt)
    w2, tw2 = _pair(rng.normal(size=(E, f, d)) * f ** -0.5, jdt)
    n0 = MG.launches
    out = MG.moe_gmm(tbuf, tw1, tw3, tw2)
    assert MG.launches == n0
    assert out.dtype == tbuf.dtype and tuple(out.shape) == (E, C, d)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_gmm(buf, w1, w3, w2), np.float32),
                               atol=tol * 5, rtol=tol * 5)


def test_moe_gmm_d_slices():
    """What replaced the d-slices: one launch plan covers every d of the
    MoE configs (granite-moe 1024, mixtral-8x7b 4096) whole.  The gate-up
    kernel takes all of d as its K, unsplit, and the down kernel's tiles
    cover d's columns in one grid, at every capacity the port runs."""
    assert not hasattr(MG, "d_slices") and not hasattr(MG, "MAX_D")
    for arch in ("granite-moe-1b-a400m", "mixtral-8x7b"):
        c = t_get_config(arch)
        E, d, f = c.n_experts, c.d_model, c.d_ff
        for C in (1, 8, 64, 80, 160, 256):
            for dt in (torch.bfloat16, torch.float32):
                gu, dn = MG.launch_plan(E, C, d, f, dt, 132)
                m_tiles = -(-C // gu.block_m)
                assert gu.splits == 1 and gu.grid[1:] == (E, 1)
                assert gu.grid[0] == m_tiles * -(-f // gu.block_n)
                assert dn.grid[0] == m_tiles * -(-d // dn.block_n)
                assert dn.block_n * (dn.grid[0] // m_tiles) >= d


def test_flash_attention_head_dims_cover_the_dense_configs():
    """Every multiple of 16 up to 128, which takes the head dim of each
    full-size attention config the port runs."""
    assert FA.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for arch in ("granite-moe-1b-a400m", "phi3-mini-3.8b", "mixtral-8x7b",
                 "hymba-1.5b", "qwen2.5-32b"):
        assert t_get_config(arch).head_dim in FA.HEAD_DIMS, arch
