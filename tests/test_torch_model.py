"""The port's model (forward, loss, prefill, decode) against the JAX
reference, and port-internal mirrors of the reference's prefill tests.

Weights come from the reference's ``init_params`` through the bridge, in
fp32 (``dataclasses.replace(cfg, dtype="float32")``), on the granite-moe
and qwen2.5 SMOKE configs.  Logits within 1e-4, loss within 1e-5, KV
caches within 1e-5; chunked == whole prefill exactly (max |Δ| == 0.0).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "qwen2.5-32b"]
CPU = torch.device("cpu")


def _cfgs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, bridge.to_torch(jp, CPU)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape) \
        .astype(np.int32)


def test_forward_matches_reference(pair):
    cfg, tcfg, jp, tp = pair
    toks = _tokens(cfg, (2, 24))
    jl = JM.forward(jp, cfg, {"tokens": jnp.asarray(toks)}, q_chunk=8,
                    k_chunk=8)
    tl = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jlast = JM.forward(jp, cfg, {"tokens": jnp.asarray(toks)},
                       last_only=True)
    tlast = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)},
                       last_only=True)
    assert tuple(tlast.shape) == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)


def test_loss_matches_reference(pair):
    cfg, tcfg, jp, tp = pair
    toks, labels = _tokens(cfg, (2, 16), 1), _tokens(cfg, (2, 16), 2)
    jl = JM.loss_fn(jp, cfg, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tl = TM.loss_fn(tp, tcfg, {"tokens": torch.tensor(toks),
                               "labels": torch.tensor(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_prefill_then_decode_matches_reference(pair):
    """A batched prefill (row 1 shorter, so its tail lanes are padding)
    then one decode step: logits within 1e-4, caches within 1e-5."""
    cfg, tcfg, jp, tp = pair
    toks = _tokens(cfg, (2, 16), 3)
    nxt = _tokens(cfg, (2, 1), 4)
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
    dec = {"tokens": nxt, "cache_index": count}
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


def test_decode_scalar_index_matches_reference(pair):
    cfg, tcfg, jp, tp = pair
    toks = _tokens(cfg, (2, 4), 5)
    jc = JM.init_cache(cfg, 2, 8)
    tc = TM.init_cache(tcfg, 2, 8, device=CPU)
    for t in range(4):
        jl, jc = JM.decode_step(jp, cfg, jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_index": jnp.asarray(t, jnp.int32)})
        tl, tc = TM.decode_step(tp, tcfg, tc, {
            "tokens": torch.tensor(toks[:, t:t + 1]),
            "cache_index": torch.tensor(t)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)


def test_windowed_ring_buffer_decode_matches_reference():
    """mixtral SMOKE (sliding window 32): the decode cache is a 32-entry
    ring buffer; 40 per-row steps wrap it, and logits stay within 1e-4
    of the reference."""
    cfg, tcfg = _cfgs("mixtral-8x7b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    tp = bridge.to_torch(jp, CPU)
    toks = _tokens(cfg, (2, 40), 6)
    jc = JM.init_cache(cfg, 2, 64)
    tc = TM.init_cache(tcfg, 2, 64, device=CPU)
    assert tc["layers"]["k"].shape[2] == cfg.sliding_window
    jstep = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    for t in range(40):
        idx = np.array([t, max(0, t - 3)], np.int32)
        jl, jc = jstep(jp, jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "cache_index": jnp.asarray(idx)})
        tl, tc = TM.decode_step(tp, tcfg, tc, {
            "tokens": torch.tensor(toks[:, t:t + 1]),
            "cache_index": torch.tensor(idx)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


# -- port-internal mirrors of tests/test_prefill.py and test_models.py --------


def _dense_cfg(**kw):
    return TModelConfig(name="prefill-test", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab=128, dtype="float32", **kw)


@pytest.fixture(scope="module")
def dense():
    cfg = _dense_cfg()
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0),
                               device=CPU)


def _prefill_in_chunks(cfg, params, prompt, sizes, *, buf=16, bsz=2,
                       cache_len=32):
    """Row 0 live, row 1 inert, all through one static launch buffer."""
    cache = TM.init_cache(cfg, bsz, cache_len, device=CPU)
    pos = 0
    for s in sizes:
        toks = np.zeros((bsz, buf), np.int64)
        toks[0, :s] = prompt[pos:pos + s]
        TM.prefill_step(params, cfg, cache, {
            "tokens": torch.tensor(toks),
            "cache_index": torch.tensor([pos] + [0] * (bsz - 1)),
            "count": torch.tensor([s] + [0] * (bsz - 1))})
        pos += s
    return cache


def _decode_logits(cfg, params, cache, token, pos, bsz=2):
    """Decode on a clone, so the caller's cache stays as it was."""
    cache = {"layers": {k: v.clone() for k, v in cache["layers"].items()}}
    toks = np.zeros((bsz, 1), np.int64)
    toks[0, 0] = token
    logits, _ = TM.decode_step(params, cfg, cache, {
        "tokens": torch.tensor(toks),
        "cache_index": torch.tensor([pos] + [0] * (bsz - 1))})
    return logits


def test_chunked_prefill_is_bitwise_equal_to_whole(dense):
    cfg, params = dense
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=12).tolist()
    pre = len(prompt) - 1
    whole = _prefill_in_chunks(cfg, params, prompt[:-1], [pre])
    by_one = _prefill_in_chunks(cfg, params, prompt[:-1], [1] * pre)
    by_eight = _prefill_in_chunks(cfg, params, prompt[:-1], [8, pre - 8])
    ref = _decode_logits(cfg, params, whole, prompt[-1], pre)
    for cache in (by_one, by_eight):
        for k in ("k", "v"):
            assert torch.equal(whole["layers"][k], cache["layers"][k])
        logits = _decode_logits(cfg, params, cache, prompt[-1], pre)
        assert float((ref - logits).abs().max()) == 0.0


def test_prefill_first_token_matches_forward(dense):
    cfg, params = dense
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=9).tolist()
    pre = len(prompt) - 1
    cache = _prefill_in_chunks(cfg, params, prompt[:-1], [pre])
    logits = _decode_logits(cfg, params, cache, prompt[-1], pre)
    fwd = TM.forward(params, cfg, {"tokens": torch.tensor([prompt])},
                     last_only=True)
    assert int(fwd[0, 0, :cfg.vocab].argmax()) \
        == int(logits[0, :cfg.vocab].argmax())


def test_inert_rows_untouched_bitwise(dense):
    cfg, params = dense
    cache = TM.init_cache(cfg, 2, 32, device=CPU)
    k0 = torch.randn(cache["layers"]["k"].shape,
                     generator=torch.Generator().manual_seed(1))
    cache["layers"]["k"].copy_(k0)
    toks = np.zeros((2, 16), np.int64)
    toks[0, :5] = [1, 2, 3, 4, 5]
    _, new_cache = TM.prefill_step(params, cfg, cache, {
        "tokens": torch.tensor(toks), "cache_index": torch.tensor([0, 0]),
        "count": torch.tensor([5, 0])})
    assert torch.equal(new_cache["layers"]["k"][:, 1], k0[:, 1])
    assert torch.equal(new_cache["layers"]["k"][:, 0, 5:], k0[:, 0, 5:])
    assert not torch.equal(new_cache["layers"]["k"][:, 0, :5], k0[:, 0, :5])


def test_span_write_past_cache_end_is_dropped():
    """Lanes that would land at index >= T are dropped, like the
    reference's out-of-bounds scatter, and the single-token write
    clamps to T-1."""
    from repro_torch.models import layers as L

    cache = torch.zeros(1, 4, 1, 2)
    new = torch.arange(1, 4, dtype=torch.float32).reshape(1, 3, 1, 1) \
        .expand(1, 3, 1, 2).contiguous()
    L.kv_cache_update_span(cache, new, torch.tensor([2]), torch.tensor([3]))
    assert cache[0, :, 0, 0].tolist() == [0.0, 0.0, 1.0, 2.0]
    L.kv_cache_update(cache, torch.full((1, 1, 1, 2), 9.0), torch.tensor(7))
    assert cache[0, :, 0, 0].tolist() == [0.0, 0.0, 1.0, 9.0]


def test_decode_matches_forward_dense():
    """Token-by-token decode reproduces the forward logits (the mirror
    of the reference's test, here in fp32 on the CPU)."""
    cfg = dataclasses.replace(t_get_config("phi3-mini-3.8b", smoke=True),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    T = 8
    tokens = torch.randint(0, cfg.vocab, (1, T),
                           generator=torch.Generator().manual_seed(1))
    full = TM.forward(params, cfg, {"tokens": tokens})
    cache = TM.init_cache(cfg, 1, 16, device=CPU)
    outs = []
    for t in range(T):
        logits, cache = TM.decode_step(params, cfg, cache, {
            "tokens": tokens[:, t:t + 1], "cache_index": torch.tensor(t)})
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_prefill_rejected_for_unsupported_cache_families():
    windowed = _dense_cfg(sliding_window=8)
    params = TM.init_params(windowed, torch.Generator().manual_seed(0),
                            device=CPU)
    with pytest.raises(NotImplementedError, match="ring-buffer"):
        TM.prefill_step(params, windowed,
                        TM.init_cache(windowed, 1, 16, device=CPU),
                        {"tokens": torch.zeros((1, 4), dtype=torch.long),
                         "cache_index": torch.zeros(1, dtype=torch.long),
                         "count": torch.ones(1, dtype=torch.long)})


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "whisper-medium", "llama-3.2-vision-90b"])
def test_unported_families_raise_and_name_their_roadmap_item(arch):
    cfg = t_get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """The torch-native init builds the reference's tree: same keys,
    shapes and dtypes (bf16 experts, fp32 router), and the reference's
    scales (embed std 0.02, weights std fan_in^-0.5)."""
    cfg = get_config(arch, smoke=True)
    tcfg = t_get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(prefix + f"['{k}']", v)
            else:
                tflat[prefix + f"['{k}']"] = v
    walk("", tp)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == v.dtype.name, k
    assert abs(float(tp["embed"].float().std()) - 0.02) < 2e-3
    wq = tp["layers"]["attn"]["wq"]["w"].float()
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.1 * \
        tcfg.d_model ** -0.5
