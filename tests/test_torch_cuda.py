"""The port's CUDA kernels and model path on the card (no JAX needed).

Every test here is marked ``gpu`` and skips where there is no CUDA card;
on the machine with the card run ``python -m pytest -m gpu
tests/test_torch_cuda.py``.  Each kernel is held against its plain
PyTorch version on the same inputs, at the reference's tolerances
(``tests/test_kernels.py``: 2e-5 fp32 / 2e-2 bf16, 5× for ``moe_gmm``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_gmm as MG  # noqa: E402
from repro_torch.kernels.moe_dispatch.ref import moe_gmm_ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _t(a, dtype, dev):
    return torch.tensor(np.asarray(a, np.float32), device=dev).to(dtype)


@pytest.mark.parametrize("E,C,d,f", [
    (4, 128, 64, 128), (2, 256, 128, 256), (8, 128, 128, 384),
    (32, 8, 1024, 512), (32, 80, 1024, 512), (3, 13, 96, 96),
    (5, 37, 192, 320),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_kernel_matches_plain(cuda, E, C, d, f, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    buf = _t(rng.normal(size=(E, C, d)) * 0.5, dt, cuda)
    w1 = _t(rng.normal(size=(E, d, f)) * d ** -0.5, dt, cuda)
    w3 = _t(rng.normal(size=(E, d, f)) * d ** -0.5, dt, cuda)
    w2 = _t(rng.normal(size=(E, f, d)) * f ** -0.5, dt, cuda)
    n0 = MG.launches
    out = MG.moe_gmm(buf, w1, w3, w2)
    torch.cuda.synchronize()
    assert MG.launches == n0 + 1
    ref = moe_gmm_ref(buf, w1, w3, w2)
    assert out.dtype == dt and out.shape == (E, C, d)
    tol = _tol(dt) * 5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,T,H,KV,dh", [
    (1, 256, 256, 4, 2, 64), (2, 128, 128, 8, 8, 64),
    (1, 512, 512, 4, 1, 128), (2, 256, 256, 6, 2, 128),
    (1, 2048, 2048, 16, 8, 64), (2, 77, 77, 4, 2, 16), (1, 100, 130, 4, 2, 32),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, H, KV, dh,
                                              causal, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    q = _t(rng.normal(size=(B, S, H, dh)), dt, cuda)
    k = _t(rng.normal(size=(B, T, KV, dh)), dt, cuda)
    v = _t(rng.normal(size=(B, T, KV, dh)), dt, cuda)
    n0 = FA.launches
    out = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.launches == n0 + 1
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                               rtol=_tol(dt))


@pytest.mark.parametrize("window", [64, 128, 256])
def test_flash_attention_kernel_window(cuda, window):
    rng = np.random.default_rng(2)
    B, S, H, KV, dh = 1, 1024, 16, 8, 64
    q = _t(rng.normal(size=(B, S, H, dh)), torch.float32, cuda)
    k = _t(rng.normal(size=(B, S, KV, dh)), torch.float32, cuda)
    v = _t(rng.normal(size=(B, S, KV, dh)), torch.float32, cuda)
    out = FA.flash_attention(q, k, v, causal=True, window=window)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 8, 64), device=cuda)
    w = torch.zeros((2, 64, 32), device=cuda)
    w2 = torch.zeros((2, 32, 64), device=cuda)
    with pytest.raises(TypeError):
        MG.moe_gmm(x.half(), w.half(), w.half(), w2.half())
    with pytest.raises(ValueError):
        MG.moe_gmm(x, w.cpu(), w, w2)
    with pytest.raises(ValueError):
        MG.moe_gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w, w, w2)
    q = torch.zeros((1, 16, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2.5-32b"])
def test_forward_and_serving_steps_match_cpu(cuda, arch):
    """Same weights on the card and on the CPU: forward logits, and a
    prefill + decode, agree in fp32 (the card runs the kernels, the CPU
    their plain versions)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    p_cpu = TM.init_params(cfg, gen, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 24))
    n0 = FA.launches
    lg = TM.forward(p_gpu, cfg, {"tokens": torch.tensor(toks, device=cuda)})
    assert FA.launches == n0 + cfg.n_layers
    lc = TM.forward(p_cpu, cfg, {"tokens": torch.tensor(toks)})
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    outs = []
    for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
        cache = TM.init_cache(cfg, 2, 32, device=dev)
        batch = {"tokens": torch.tensor(toks[:, :16], device=dev),
                 "cache_index": torch.zeros(2, dtype=torch.long, device=dev),
                 "count": torch.tensor([16, 9], device=dev)}
        TM.prefill_step(p, cfg, cache, batch)
        logits, _ = TM.decode_step(
            p, cfg, cache, {"tokens": torch.tensor(toks[:, 16:17], device=dev),
                            "cache_index": torch.tensor([16, 9], device=dev)})
        outs.append((logits.cpu(), cache["layers"]["k"].cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-5, rtol=1e-5)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_chunked_prefill_bitwise_on_card(cuda):
    """Chunked == whole prefill, max |Δ| == 0.0, on the card with
    deterministic algorithms (dense qwen2.5 SMOKE)."""
    from repro_torch.device import parity_mode

    cfg = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                              dtype="float32")
    parity_mode(deterministic=True)
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = TM.init_params(cfg, gen, device=cuda)
        prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=11)
        caches = []
        for sizes in ([11], [1] * 11, [8, 3]):
            cache = TM.init_cache(cfg, 2, 32, device=cuda)
            pos = 0
            for s in sizes:
                toks = np.zeros((2, 16), np.int64)
                toks[0, :s] = prompt[pos:pos + s]
                TM.prefill_step(params, cfg, cache, {
                    "tokens": torch.tensor(toks, device=cuda),
                    "cache_index": torch.tensor([pos, 0], device=cuda),
                    "count": torch.tensor([s, 0], device=cuda)})
                pos += s
            caches.append(cache["layers"]["k"].clone())
        for c in caches[1:]:
            assert float((c - caches[0]).abs().max()) == 0.0
    finally:
        parity_mode(deterministic=False)
