"""The port's CUDA kernels and model path on the card (no JAX needed).

Every test here is marked ``gpu`` and skips where there is no CUDA card;
on the machine with the card run ``python -m pytest -m gpu
tests/test_torch_cuda.py``.  Each kernel is held against its plain
PyTorch version on the same inputs, at the reference's tolerances
(``tests/test_kernels.py``: 2e-5 fp32 / 2e-2 bf16, 5× for ``moe_gmm``,
1e-4 for ``ssm_scan``); backward kernels against autograd through the
plain versions, each gradient within its tolerance × its largest value
(``ssm_scan``'s 1e-5).
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
from repro_torch.kernels.ssm_scan import ssm_scan as SS  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    ssm_scan_bwd_ref, ssm_scan_ref,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

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
    # d past 1024: mixtral-8x7b's d at a short f, and a ragged 1152
    (8, 40, 4096, 1024), (3, 13, 1152, 96),
    # mixtral-8x7b's expert widths at E = 2: one token, a decode step
    # (the down kernel's K split four ways) and the bf16 forward's C = 160
    (2, 1, 4096, 14336), (2, 8, 4096, 14336), (2, 160, 4096, 14336),
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
    # phi3-mini's head dim 96 at G = 1, 2, 5, and the other multiples of 16
    (1, 300, 300, 4, 4, 96), (2, 130, 130, 4, 2, 96), (1, 200, 200, 10, 2, 96),
    (1, 100, 100, 4, 2, 48), (1, 129, 129, 2, 2, 80), (1, 64, 90, 2, 1, 112),
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


@pytest.mark.parametrize("S,window", [(256, 1024), (1500, 1024), (777, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_hymba_group_of_five(cuda, S, window, dtype):
    """hymba-1.5b's heads: G = 25 / 5 leaves 4 of a tile's 64 rows idle."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(1, S, 25, 64)), dt, cuda)
    k = _t(rng.normal(size=(1, S, 5, 64)), dt, cuda)
    v = _t(rng.normal(size=(1, S, 5, 64)), dt, cuda)
    out = FA.flash_attention(q, k, v, causal=True, window=window)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                               rtol=_tol(dt))


@pytest.mark.parametrize("H,KV", [(8, 8), (8, 4), (10, 2)])
@pytest.mark.parametrize("window", [64, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_dim_96_window(cuda, H, KV, window,
                                                   dtype):
    """phi3-mini's head dim under a sliding window (G = 1, 2, 5), ragged
    S: the band's lower edge and the diagonal in one tile."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(1, 700, H, 96)), dt, cuda)
    k = _t(rng.normal(size=(1, 700, KV, 96)), dt, cuda)
    v = _t(rng.normal(size=(1, 700, KV, 96)), dt, cuda)
    out = FA.flash_attention(q, k, v, causal=True, window=window)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dt),
                               rtol=_tol(dt))


def test_moe_gmm_granite_launches_unchanged(cuda):
    """granite-moe-1b's launches (d = 1024) at the decode step (C = 8:
    32-row tiles, K unsplit) and the prefill round (C = 80: one 128-row
    tile in bf16, two of 64 rows in fp32), within the plain version's
    tolerance and bitwise the same on every call."""
    cfg = get_config("granite-moe-1b-a400m")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        assert MG.launch_plan(E, 8, d, f, dt, n_sms).down[:5] == (
            32, 128, MG.BLOCK_K[dt], MG.STAGES[32], 1)
        m_tiles = 1 if dt == torch.bfloat16 else 2
        assert MG.launch_plan(E, 80, d, f, dt, n_sms).gate_up.grid == (
            m_tiles * f // 64, E, 1)
        w1 = (torch.randn(E, d, f, generator=gen, device=cuda) * d ** -0.5).to(dt)
        w3 = (torch.randn(E, d, f, generator=gen, device=cuda) * d ** -0.5).to(dt)
        w2 = (torch.randn(E, f, d, generator=gen, device=cuda) * f ** -0.5).to(dt)
        for C in (8, 80):
            buf = torch.randn(E, C, d, generator=gen, device=cuda).to(dt)
            a = MG.moe_gmm(buf, w1, w3, w2)
            b = MG.moe_gmm(buf, w1, w3, w2)
            assert torch.equal(a, b)
            tol = _tol(dt) * 5
            torch.testing.assert_close(a.float(), moe_gmm_ref(
                buf, w1, w3, w2).float(), atol=tol, rtol=tol)


def test_moe_gmm_split_k_is_bitwise_repeatable(cuda):
    """A down kernel with K split (mixtral's widths at E = 2, C = 8) sums
    its splits in a fixed order: the same bits on every call."""
    E, C, d, f = 2, 8, 4096, 14336
    gen = torch.Generator(device=cuda).manual_seed(3)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        assert MG.launch_plan(E, C, d, f, dt, n_sms).down.splits > 1
        w1 = (torch.randn(E, d, f, generator=gen, device=cuda) * d ** -0.5).to(dt)
        w3 = (torch.randn(E, d, f, generator=gen, device=cuda) * d ** -0.5).to(dt)
        w2 = (torch.randn(E, f, d, generator=gen, device=cuda) * f ** -0.5).to(dt)
        buf = torch.randn(E, C, d, generator=gen, device=cuda).to(dt)
        outs = [MG.moe_gmm(buf, w1, w3, w2) for _ in range(3)]
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """No kernel refuses grad mode any more: ``flash_attention``,
    ``moe_gmm`` and ``ssm_scan`` each launch their backward kernels once
    per backward and return finite, non-zero gradients for every input
    that requires grad, and launch no backward under no_grad."""
    x = torch.randn((2, 8, 64), device=cuda)
    w = torch.randn((2, 64, 32), device=cuda)
    w2 = torch.randn((2, 32, 64), device=cuda)
    q = torch.randn((1, 16, 4, 64), device=cuda)
    kv = torch.randn((1, 16, 2, 64), device=cuda)
    dA = torch.rand((1, 8, 16, 4), device=cuda) * 0.5 + 0.5
    dBx = torch.randn((1, 8, 16, 4), device=cuda)
    C = torch.randn((1, 8, 4), device=cuda)
    h0 = torch.randn((1, 16, 4), device=cuda)
    calls = {
        "moe_gmm": (MG, MG.moe_gmm, (x, w, w.clone(), w2)),
        "flash_attention": (FA, FA.flash_attention, (q, kv, kv.clone())),
        "ssm_scan": (SS, lambda *a: torch.cat(
            [t.flatten() for t in SS.ssm_scan(*a)]), (dA, dBx, C, h0)),
    }
    for name, (mod, fn, args) in calls.items():
        for i in range(len(args)):
            grad_args = [a.clone().requires_grad_(j == i)
                         for j, a in enumerate(args)]
            n0 = mod.bwd_launches
            fn(*grad_args).square().sum().backward()
            assert mod.bwd_launches == n0 + 1, name
            g = grad_args[i].grad
            assert g is not None and bool(torch.isfinite(g).all()), name
            assert float(g.abs().sum()) > 0, name
            with torch.no_grad():
                fn(*grad_args)
            assert mod.bwd_launches == n0 + 1, name
        fn(*args)
    torch.cuda.synchronize()


def _grads(fn, args, dout):
    """Autograd gradients of ``(fn(*args) * dout).sum()`` w.r.t. args."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    fn(*leaves).backward(dout)
    return [a.grad for a in leaves]


def _assert_grads_close(got, ref, tol, what):
    """Each gradient within ``tol × max |reference gradient|``."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, (what, i)
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * scale, f"{what} grad {i}: {err} > {tol}×{scale}"


@pytest.mark.parametrize("B,S,T,H,KV,dh,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0), (1, 77, 77, 4, 2, 16, True, 0),
    (1, 100, 130, 4, 2, 32, False, 0), (1, 200, 200, 8, 8, 96, True, 0),
    (1, 300, 300, 10, 2, 96, True, 64), (1, 256, 256, 25, 5, 64, True, 100),
    (2, 150, 150, 4, 1, 128, False, 40), (1, 129, 129, 2, 2, 80, True, 0),
    (1, 64, 64, 64, 1, 48, True, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(cuda, B, S, T, H, KV, dh,
                                                  causal, window, dtype):
    """dq, dk, dv from the backward kernels against autograd through the
    plain version (fp32), each within 2e-5 (fp32) / 2e-2 (bf16) of the
    largest reference gradient; bitwise the same on a second call."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    q, k, v = (_t(rng.normal(size=s), dt, cuda) for s in (
        (B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
    dout = _t(rng.normal(size=(B, S, H, dh)), dt, cuda)
    kw = dict(causal=causal, window=window)
    n0 = FA.bwd_launches
    got = _grads(lambda *a: FA.flash_attention(*a, **kw), (q, k, v), dout)
    again = _grads(lambda *a: FA.flash_attention(*a, **kw), (q, k, v), dout)
    torch.cuda.synchronize()
    assert FA.bwd_launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _grads(lambda *a: attention_ref(*a, **kw).float(),
                 [x.float() for x in (q, k, v)], dout.float())
    _assert_grads_close(got, [r.to(dt) for r in ref], _tol(dt),
                        f"flash_attention {dtype}")


@pytest.mark.parametrize("E,C,d,f", [
    (4, 128, 64, 128), (3, 13, 96, 96), (5, 37, 192, 320), (2, 1, 64, 64),
    (3, 70, 72, 40), (2, 33, 136, 104),
    (32, 8, 1024, 512), (32, 80, 1024, 512), (32, 1280, 1024, 512),
    # C off the 128-row tiles, d and f off the 64-element TMA box
    (2, 200, 200, 136), (3, 130, 1032, 520),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_bwd_kernel_matches_plain(cuda, E, C, d, f, dtype):
    """dbuf, dw1, dw3, dw2 from the backward kernels against autograd
    through the plain version (fp32), within 5 × 2e-5 (fp32) / 2e-2
    (bf16, ``flash_attention``'s limit) of the largest reference gradient
    of each; bitwise the same on a second call.  The ragged shapes cut C,
    d and f inside a tile (f 40 and 104 are not multiples of 32; C 200 and
    130 not of bf16's 128 rows; d 200 and 1032, f 136 and 520 not of the
    64-element TMA box, which zero-fills past them)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    args = (_t(rng.normal(size=(E, C, d)) * 0.5, dt, cuda),
            _t(rng.normal(size=(E, d, f)) * d ** -0.5, dt, cuda),
            _t(rng.normal(size=(E, d, f)) * d ** -0.5, dt, cuda),
            _t(rng.normal(size=(E, f, d)) * f ** -0.5, dt, cuda))
    dout = _t(rng.normal(size=(E, C, d)), dt, cuda)
    n0 = MG.bwd_launches
    got = _grads(MG.moe_gmm, args, dout)
    again = _grads(MG.moe_gmm, args, dout)
    torch.cuda.synchronize()
    assert MG.bwd_launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _grads(lambda *a: moe_gmm_ref(*a).float(),
                 [x.float() for x in args], dout.float())
    tol = 2e-2 if dt == torch.bfloat16 else _tol(dt) * 5
    _assert_grads_close(got, [r.to(dt) for r in ref], tol, f"moe_gmm {dtype}")


def test_train_grads_match_cpu_at_full_width(cuda):
    """granite-moe-1b-a400m at full width, 2 layers, fp32: one
    ``loss_fn`` backward on the card (both kernels and their backward
    kernels, one launch of each per layer) against the same weights'
    gradients on the CPU (plain versions), every parameter within 1e-4 of
    its largest CPU gradient — after checking that both runs routed every
    token to the same experts with the same keep masks."""
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              dtype="float32", n_layers=2)
    p_cpu = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = np.random.default_rng(13).integers(0, cfg.vocab, size=(2, 257))
    routes = {}
    real = M.dispatch_combine

    def spy(x, gates, ids, pos, keep, *a, **k):
        routes.setdefault(str(x.device.type), []).append(
            (ids.cpu(), keep.cpu()))
        return real(x, gates, ids, pos, keep, *a, **k)

    grads = {}
    M.dispatch_combine = spy
    try:
        for dev in ("cpu", cuda):
            p = tree_map(lambda t: t.detach().to(dev).clone()
                         .requires_grad_(True), p_cpu)
            leaves = tree_leaves(p)
            batch = {"tokens": torch.tensor(toks[:, :-1], device=dev),
                     "labels": torch.tensor(toks[:, 1:], device=dev)}
            nf, nm = FA.bwd_launches, MG.bwd_launches
            TM.loss_fn(p, cfg, batch).backward()
            if dev != "cpu":
                torch.cuda.synchronize()
                assert FA.bwd_launches == nf + cfg.n_layers
                assert MG.bwd_launches == nm + cfg.n_layers
            grads[str(torch.device(dev).type)] = [t.grad.cpu() for t in leaves]
    finally:
        M.dispatch_combine = real
    for (ic, kc), (ig, kg) in zip(routes["cpu"], routes["cuda"]):
        assert torch.equal(ic, ig) and torch.equal(kc, kg), \
            "a route flipped between the card and the CPU (near-tie)"
    for gc, gg in zip(grads["cpu"], grads["cuda"]):
        assert bool(torch.isfinite(gg).all())
        assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


def test_flash_attention_refuses_unaligned_bf16(cuda):
    q = torch.zeros((1, 16 * 4 * 64 + 1), device=cuda,
                    dtype=torch.bfloat16)[:, 1:].reshape(1, 16, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    kv = torch.zeros((1, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention(q, kv, kv)


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
    q = torch.zeros((1, 16, 4, 100), device=cuda)
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


@pytest.mark.parametrize("arch,kw", [
    ("phi3-mini-3.8b", {"d_model": 192, "n_heads": 2, "n_kv_heads": 2}),
    ("mixtral-8x7b", {"d_model": 1152, "n_heads": 12, "n_kv_heads": 4}),
])
def test_wide_models_forward_matches_cpu(cuda, arch, kw):
    """phi3-mini at head dim 96 and mixtral at head dim 96 with d = 1152
    (``moe_gmm`` past d = 1024), 48 tokens across mixtral's 32-token
    window: the card's forward (both kernels) agrees with the CPU's
    plain path in fp32."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              **kw)
    p_cpu = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 48))
    n_fa, n_mg = FA.launches, MG.launches
    lg = TM.forward(p_gpu, cfg, {"tokens": torch.tensor(toks, device=cuda)})
    assert FA.launches == n_fa + cfg.n_layers
    assert MG.launches == n_mg + (cfg.n_layers if cfg.n_experts else 0)
    lc = TM.forward(p_cpu, cfg, {"tokens": torch.tensor(toks)})
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)


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


# (B, L, Di, N): the reference's sweep shapes, ragged L and Di, and the
# main path's launches (falcon-mamba-7b per chunk, hymba-1.5b's Di = 3200)
SSM_SHAPES = [
    (2, 256, 64, 8), (1, 128, 128, 16), (3, 512, 32, 4), (1, 100, 40, 4),
    (2, 77, 200, 16), (1, 256, 8192, 16), (2, 256, 3200, 16),
]


@pytest.mark.parametrize("B,L,Di,N", SSM_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_kernel_matches_plain(cuda, B, L, Di, N, with_h0):
    gen = torch.Generator(device=cuda).manual_seed(0)
    dA = torch.rand(B, L, Di, N, generator=gen, device=cuda) * 0.499 + 0.5
    dBx = torch.randn(B, L, Di, N, generator=gen, device=cuda) * 0.1
    C = torch.randn(B, L, N, generator=gen, device=cuda)
    h0 = torch.randn(B, Di, N, generator=gen, device=cuda) \
        if with_h0 else None
    n0 = SS.launches
    y, h = SS.ssm_scan(dA, dBx, C, h0)
    torch.cuda.synchronize()
    assert SS.launches == n0 + 1
    y_ref, h_ref = ssm_scan_ref(dA, dBx, C, h0)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


def test_ssm_scan_kernel_chains_like_one_call(cuda):
    """Four launches carrying ``h`` equal one whole-length launch."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    dA = torch.rand(1, 1024, 512, 16, generator=gen, device=cuda) * 0.5 + 0.5
    dBx = torch.randn(1, 1024, 512, 16, generator=gen, device=cuda) * 0.1
    C = torch.randn(1, 1024, 16, generator=gen, device=cuda)
    y_whole, h_whole = SS.ssm_scan(dA, dBx, C)
    h, ys = None, []
    for t0 in range(0, 1024, 256):
        y, h = SS.ssm_scan(dA[:, t0:t0 + 256].contiguous(),
                           dBx[:, t0:t0 + 256].contiguous(),
                           C[:, t0:t0 + 256].contiguous(), h)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=1), y_whole)
    assert torch.equal(h, h_whole)


# (B, L, Di, N, with h0, with dh_last): ragged and small shapes, then the
# main path's chunks (hymba-1.5b's Di = 3200 and falcon-mamba-7b's 8192)
SSM_BWD_CASES = [
    (2, 77, 200, 16, True, True), (1, 100, 40, 4, False, True),
    (3, 64, 33, 8, True, False), (1, 256, 3200, 16, False, False),
    (1, 256, 3200, 16, True, True), (1, 256, 8192, 16, True, True),
    # L past one 256-step segment (checkpointed segments, the last one
    # ragged); Di off the channels per block (8 for N 4, 2 for N 16)
    (1, 600, 72, 16, True, True), (2, 300, 37, 4, True, False),
    (1, 256, 3201, 16, False, True),
]


@pytest.mark.parametrize("B,L,Di,N,with_h0,with_dh", SSM_BWD_CASES)
def test_ssm_scan_bwd_kernel_matches_plain(cuda, B, L, Di, N, with_h0,
                                           with_dh):
    """d_dA, d_dBx, dC and dh0 from the backward kernel against the plain
    backward ``ssm_scan_bwd_ref`` and against autograd through the plain
    scan, each within 1e-5 × its largest reference value; bitwise the same
    on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    dA = torch.rand(B, L, Di, N, generator=gen, device=cuda) * 0.499 + 0.5
    dBx = torch.randn(B, L, Di, N, generator=gen, device=cuda) * 0.1
    C = torch.randn(B, L, N, generator=gen, device=cuda)
    h0 = torch.randn(B, Di, N, generator=gen, device=cuda) \
        if with_h0 else None
    dy = torch.randn(B, L, Di, generator=gen, device=cuda)
    dh = torch.randn(B, Di, N, generator=gen, device=cuda) \
        if with_dh else None
    n0 = SS.bwd_launches
    got = SS.ssm_scan_bwd(dA, dBx, C, h0, dy, dh)
    again = SS.ssm_scan_bwd(dA, dBx, C, h0, dy, dh)
    torch.cuda.synchronize()
    assert SS.bwd_launches == n0 + 2
    assert (got[3] is None) == (h0 is None)
    got, again = [g for g in got if g is not None], \
        [g for g in again if g is not None]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = ssm_scan_bwd_ref(dA, dBx, C, h0, dy, dh)
    _assert_grads_close(got, ref[:len(got)], 1e-5, "ssm_scan_bwd plain")
    leaves = [t.clone().requires_grad_(True) for t in (dA, dBx, C, h0)
              if t is not None]
    y, h = ssm_scan_ref(*leaves)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    _assert_grads_close(got, torch.autograd.grad(loss, leaves), 1e-5,
                        "ssm_scan_bwd autograd")


def test_ssm_scan_bwd_chained_chunks_match_one_call(cuda):
    """``SsmScanFn`` over four 256-step chunks carrying the state, as the
    model chains them: the gradients equal one whole-length backward launch
    within 1e-5 × their largest value, with one backward launch per
    chunk."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    dA = torch.rand(1, 1024, 512, 16, generator=gen, device=cuda) * 0.5 + 0.5
    dBx = torch.randn(1, 1024, 512, 16, generator=gen, device=cuda) * 0.1
    C = torch.randn(1, 1024, 16, generator=gen, device=cuda)
    dy = torch.randn(1, 1024, 512, generator=gen, device=cuda)
    whole = SS.ssm_scan_bwd(dA, dBx, C, None, dy)[:3]
    leaves = [t.clone().requires_grad_(True) for t in (dA, dBx, C)]
    n0 = SS.bwd_launches
    h, ys = None, []
    for t0 in range(0, 1024, 256):
        y, h = SS.ssm_scan(*(t[:, t0:t0 + 256] for t in leaves), h)
        ys.append(y)
    got = torch.autograd.grad((torch.cat(ys, dim=1) * dy).sum(), leaves)
    torch.cuda.synchronize()
    assert SS.bwd_launches == n0 + 4
    _assert_grads_close(list(got), list(whole), 1e-5, "chained ssm_scan_bwd")


def test_ssm_scan_refuses_what_it_does_not_take(cuda):
    dA = torch.zeros((1, 8, 16, 4), device=cuda)
    C = torch.zeros((1, 8, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        SS.ssm_scan(dA.bfloat16(), dA.bfloat16(), C.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        SS.ssm_scan(dA.transpose(2, 3).contiguous().transpose(2, 3), dA, C)
    with pytest.raises(ValueError, match="CUDA"):
        SS.ssm_scan(dA, dA, C, torch.zeros((1, 16, 4)))
    with pytest.raises(ValueError, match="state size"):
        wide = torch.zeros((1, 8, 16, 32), device=cuda)
        SS.ssm_scan(wide, wide, torch.zeros((1, 8, 32), device=cuda))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_families_forward_matches_decode_and_cpu(cuda, arch):
    """Smoke-size falcon-mamba / hymba on the card: the forward (one
    ``ssm_scan`` launch per layer and chunk, plus ``flash_attention`` per
    hybrid layer) agrees with the CPU's plain path, and token-by-token
    decode reproduces its argmax."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    p_cpu = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 48))
    n_ssm, n_fa = SS.launches, FA.launches
    lg = TM.forward(p_gpu, cfg, {"tokens": torch.tensor(toks, device=cuda)},
                    ssm_chunk=16)
    assert SS.launches == n_ssm + 3 * cfg.n_layers
    assert FA.launches == n_fa + (cfg.n_layers if arch == "hymba-1.5b"
                                  else 0)
    lc = TM.forward(p_cpu, cfg, {"tokens": torch.tensor(toks)}, ssm_chunk=16)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    cache = TM.init_cache(cfg, 2, 64, device=cuda)
    outs = []
    for t in range(toks.shape[1]):
        logits, _ = TM.decode_step(p_gpu, cfg, cache, {
            "tokens": torch.tensor(toks[:, t:t + 1], device=cuda),
            "cache_index": torch.tensor(t, device=cuda)})
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    torch.testing.assert_close(dec, lg, atol=1e-4, rtol=1e-4)
    assert torch.equal(dec.argmax(-1), lg.argmax(-1))


# -- the encoder-decoder and vision-language families -------------------------

# whisper-medium's encoder (S = T = 1500, non-causal) and cross attention
# (448 decoder positions against 1500 frames, a 28-key tail tile),
# llama-3.2-vision's cross attention (512 against 1601 patches, G 8 at dh
# 128, a 1-key tail tile) and a small 1-key tail at G 2
ENCDEC_ATTN = [
    (1, 1500, 1500, 16, 16, 64), (2, 448, 1500, 16, 16, 64),
    (1, 512, 1601, 64, 8, 128), (2, 70, 1601, 4, 2, 64),
]


@pytest.mark.parametrize("B,S,T,H,KV,dh", ENCDEC_ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_encdec_shapes_match_plain(cuda, B, S, T, H, KV, dh,
                                                   dtype):
    """The non-causal forward at the encoder and cross-attention shapes,
    within 2e-5 (fp32) / 2e-2 (bf16) of the plain version."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(14)
    q = _t(rng.normal(size=(B, S, H, dh)), dt, cuda)
    k, v = (_t(rng.normal(size=(B, T, KV, dh)), dt, cuda) for _ in range(2))
    n0 = FA.launches
    out = FA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FA.launches == n0 + 1
    torch.testing.assert_close(out.float(), attention_ref(
        q, k, v, causal=False).float(), atol=_tol(dt), rtol=_tol(dt))


@pytest.mark.parametrize("B,S,T,H,KV,dh", ENCDEC_ATTN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_encdec_shapes_match_plain(cuda, B, S, T, H, KV,
                                                       dh, dtype):
    """dq, dk, dv at the encoder and cross-attention shapes (T > S, a
    ragged key tail) against autograd through the plain version, each
    within 2e-5 (fp32) / 2e-2 (bf16) of its largest reference value;
    bitwise the same on a second call."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(15)
    q = _t(rng.normal(size=(B, S, H, dh)), dt, cuda)
    k, v = (_t(rng.normal(size=(B, T, KV, dh)), dt, cuda) for _ in range(2))
    dout = _t(rng.normal(size=(B, S, H, dh)), dt, cuda)
    n0 = FA.bwd_launches
    got = _grads(lambda *a: FA.flash_attention(*a, causal=False), (q, k, v),
                 dout)
    again = _grads(lambda *a: FA.flash_attention(*a, causal=False),
                   (q, k, v), dout)
    torch.cuda.synchronize()
    assert FA.bwd_launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _grads(lambda *a: attention_ref(*a, causal=False).float(),
                 [x.float() for x in (q, k, v)], dout.float())
    _assert_grads_close(got, [r.to(dt) for r in ref], _tol(dt),
                        f"flash_attention {dtype}")


def test_whisper_full_width_decode_matches_forward(cuda):
    """whisper-medium at full width (d 1024, 16 heads, 1500 frames), 2 + 2
    layers, fp32: ``cross_kv`` filled from the encoder output through
    each decoder layer's ``cross.wk`` / ``cross.wv``, then 16 tokens fed
    one by one through ``decode_step`` give the forward's logits (2 + 2 +
    2 ``flash_attention`` launches: encoder, decoder self, cross).  The
    fill is ``chip_smoke.fill_cross_kv``."""
    from chip_smoke import fill_cross_kv

    cfg = dataclasses.replace(get_config("whisper-medium"), dtype="float32",
                              n_layers=2, enc_layers=2)
    params = TM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(16)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(2, 16)),
                        device=cuda)
    frames = _t(rng.normal(size=(2, cfg.enc_seq, cfg.d_model)),
                torch.float32, cuda)
    n0 = FA.launches
    full = TM.forward(params, cfg, {"tokens": toks, "enc_frames": frames})
    torch.cuda.synchronize()
    assert FA.launches == n0 + 6
    cache = TM.init_cache(cfg, 2, 16, device=cuda)
    fill_cross_kv(torch, params, cfg, {"enc_frames": frames}, cache)
    outs = []
    for t in range(16):
        logits, _ = TM.decode_step(params, cfg, cache, {
            "tokens": toks[:, t:t + 1],
            "cache_index": torch.tensor(t, device=cuda)})
        outs.append(logits)
    dec = torch.stack(outs, dim=1)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
