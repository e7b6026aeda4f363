"""The port's kernel modules on the CPU against the JAX reference.

Same inputs (numpy, seeded) through the reference and the port.  On CPU
tensors each port wrapper runs its plain PyTorch version; the reference
side runs its plain oracle (``repro.kernels.*.ref``), which its own
``tests/test_kernels.py`` holds equal to the Pallas kernels.  Tolerances
are the reference's: 2e-5 fp32 / 2e-2 bf16 for attention, 5× for the
grouped FFN.  The CUDA kernels themselves are held against the plain
versions on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as j_attention  # noqa: E402
from repro.kernels.moe_dispatch.ref import moe_gmm_ref as j_gmm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as FA  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_gmm as MG  # noqa: E402

DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def _pair(a, jdtype):
    """One numpy draw as a JAX array and the bitwise-equal torch tensor."""
    j = jnp.asarray(a, jdtype)
    return j, bridge.leaf_to_torch(j, torch.device("cpu"))


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("E,C,d,f", [
    (4, 128, 64, 128),
    (2, 256, 128, 256),
    (8, 128, 128, 384),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_matches_reference(E, C, d, f, dtype):
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(42)
    buf, tbuf = _pair(rng.normal(size=(E, C, d)) * 0.5, jdt)
    w1, tw1 = _pair(rng.normal(size=(E, d, f)) * 0.1, jdt)
    w3, tw3 = _pair(rng.normal(size=(E, d, f)) * 0.1, jdt)
    w2, tw2 = _pair(rng.normal(size=(E, f, d)) * 0.1, jdt)
    n0 = MG.launches
    out = MG.moe_gmm(tbuf, tw1, tw3, tw2)
    assert MG.launches == n0          # CPU tensors: the plain version
    assert out.dtype == tbuf.dtype and tuple(out.shape) == (E, C, d)
    _close(out, j_gmm(buf, w1, w3, w2), tol * 5)


@pytest.mark.parametrize("B,S,H,KV,dh", [
    (1, 256, 4, 2, 64),
    (2, 128, 8, 8, 64),
    (1, 512, 4, 1, 128),
    (2, 256, 6, 2, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, S, H, KV, dh, causal, dtype):
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(42)
    q, tq = _pair(rng.normal(size=(B, S, H, dh)), jdt)
    k, tk = _pair(rng.normal(size=(B, S, KV, dh)), jdt)
    v, tv = _pair(rng.normal(size=(B, S, KV, dh)), jdt)
    n0 = FA.launches
    out = FA.flash_attention(tq, tk, tv, causal=causal)
    assert FA.launches == n0
    assert out.dtype == tq.dtype
    _close(out, j_attention(q, k, v, causal=causal), tol)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_attention_window_matches_reference(window):
    rng = np.random.default_rng(43)
    B, S, H, KV, dh = 1, 512, 4, 2, 64
    q, tq = _pair(rng.normal(size=(B, S, H, dh)), jnp.float32)
    k, tk = _pair(rng.normal(size=(B, S, KV, dh)), jnp.float32)
    v, tv = _pair(rng.normal(size=(B, S, KV, dh)), jnp.float32)
    out = FA.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(out, j_attention(q, k, v, causal=True, window=window), 2e-5)


# The expert shapes the plan is held to: granite-moe-1b-a400m (E 32, d 1024,
# f 512) per decode step, prefill round and 256-token forward; mixtral-8x7b
# (E 8, d 4096, f 14336) per decode step, fp32 forward and bf16 forward, and
# at E 2 for the card tests; and the ragged shapes of tests/test_torch_cuda.py
PLAN_SHAPES = [
    (32, 8, 1024, 512), (32, 80, 1024, 512), (32, 256, 1024, 512),
    (8, 8, 4096, 14336), (8, 64, 4096, 14336), (8, 160, 4096, 14336),
    (2, 1, 4096, 14336), (2, 8, 4096, 14336), (2, 160, 4096, 14336),
    (4, 128, 64, 128), (2, 256, 128, 256), (8, 128, 128, 384),
    (3, 13, 96, 96), (5, 37, 192, 320), (8, 40, 4096, 1024),
    (3, 13, 1152, 96), (2, 8, 2048, 64),
]


def test_moe_gmm_launch_plan():
    """The two-kernel plan at every shape above, bf16 and fp32, on 132
    SMs: the C tiles cover C, the f tiles of gate-up and the d tiles of
    down cover f and d, tile widths and K steps are multiples of 8, each
    weight tile is read once per C tile (ceil(C / BM) times), each ring
    fits two blocks per SM, and K splits divide the down kernel's K tiles.
    Pinned: granite decode takes 32-row tiles unsplit; its prefill round
    and forward 128-row tiles in bf16 and 64-row tiles in fp32 (whose
    accumulators take twice the registers); mixtral's bf16 forward (C =
    160) 64-row tiles."""
    smem_per_sm = 232448
    for E, C, d, f in PLAN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            plan = MG.launch_plan(E, C, d, f, dt, 132)
            gu, dn = plan.gate_up, plan.down
            bm = gu.block_m
            m_tiles = -(-C // bm)
            assert dn.block_m == bm and bm in MG.STAGES
            assert bm <= 64 or dt == torch.bfloat16
            assert bm * m_tiles >= C and bm * (m_tiles - 1) < C
            for g, n, k in ((gu, f, d), (dn, d, f)):
                n_tiles = -(-n // g.block_n)
                assert g.block_n % 8 == 0 and g.block_k % 8 == 0
                assert g.block_n * n_tiles >= n
                # one block per (C tile, N tile, expert, split): each weight
                # tile is read by m_tiles = ceil(C / BM) blocks per split
                assert g.grid == (m_tiles * n_tiles, E, g.splits)
                k_tiles = -(-k // g.block_k)
                assert k_tiles % g.splits == 0
                assert g.stages == MG.STAGES[bm]
                esize = 2 if dt == torch.bfloat16 else 4
                ring = g.stages * (bm * (g.block_k + 16 // esize)
                                   + g.block_k * (MG.WEIGHT_COLS + 8)) * esize
                assert MG.BLOCKS_PER_SM * ring <= smem_per_sm
            assert gu.splits == 1            # SwiGLU needs whole sums
            assert gu.block_n * 2 == dn.block_n == MG.WEIGHT_COLS
    for dt in (torch.bfloat16, torch.float32):
        assert MG.launch_plan(32, 8, 1024, 512, dt, 132).down[:5] == \
            (32, 128, MG.BLOCK_K[dt], 8, 1)
    for C in (80, 256):
        assert MG.launch_plan(32, C, 1024, 512, torch.bfloat16,
                              132).down.block_m == 128
        assert MG.launch_plan(32, C, 1024, 512, torch.float32,
                              132).down.block_m == 64
    assert MG.launch_plan(8, 160, 4096, 14336, torch.bfloat16,
                          132).down.block_m == 64
    # a small grid splits the down kernel's K: mixtral's widths at E 2
    assert MG.launch_plan(2, 8, 4096, 14336, torch.bfloat16,
                          132).down.splits == 4


def test_moe_gmm_refuses_shapes_off_the_8_grid():
    """d and f must be multiples of 8: the wrapper names the shape."""
    for d, f in ((12, 16), (16, 20)):
        buf = torch.zeros(2, 3, d)
        w = torch.zeros(2, d, f)
        with pytest.raises(ValueError, match=f"d={d} and f={f}"):
            MG._check_shapes(buf, w, w, torch.zeros(2, f, d))
    MG._check_shapes(torch.zeros(2, 3, 16), torch.zeros(2, 16, 24),
                     torch.zeros(2, 16, 24), torch.zeros(2, 24, 16))


def test_refuse_grad():
    """``ssm_scan`` has a backward now, so nothing refuses grad mode any
    more: on CPU tensors that require grad the wrapper runs its plain
    version under autograd, and the gradients of ``y`` and of the last
    state (from a carried ``h0``) equal the plain backward
    ``ssm_scan_bwd_ref``'s within 1e-5 × their largest value."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    rng = np.random.default_rng(8)
    B, L, Di, N = 2, 12, 6, 4
    arrays = (rng.uniform(0.5, 0.999, size=(B, L, Di, N)),
              rng.normal(size=(B, L, Di, N)) * 0.1,
              rng.normal(size=(B, L, N)), rng.normal(size=(B, Di, N)))
    dA, dBx, C, h0 = (torch.tensor(a, dtype=torch.float32,
                                   requires_grad=True) for a in arrays)
    dy = torch.tensor(rng.normal(size=(B, L, Di)), dtype=torch.float32)
    dh = torch.tensor(rng.normal(size=(B, Di, N)), dtype=torch.float32)
    y, h = SS.ssm_scan(dA, dBx, C, h0)
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(),
                              (dA, dBx, C, h0))
    with torch.no_grad():
        ref = ssm_scan_bwd_ref(dA, dBx, C, h0, dy, dh)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_plain_versions_stay_differentiable_on_cpu():
    """On CPU tensors the wrappers run their plain versions, which autograd
    differentiates (on CUDA tensors their backward kernels run)."""
    rng = np.random.default_rng(7)
    E, C, d, f = 2, 5, 16, 24
    buf, w1, w3 = (torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                requires_grad=True)
                   for s in ((E, C, d), (E, d, f), (E, d, f)))
    w2 = torch.tensor(rng.normal(size=(E, f, d)), dtype=torch.float32,
                      requires_grad=True)
    MG.moe_gmm(buf, w1, w3, w2).square().sum().backward()
    q = torch.tensor(rng.normal(size=(1, 8, 2, 16)), dtype=torch.float32,
                     requires_grad=True)
    kv = torch.tensor(rng.normal(size=(1, 8, 1, 16)), dtype=torch.float32,
                      requires_grad=True)
    FA.flash_attention(q, kv, kv).sum().backward()
    for t in (buf, w1, w3, w2, q, kv):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().sum()) > 0
