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


# The backward's shapes: granite-moe-1b-a400m's training microbatch (C 1280)
# and its serving capacities, mixtral-8x7b's experts, and the shapes of
# tests/test_torch_cuda.py::test_moe_gmm_bwd_kernel_matches_plain (C, d and
# f cut inside a tile and off the 64-element TMA box)
BWD_PLAN_SHAPES = [
    (32, 1280, 1024, 512), (32, 8, 1024, 512), (32, 80, 1024, 512),
    (8, 160, 4096, 14336), (8, 8, 4096, 14336),
    (4, 128, 64, 128), (3, 13, 96, 96), (5, 37, 192, 320), (2, 1, 64, 64),
    (3, 70, 72, 40), (2, 33, 136, 104), (2, 200, 200, 136),
    (3, 130, 1032, 520),
]


def test_moe_gmm_backward_plan():
    """The four backward GEMMs at every shape above, bf16 and fp32: in
    launch order (kDh over C × f with K d, dw2 over f × d with K C, dw1 |
    dw3 over d × f with K C, dbuf over C × d with K 2f), the tiles cover M
    and N, bf16 runs 128-row tiles and fp32 keeps 64, each ring fits the
    232,448 bytes a block may hold, and each grid is what the launches
    compute: bf16 a persistent grid of min(tiles, SMs) blocks over the
    (M tiles × N tiles × E) tiles, fp32 (M tiles × N tiles, E).  Pinned:
    granite's C 1280."""
    smem_limit = 232448
    for E, C, d, f in BWD_PLAN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            plan = MG.backward_plan(E, C, d, f, dt)
            assert [(g.M, g.K, g.N, g.nb) for g in plan] == [
                (C, d, f, 2), (f, C, d, 1), (d, C, f, 2), (C, 2 * f, d, 1)]
            for i, g in enumerate(plan):
                assert g.block_m == (128 if dt == torch.bfloat16 else 64)
                assert g.block_m == MG.BWD_BLOCK_M[dt]
                assert g.stages == MG.BWD_STAGES[dt][i] >= 4
                m_tiles, n_tiles = -(-g.M // g.block_m), -(-g.N // g.block_n)
                assert g.block_m * m_tiles >= g.M > g.block_m * (m_tiles - 1)
                assert g.block_n * n_tiles >= g.N > g.block_n * (n_tiles - 1)
                assert g.tiles == m_tiles * n_tiles * E
                # bf16: a persistent grid, one block per SM at most
                assert g.grid == ((min(g.tiles, 132), 1)
                                  if dt == torch.bfloat16
                                  else (m_tiles * n_tiles, E))
                assert g.smem <= smem_limit
                if dt == torch.bfloat16:
                    # wgmma: 64-row halves, widths a multiple of 8 up to
                    # 256 (dw1 | dw3: 128 of each), K steps of one
                    # 128-byte swizzle row
                    assert g.block_n * (g.nb if i == 2 else 1) in (64, 256)
                    assert g.block_k == 64
                else:
                    assert g.block_n * g.nb == MG.WEIGHT_COLS
    bf = MG.backward_plan(32, 1280, 1024, 512, torch.bfloat16)
    assert [g.tiles for g in bf] == [80 * 32, 16 * 32, 32 * 32, 40 * 32]
    assert [g.grid for g in bf] == [(132, 1)] * 4
    assert [g.block_n for g in bf] == [64, 256, 128, 256]
    assert [g.stages for g in bf] == [4, 4, 4, 4]
    assert bf[0].smem == 1024 + 4 * (2 * 128 * 64 + 3 * 64 * 64) * 2 + 64
    fp = MG.backward_plan(32, 1280, 1024, 512, torch.float32)
    assert [g.grid for g in fp] == [(160, 32), (64, 32), (128, 32),
                                    (160, 32)]


@pytest.mark.parametrize("B,L,Di,N,grid,part", [
    # hymba-1.5b's chunk and falcon-mamba-7b's, as training launches them
    (1, 256, 3200, 16, (1600, 1), (200, 1, 256, 16)),
    (1, 256, 8192, 16, (4096, 1), (512, 1, 256, 16)),
    # hymba's two 128-token chunks of the 2-layer gradient check (B 2)
    (2, 128, 3200, 16, (1600, 2), (200, 2, 128, 16)),
    # ragged Di against the channels per block; L past one segment
    (3, 64, 33, 8, (16, 3), (2, 3, 64, 8)),
    (1, 600, 72, 16, (40, 1), (5, 1, 600, 16)),
])
def test_ssm_scan_bwd_plan(B, L, Di, N, grid, part):
    """The backward scan's geometry: one warp per block with one state
    lane per thread (32 / N channels), the channel groups padded to whole
    clusters of 8 (at B 1 and hymba's Di 3200: 1600 blocks, at least two
    per SM over 132 SMs), dA and h of min(L, 256) steps in shared memory
    within the 232,448 bytes a block may hold (three blocks per SM at 256
    steps), and the dC scratch one (B, L, N) partial per cluster."""
    from repro_torch.kernels.ssm_scan import ssm_scan as SS

    plan = SS.bwd_plan(B, L, Di, N)
    assert plan.threads == 32 and plan.channels_per_block == 32 // N
    assert plan.grid == grid and plan.part_shape == part
    assert plan.grid[0] % plan.cluster == 0
    assert plan.channels_per_block * plan.grid[0] >= Di
    assert plan.channels_per_block * (plan.grid[0] - plan.cluster) < Di
    assert plan.segments == -(-L // plan.segment)
    rows = -(-min(L, plan.segment) // 32) * 32  # whole 32-step boxes
    assert plan.smem == 2 * rows * 128 + 8 * (rows // 32)
    smem_limit = 232448  # the H100's 227 KB a block may hold
    assert plan.smem <= smem_limit
    if L >= plan.segment:
        assert 3 * plan.smem <= smem_limit
    if (B, Di) == (1, 3200):
        assert plan.grid[0] >= 2 * 132
