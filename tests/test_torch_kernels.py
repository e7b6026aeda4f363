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


def test_moe_gmm_launch_plan():
    """The launch plan the wrapper hands the CUDA kernel at granite-moe
    width: an 8-row tile at decode (C=8) split over f to fill 132 SMs, a
    16-row tile per prefill round (C=80), and f-blocks dividing f."""
    assert MG.launch_plan(32, 8, 512, 132) == (8, 64, 8)
    assert MG.launch_plan(32, 80, 512, 132) == (16, 64, 2)
    bc, bf, splits = MG.launch_plan(4, 128, 96, 132)
    assert 96 % bf == 0 and bf <= MG.MAX_BLOCK_F and (96 // bf) % splits == 0
