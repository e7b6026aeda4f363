"""The port's selective scan and mamba block against the JAX reference.

Same inputs (numpy, seeded) through both packages; weights from the
reference's ``ssm_init`` through the bridge.  On CPU tensors the port's
``ssm_scan`` wrapper runs its plain version, which is held here against
the reference's Pallas kernel in interpret mode and its ``ssm_scan_ref``
oracle at the reference's tolerance (1e-4, ``test_ssm_scan_sweep``).
Model-level scans use 1e-4 / 1e-3 (``test_ssm_model_scan_matches_kernel``)
and block outputs and caches 1e-4 / 1e-4.  The CUDA kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_scan_ref  # noqa: E402
from repro.kernels.ssm_scan.ssm_scan import ssm_scan as j_scan  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan as SS  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]

# (B, L, Di, N, chunk, block_d): the reference's test_ssm_scan_sweep
# shapes, then a ragged width (Di = 40 is no multiple of any block_d the
# CUDA kernel or hymba's 3200 would use)
SHAPES = [
    (2, 256, 64, 8, 64, 32),
    (1, 128, 128, 16, 128, 128),
    (3, 512, 32, 4, 128, 32),
    (1, 64, 40, 4, 16, 40),
]


def _scan_inputs(B, L, Di, N, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, size=(B, L, Di, N)).astype(np.float32),
            (rng.normal(size=(B, L, Di, N)) * 0.1).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("B,L,Di,N,chunk,block_d", SHAPES)
def test_plain_scan_matches_pallas_kernel(B, L, Di, N, chunk, block_d):
    dA, dBx, C = _scan_inputs(B, L, Di, N)
    n0 = SS.launches
    y, h = SS.ssm_scan(*_t(dA, dBx, C))
    assert SS.launches == n0          # CPU tensors: the plain version
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, L, Di)
    assert tuple(h.shape) == (B, Di, N)
    ref = j_scan(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C),
                 chunk=chunk, block_d=block_d, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("B,L,Di,N,chunk,block_d", SHAPES)
def test_plain_scan_matches_reference_oracle(B, L, Di, N, chunk, block_d):
    dA, dBx, C = _scan_inputs(B, L, Di, N, seed=7)
    y = SO.ssm_scan_auto(*_t(dA, dBx, C))
    ref = j_scan_ref(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("splits", [[64, 64, 64, 64], [1, 255],
                                    [100, 100, 56], [16] * 16])
def test_chained_state_equals_one_whole_call(splits):
    """Carrying ``h`` from one call into the next (``h0``) gives the
    whole-length result: y and the last state, bitwise (same order of
    operations)."""
    dA, dBx, C = _t(*_scan_inputs(2, 256, 24, 8, seed=3))
    y_whole, h_whole = SO.ssm_scan_op(dA, dBx, C)
    h, ys, t0 = None, [], 0
    for s in splits:
        y, h = SO.ssm_scan_op(dA[:, t0:t0 + s], dBx[:, t0:t0 + s],
                              C[:, t0:t0 + s], h)
        ys.append(y)
        t0 += s
    assert torch.equal(torch.cat(ys, dim=1), y_whole)
    assert torch.equal(h, h_whole)


def test_nonzero_initial_state_matches_unrolled_recurrence():
    dA, dBx, C = _t(*_scan_inputs(1, 5, 6, 4, seed=4))
    h0 = torch.randn(1, 6, 4, generator=torch.Generator().manual_seed(0))
    y, h = ssm_scan_ref(dA, dBx, C, h0)
    hh = h0.clone()
    for t in range(5):
        hh = dA[:, t] * hh + dBx[:, t]
        torch.testing.assert_close(y[:, t], (hh * C[:, t, None]).sum(-1))
    torch.testing.assert_close(h, hh)


# -- the mamba block ----------------------------------------------------------


def _cfgs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    cfg, tcfg = _cfgs(request.param)
    jp = JS.ssm_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, tcfg, jp, bridge.to_torch(jp, CPU)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def test_model_scan_matches_pallas_kernel():
    """Mirror of the reference's ``test_ssm_model_scan_matches_kernel``:
    the port's chained scan (four chunks) equals the Pallas recurrence on
    the reference's discretisation."""
    cfg, tcfg = _cfgs("falcon-mamba-7b")
    jp = JS.ssm_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = bridge.to_torch(jp, CPU)
    x = _x((2, 64, cfg.d_inner), 0, 0.3)
    dA, dBx, Cc = JS._ssm_params(jp, cfg, jnp.asarray(x))
    y_kernel = j_scan(dA, dBx, Cc, chunk=16, block_d=32, interpret=True)
    xt = torch.tensor(x)
    y_model = TS.ssm_scan_chunked(tp, tcfg, xt, chunk=16) - xt * tp["D"]
    np.testing.assert_allclose(y_model.numpy(), np.asarray(y_kernel),
                               atol=1e-4, rtol=1e-3)


def test_scan_chunk_must_divide_the_length(block):
    _, tcfg, _, tp = block
    x = torch.zeros(1, 24, tcfg.d_inner)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        TS.ssm_scan_chunked(tp, tcfg, x, chunk=16)


def test_ssm_params_match_reference(block):
    cfg, tcfg, jp, tp = block
    x = _x((2, 8, cfg.d_inner), 1, 0.3)
    for j, t in zip(JS._ssm_params(jp, cfg, jnp.asarray(x)),
                    TS._ssm_params(tp, tcfg, torch.tensor(x))):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


def test_causal_conv_matches_reference(block):
    cfg, tcfg, jp, tp = block
    x = _x((2, 9, cfg.d_inner), 2)
    state = _x((2, cfg.conv_width - 1, cfg.d_inner), 3)
    for s in (None, state):
        jy, js = JS._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                                 None if s is None else jnp.asarray(s))
        ty, ts = TS._causal_conv(torch.tensor(x), tp["conv_w"], tp["conv_b"],
                                 None if s is None else torch.tensor(s))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ssm_apply_matches_reference(block):
    cfg, tcfg, jp, tp = block
    x = _x((2, 64, cfg.d_model), 4)
    j = JS.ssm_apply(jp, cfg, jnp.asarray(x), chunk=16)
    t = TS.ssm_apply(tp, tcfg, torch.tensor(x), chunk=16)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                               rtol=1e-4)


def test_ssm_decode_apply_matches_reference(block):
    """Six steps from a zero state: outputs and the cache (updated IN
    PLACE in the port, returned anew by the reference) agree."""
    cfg, tcfg, jp, tp = block
    B = 2
    jc = {"conv": jnp.zeros((B, cfg.conv_width - 1, cfg.d_inner)),
          "h": jnp.zeros((B, cfg.d_inner, cfg.ssm_state))}
    tc = {k: torch.zeros(v.shape) for k, v in jc.items()}
    conv, h = tc["conv"], tc["h"]
    for step in range(6):
        x = _x((B, 1, cfg.d_model), 10 + step)
        jy, jc = JS.ssm_decode_apply(jp, cfg, jnp.asarray(x), jc)
        ty, out = TS.ssm_decode_apply(tp, tcfg, torch.tensor(x), tc)
        assert out is tc and tc["conv"] is conv and tc["h"] is h
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-4, rtol=1e-4)


def test_decode_equals_whole_sequence_apply(block):
    """The O(1) decode recurrence reproduces the chunked forward scan
    token by token (port against itself)."""
    _, tcfg, _, tp = block
    x = torch.tensor(_x((1, 12, tcfg.d_model), 5))
    whole = TS.ssm_apply(tp, tcfg, x, chunk=4)
    cache = {"conv": torch.zeros(1, tcfg.conv_width - 1, tcfg.d_inner),
             "h": torch.zeros(1, tcfg.d_inner, tcfg.ssm_state)}
    steps = [TS.ssm_decode_apply(tp, tcfg, x[:, t:t + 1], cache)[0]
             for t in range(12)]
    torch.testing.assert_close(torch.cat(steps, dim=1), whole, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_init_matches_reference_tree(arch):
    """Same keys, shapes and dtypes as the reference's ``ssm_init`` in bf16
    (``A_log``/``D`` stay fp32), and the same deterministic values."""
    cfg, tcfg = get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    jp = JS.ssm_init(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = TS.ssm_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == v.dtype.name, k
    for k in ("['A_log']", "['D']", "['conv_b']", "['dt_proj']['b']"):
        np.testing.assert_array_equal(tflat[k].float().numpy(),
                                      jflat[k].astype(np.float32))
