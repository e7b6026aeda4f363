"""The port's ``*_shapes`` functions and ``input_specs`` against the
reference's, for every arch at full size.

The reference's functions return ``jax.ShapeDtypeStruct`` trees, the
port's trees of meta tensors built by its own ``*_init`` (through
``layers._MetaGenerator``): neither allocates, so full size costs
nothing.  Each tree is compared as its keys and its leaves' (shape,
dtype).  One dtype mapping: ``input_specs``' token ids, labels and cache
index are int64 in the port (its embedding and loss index with int64)
where the reference's are int32; every other dtype maps one to one
(bfloat16, float32).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import SHAPES, input_specs  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int64}
#: a decode cache of decode_32k's size
CACHE_B, CACHE_LEN = 128, 32768


def _tree(node):
    """A shape tree as nested dicts of (shape, torch dtype)."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        assert node.device.type == "meta", node.device
        return tuple(node.shape), node.dtype
    return tuple(node.shape), DTYPES[jnp.dtype(node.dtype)]


def _kinds(cfg):
    return sorted({kind for _, kind, _, _ in JM._plan(cfg)})


def _dtypes(cfg):
    return jnp.dtype(cfg.dtype), getattr(torch, cfg.dtype)


def _pairs(arch):
    """(reference tree, port tree) per function, for ``arch``."""
    jc, tc = get_config(arch), t_get_config(arch)
    jd, td = _dtypes(jc)
    d, f = jc.d_model, jc.d_ff
    out = {
        "param_shapes": (JM.param_shapes(jc), TM.param_shapes(tc)),
        "cache_shapes": (JM.cache_shapes(jc, CACHE_B, CACHE_LEN),
                         TM.cache_shapes(tc, CACHE_B, CACHE_LEN)),
        "dense_shapes": ({"a": JL.dense_shapes(d, 3 * d, True, jd),
                          "b": JL.dense_shapes(d, d, False, jd)},
                         {"a": TL.dense_shapes(d, 3 * d, True, td),
                          "b": TL.dense_shapes(d, d, False, td)}),
        "norm_shapes": (JL.norm_shapes(d, jc.norm, jd),
                        TL.norm_shapes(d, tc.norm, td)),
        "layer_shapes": ({k: JB.layer_shapes(jc, jd, k) for k in _kinds(jc)},
                         {k: TB.layer_shapes(tc, td, k)
                          for k in _kinds(tc)}),
        "layer_cache_shapes": (
            {k: JB.layer_cache_shapes(jc, k, CACHE_B, CACHE_LEN, jd)
             for k in _kinds(jc) if k != "enc"},
            {k: TB.layer_cache_shapes(tc, k, CACHE_B, CACHE_LEN, td)
             for k in _kinds(tc) if k != "enc"}),
    }
    if jc.family != "ssm":
        out["attn_shapes"] = (JL.attn_shapes(jc, jd), TL.attn_shapes(tc, td))
        out["mlp_shapes"] = (JL.mlp_shapes(d, f, jc.act, jd),
                             TL.mlp_shapes(d, f, tc.act, td))
    if jc.family == "moe":
        out["moe_shapes"] = (JMOE.moe_shapes(jc, jd),
                             TMOE.moe_shapes(tc, td))
    if jc.family in ("ssm", "hybrid"):
        out["ssm_shapes"] = (JS.ssm_shapes(jc, jd), TS.ssm_shapes(tc, td))
        out["ssm_cache_shapes"] = (JS.ssm_cache_shapes(jc, CACHE_B, jd),
                                   TS.ssm_cache_shapes(tc, CACHE_B, td))
    for name in SHAPES:
        out[f"input_specs[{name}]"] = (
            j_input_specs(jc, SHAPES[name]), input_specs(tc, SHAPES[name]))
    return out


FUNCTIONS = ("param_shapes", "cache_shapes", "dense_shapes", "norm_shapes",
             "layer_shapes", "layer_cache_shapes", "attn_shapes",
             "mlp_shapes", "moe_shapes", "ssm_shapes", "ssm_cache_shapes",
             "input_specs")


def _applies(fn, family):
    """The functions each family's blocks use: the mamba-only ssm family
    has no attention and no MLP, only the moe family has experts, only
    ssm and hybrid have mamba heads."""
    if fn in ("attn_shapes", "mlp_shapes"):
        return family != "ssm"
    if fn == "moe_shapes":
        return family == "moe"
    if fn in ("ssm_shapes", "ssm_cache_shapes"):
        return family in ("ssm", "hybrid")
    return True


@pytest.mark.parametrize("arch,fn", [
    (a, fn) for a in ARCH_IDS for fn in FUNCTIONS
    if _applies(fn, get_config(a).family)])
def test_shapes_match_reference(arch, fn):
    """The port's tree of (shape, dtype) is the reference's, key for key
    (every shape cell for ``input_specs``)."""
    pairs = {k: v for k, v in _pairs(arch).items()
             if k == fn or k.startswith(fn + "[")}
    assert pairs
    for name, (ref, port) in pairs.items():
        assert _tree(port) == _tree(ref), name


def test_shapes_allocate_nothing():
    """The full-size vlm's ~90 B parameters are meta tensors: shapes and
    dtypes, no storage."""
    leaves = jax.tree.leaves(TM.param_shapes(
        t_get_config("llama-3.2-vision-90b")))
    assert sum(t.numel() for t in leaves) > 80e9
    assert all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_is_cache_shapes_filled(arch):
    """``init_cache`` (SMOKE, on the CPU) has ``cache_shapes``' tree, each
    leaf zero."""
    cfg = t_get_config(arch, smoke=True)
    cache = TM.init_cache(cfg, 2, 16, device="cpu")
    assert _tree(TM.cache_shapes(cfg, 2, 16)) == _tree(
        jax.tree.map(lambda t: t.to("meta"), cache))
    for t in jax.tree.leaves(cache):
        assert not t.any()
