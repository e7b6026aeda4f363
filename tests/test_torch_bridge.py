"""The JAX ↔ torch bridge: a bitwise round trip for fp32 and bf16 trees,
stacked layers keeping their leading (L,) dim, including mixed-dtype
mamba stacks and recurrent decode caches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_round_trip_is_bitwise(dtype):
    import dataclasses

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype=dtype)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jp, "cpu")
    assert tp["layers"]["moe"]["w1"].shape == (cfg.n_layers, cfg.n_experts,
                                               cfg.d_model, cfg.d_ff)
    assert tp["embed"].dtype == getattr(torch, dtype)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    back = bridge.to_numpy(tp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = jax.tree.map(jnp.asarray, back)
    assert jax.tree.structure(again) == jax.tree.structure(jp)


def test_bf16_bits_survive_both_directions():
    bits = np.arange(0, 65536, 7, dtype=np.uint16)
    a = jnp.asarray(bits.view(jnp.bfloat16))
    t = bridge.leaf_to_torch(a, torch.device("cpu"))
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)
    assert np.array_equal(bridge.leaf_to_numpy(t).view(np.uint16), bits)


def test_to_torch_copies_its_input():
    a = np.ones((3,), np.float32)
    t = bridge.to_torch({"a": a}, "cpu")["a"]
    a[0] = 5.0
    assert float(t[0]) == 1.0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_param_and_cache_trees_round_trip_is_bitwise(arch):
    """bf16 mamba stacks hold fp32 ``A_log``/``D``; caches hold bf16
    ``conv``/``k``/``v`` beside an fp32 ``h``.  Each leaf keeps its own
    dtype and bits both ways."""
    cfg = get_config(arch, smoke=True)
    trees = [JM.init_params(cfg, jax.random.PRNGKey(0)),
             jax.tree.map(lambda a: a + 1, JM.init_cache(cfg, 2, 8))]
    for tree in trees:
        tt = bridge.to_torch(tree, "cpu")
        back = bridge.to_numpy(tt)
        for (path, a), t, b in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree.leaves(tt), jax.tree.leaves(back)):
            a = np.asarray(a)
            assert str(t.dtype).split(".")[-1] == a.dtype.name, path
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    ssm = bridge.to_torch(trees[0], "cpu")["layers"]["ssm"]
    assert ssm["in_proj"]["w"].dtype == torch.bfloat16
    assert ssm["A_log"].dtype == ssm["D"].dtype == torch.float32
