"""The JAX ↔ torch bridge: a bitwise round trip for fp32 and bf16 trees,
stacked layers keeping their leading (L,) dim."""

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
