"""The ``moe`` family (granite-moe): a decoder whose layers hold a top-k
mixture of SwiGLU experts behind a float32 router.

A family is found by the configuration's ``family``: this file gives its
weight leaves and its active parameters, ``portbench/reference/moe.py``
its plain reference."""

from __future__ import annotations

from ..lib import costs, weights


def leaf_specs(model: dict) -> list:
    d, f, E = model["d_model"], model["d_ff"], model["n_experts"]
    return weights.decoder_leaves(model, [
        (("moe", "router"), (d, E), "randn", d ** -0.5, True),
        (("moe", "w1"), (E, d, f), "randn", d ** -0.5, False),
        (("moe", "w3"), (E, d, f), "randn", d ** -0.5, False),
        (("moe", "w2"), (E, f, d), "randn", f ** -0.5, False)])


def n_active_params(model: dict) -> int:
    """The attention, top_k of the experts, embedding and head."""
    return costs.decoder_params(
        model, model["top_k"] * 3 * model["d_model"] * model["d_ff"])
