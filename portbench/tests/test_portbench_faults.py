"""The check that decides ``correct`` fails a broken timed path: a run
driven past the harness's look for a card, at the smoke sizes, with one
fault planted underneath in the program."""

from __future__ import annotations

import pytest
import torch

from portbench import run as R
from portbench.tests.smoke import smoke_cell


def _run(name, seconds=0.3):
    return R.run_cell(smoke_cell(name), 2 ** 32 + 3, seconds, 0,
                      device="cpu")


@pytest.mark.parametrize("name", ["granite-train-4k"])
def test_step_that_leaves_its_state_unchanged(name, monkeypatch):
    import repro_torch.train.train_step as TS

    def unchanged(params, grads, state, ocfg, **kw):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(()),
                               "nonfinite_skipped": torch.zeros(
                                   (), dtype=torch.int32)}
    monkeypatch.setattr(TS, "adamw_update", unchanged)
    result, lines = _run(name)
    assert result["correct"] is False, lines
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["granite-train-4k"])
def test_half_of_the_batch_left_out(name, monkeypatch):
    import repro_torch.models.model as MDL

    whole = MDL.loss_fn

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return whole(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(MDL, "loss_fn", half)
    result, lines = _run(name)
    assert result["correct"] is False, lines


def test_served_token_altered_where_it_is_produced(monkeypatch):
    import repro_torch.models.model as MDL

    best = MDL.vocab_argmax
    calls = []

    def altered(logits, vocab, tp=None):
        out = best(logits, vocab, tp)
        calls.append(1)
        if len(calls) % 3 == 0:
            out = (out + 1) % vocab     # every slot's token, every third call
        return out
    monkeypatch.setattr(MDL, "vocab_argmax", altered)
    result, lines = _run("granite-serve-docqa", seconds=3.0)
    assert result["correct"] is False, lines
