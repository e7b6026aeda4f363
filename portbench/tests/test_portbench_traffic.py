"""The traffic generators repeat exactly for a seed, and every seed gets
the same sizes."""

from __future__ import annotations

import pytest
import torch

from portbench.lib.cell import load
from portbench.lib.serve import request_pool
from portbench.lib.train import batch_at

SEEDS = [0, 7, 2 ** 31 + 11, 4_000_000_017]


@pytest.mark.parametrize("seed", SEEDS)
def test_request_pool_repeats(seed):
    t = load("granite-serve-docqa").traffic
    a = request_pool(t, 49155, seed)
    assert a == request_pool(t, 49155, seed)
    b = request_pool(t, 49155, seed + 1)
    assert a != b
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(o for _, o in a) == sorted(o for _, o in b)
    assert all(512 <= len(p) <= 3072 and 16 <= o <= 128 for p, o in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat(seed):
    t = dict(load("granite-train-4k").traffic, seq_len=32, global_batch=4)
    m = {"vocab": 1000}
    a = batch_at(t, m, seed, 3, "cpu")
    assert torch.equal(a["tokens"], batch_at(t, m, seed, 3, "cpu")["tokens"])
    assert not torch.equal(a["tokens"],
                           batch_at(t, m, seed, 4, "cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
