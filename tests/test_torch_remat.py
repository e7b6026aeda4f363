"""``remat`` in the port, as the reference's ``jax.checkpoint``: each layer
under non-reentrant ``torch.utils.checkpoint`` when ``remat`` is set and
grad is enabled, and each mamba scan chunk whenever grad is enabled.

For granite-moe, hymba and whisper SMOKE (fp32, weights from the
reference's ``init_params`` through the bridge, tokens from seeded
numpy): the gradients with ``remat`` equal those without (max |Δ| 0.0
expected, 1e-6 at most); a counter on ``layer_apply`` shows each layer
run twice in a grad pass with ``remat`` and once without, and once in a
grad-free forward; on hymba a counter on the scan shows each chunk's scan
run three times with ``remat`` (the forward, the layer's recompute, the
chunk's own recompute inside it), twice without, and once without grad.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "hymba-1.5b", "whisper-medium"]
S, CHUNK = 32, 16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True),
                               dtype="float32")
    params = bridge.to_torch(JM.init_params(cfg, jax.random.PRNGKey(0)),
                             "cpu")
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, tcfg.vocab, size=(2, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if tcfg.family == "encdec":
        batch["enc_frames"] = torch.tensor(rng.normal(
            size=(2, tcfg.enc_seq, tcfg.d_model)).astype(np.float32))
    return tcfg, params, batch


def _count(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _grads(cfg, params, batch, remat):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    TM.loss_fn(p, cfg, batch, remat=remat, ssm_chunk=CHUNK).backward()
    return [t.grad for t in tree_leaves(p)]


def _n_layers(cfg):
    return cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)


def test_remat_gradients_equal(model):
    cfg, params, batch = model
    off = _grads(cfg, params, batch, remat=False)
    on = _grads(cfg, params, batch, remat=True)
    worst = max(float((a - b).abs().max()) for a, b in zip(on, off))
    assert worst <= 1e-6


@pytest.mark.parametrize("remat,calls", [(True, 2), (False, 1)])
def test_layers_recomputed_only_with_remat(model, monkeypatch, remat,
                                           calls):
    cfg, params, batch = model
    n = _count(monkeypatch, TB, "layer_apply")
    _grads(cfg, params, batch, remat=remat)
    assert n["n"] == calls * _n_layers(cfg)


def test_grad_free_forward_runs_each_layer_once(model, monkeypatch):
    cfg, params, batch = model
    n = _count(monkeypatch, TB, "layer_apply")
    with torch.no_grad():
        TM.forward(params, cfg, batch, remat=True, ssm_chunk=CHUNK)
    assert n["n"] == _n_layers(cfg)


@pytest.mark.parametrize("remat,grad,calls", [
    (True, True, 3), (False, True, 2), (True, False, 1)])
def test_ssm_chunks_rematerialised(monkeypatch, remat, grad, calls):
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="float32")
    tcfg = dataclasses.replace(t_get_config("hymba-1.5b", smoke=True),
                               dtype="float32")
    params = bridge.to_torch(JM.init_params(cfg, jax.random.PRNGKey(0)),
                             "cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(1, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n = _count(monkeypatch, TS, "ssm_scan_op")
    if grad:
        _grads(tcfg, params, batch, remat=remat)
    else:
        with torch.no_grad():
            TM.loss_fn(params, tcfg, batch, remat=remat, ssm_chunk=CHUNK)
    assert n["n"] == calls * tcfg.n_layers * (S // CHUNK)
