"""Training of the ssm and hybrid families (falcon-mamba-7b, hymba-1.5b) on
the CPU against the JAX reference, and the plain backward of the selective
scan.

* One AdamW step of each family's SMOKE config in fp32, from the
  reference's own ``init_params`` through the bridge, as
  ``tests/test_torch_train.py`` holds granite: the step compared is the
  second, from a state the reference's first step wrote; grad norm within
  rel 1e-5, m, v and master within 2e-5 × their largest value, params
  within 2e-5.  The weights are the reference's at ``PRNGKey(1)``: at
  ``PRNGKey(0)`` falcon-mamba's smoke model is so badly conditioned in
  fp32 that the reference's own gradient lies 2.5e-5 of its largest value
  from a float64 one, and its v then differs from the port's by 3e-5.
  ``test_fp32_gradient_no_further_from_float64_than_reference`` holds the
  port at that seed to the reference's own distance from float64.
* ``ssm_scan_bwd_ref`` against autograd through ``ssm_scan_ref`` (fp32,
  1e-5 × the largest gradient), with and without ``h0`` and ``dh_last``,
  and along a chain of two chunks; and the autograd wiring of
  ``SsmScanFn`` (which only CUDA tensors reach) with the plain versions
  put in place of the kernels.
* ``python -m repro_torch.launch.train --arch <ssm or hybrid> --smoke``
  on the CPU: a crash after step 3, a resume from the step-2 checkpoint,
  and the final loss of an uninterrupted run within 1e-5.
"""

import dataclasses
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShapeConfig  # noqa: E402
from repro_torch.launch import train as TLaunch  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan as SS  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    ssm_scan_bwd_ref, ssm_scan_ref,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.trainer import SimulatedFailure  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


def _cfgs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="float32"))


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _np_leaves(tree):
    """Leaves of a JAX or torch tree as fp32 numpy, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, np.float32)]


def _close_to_max(got, ref, tol, what):
    for i, (g, r) in enumerate(zip(_np_leaves(got), _np_leaves(ref))):
        assert g.shape == r.shape, (what, i)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol}×{scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_reference(arch):
    """Two scan chunks per layer (ssm_chunk 8 over 16 tokens), so the
    gradient also crosses a chunk boundary."""
    cfg, tcfg = _cfgs(arch)
    scfg = dict(q_chunk=8, k_chunk=8, ssm_chunk=8)
    shape = ShapeConfig("s", 16, 4, "train", microbatches=2)
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    js = JO.init_opt_state(jp, ocfg)
    jstep, _ = JT.build_train_step(cfg, shape, JT.StepConfig(**scfg), ocfg)
    jstep = jax.jit(jstep)
    jp, js, _ = jstep(jp, js, {k: jnp.asarray(v)
                               for k, v in _batch(cfg, 4, 16, 0).items()})
    batch = _batch(cfg, 4, 16, 1)
    jp2, js2, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts = bridge.to_torch(jp, CPU), bridge.to_torch(js, CPU)
    tstep, _ = TT.build_train_step(
        tcfg, TShapeConfig("s", 16, 4, "train", microbatches=2),
        TT.StepConfig(**scfg), TO.AdamWConfig(lr=1e-3, warmup_steps=2))
    tp2, ts2, tm = tstep(tp, ts, {k: torch.tensor(v)
                                  for k, v in batch.items()})
    gj, gt = float(jm["grad_norm"]), float(tm["grad_norm"])
    assert abs(gt - gj) <= 1e-5 * gj
    assert int(tm["nonfinite_skipped"]) == int(jm["nonfinite_skipped"]) == 0
    assert int(ts2["step"]) == int(js2["step"]) == 2
    _close_to_max(ts2["m"], js2["m"], 2e-5, "m")
    _close_to_max(ts2["v"], js2["v"], 2e-5, "v")
    for g, r in zip(_np_leaves(tp2), _np_leaves(jp2)):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=0)
    _close_to_max(ts2["master"], js2["master"], 2e-5, "master")


def test_fp32_gradient_no_further_from_float64_than_reference():
    """falcon-mamba SMOKE at ``PRNGKey(0)``, the seed the one-step test
    leaves: the reference's fp32 loss gradient lies more than 2e-5 of a
    leaf's largest value from the port's float64 gradient, and the port's
    fp32 gradient lies no further from it (worst leaf against worst leaf),
    so the gap between the two packages there is fp32 rounding, not a
    fault of either."""
    cfg, tcfg = _cfgs("falcon-mamba-7b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    b = _batch(cfg, 2, 16, 1)
    jg = jax.grad(lambda p: JM.loss_fn(
        p, cfg, {k: jnp.asarray(v) for k, v in b.items()}, ssm_chunk=8))(jp)
    tp = bridge.to_torch(jp, CPU)

    def grads(params):
        views = [t.detach().clone().requires_grad_(True)
                 for t in tree_leaves(params)]
        loss = TM.loss_fn(tree_unflatten(params, views), tcfg,
                          {k: torch.tensor(v) for k, v in b.items()},
                          ssm_chunk=8)
        return torch.autograd.grad(loss, views)

    g32, g64 = grads(tp), grads(tree_map(lambda t: t.double(), tp))
    ref_err, port_err = [], []
    for j, t, x in zip(jax.tree.leaves(jg), g32, g64):
        x = x.numpy()
        scale = float(np.abs(x).max())
        ref_err.append(float(np.abs(np.asarray(j, np.float64) - x).max())
                       / scale)
        port_err.append(float(np.abs(t.double().numpy() - x).max()) / scale)
    # the conditioning the one-step test avoids, and the port inside it
    assert max(ref_err) > 2e-5
    assert max(port_err) <= max(ref_err), (port_err, ref_err)


# (B, L, Di, N, with h0, with dh_last)
BWD_CASES = [
    (2, 16, 8, 4, False, False), (2, 16, 8, 4, True, False),
    (1, 33, 12, 8, False, True), (3, 20, 5, 16, True, True),
]


def _scan_inputs(B, L, Di, N, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0.5, 0.999, size=(B, L, Di, N)),
              rng.normal(size=(B, L, Di, N)) * 0.1,
              rng.normal(size=(B, L, N)), rng.normal(size=(B, Di, N)),
              rng.normal(size=(B, L, Di)), rng.normal(size=(B, Di, N)))
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def _close_grads(got, ref, tol=1e-5):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())
        assert float(r.abs().max()) > 0 or float(g.abs().max()) == 0


@pytest.mark.parametrize("B,L,Di,N,with_h0,with_dh", BWD_CASES)
def test_plain_backward_matches_autograd(B, L, Di, N, with_h0, with_dh):
    dA, dBx, C, h0, dy, dh = _scan_inputs(B, L, Di, N, seed=L)
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    leaves = [t.requires_grad_(True) for t in (dA, dBx, C, h0)
              if t is not None]
    y, h = ssm_scan_ref(dA, dBx, C, h0)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    ref = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        got = ssm_scan_bwd_ref(dA, dBx, C, h0, dy, dh)
    _close_grads(got if with_h0 else got[:3], ref)


def _plain_kernels(monkeypatch):
    """Put the plain versions where ``SsmScanFn`` launches the kernels."""
    monkeypatch.setattr(SS, "_forward", lambda dA, dBx, C, h0: tuple(
        t.detach() for t in ssm_scan_ref(dA, dBx, C, h0)))

    def bwd(dA, dBx, C, h0, dy, dh_last=None):
        d_dA, d_dBx, dC, dh0 = ssm_scan_bwd_ref(dA, dBx, C, h0, dy, dh_last)
        return d_dA, d_dBx, dC, None if h0 is None else dh0
    monkeypatch.setattr(SS, "ssm_scan_bwd", bwd)


@pytest.mark.parametrize("with_h0", [False, True])
def test_chain_of_two_chunks_differentiates_end_to_end(monkeypatch, with_h0):
    """Two chunks carrying the state through ``SsmScanFn`` (the path of
    CUDA tensors, with the plain versions in place of the kernels, so the
    backward is ``ssm_scan_bwd_ref``), as ``models/ssm.py`` chains them:
    the gradients of every input of both chunks equal autograd through one
    whole-length plain scan."""
    _plain_kernels(monkeypatch)
    dA, dBx, C, h0, dy, dh = _scan_inputs(2, 24, 6, 4, seed=3)
    h0 = h0 if with_h0 else None
    leaves = [t.requires_grad_(True) for t in (dA, dBx, C, h0)
              if t is not None]
    y, h = ssm_scan_ref(dA, dBx, C, h0)
    ref = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    hc, ys = h0, []
    for t0, t1 in ((0, 10), (10, 24)):
        yc, hc = SS.SsmScanFn.apply(dA[:, t0:t1], dBx[:, t0:t1],
                                    C[:, t0:t1], hc)
        ys.append(yc)
    loss = (torch.cat(ys, dim=1) * dy).sum() + (hc * dh).sum()
    _close_grads(torch.autograd.grad(loss, leaves), ref)


def test_scan_fn_without_state_or_output_gradients(monkeypatch):
    """``SsmScanFn`` from a zero state, with only ``h_last`` used (``dy``
    arrives as None) and with only ``y`` used (``dh_last`` None): the
    gradients equal autograd through the plain scan."""
    _plain_kernels(monkeypatch)
    dA, dBx, C, _, dy, dh = _scan_inputs(1, 9, 4, 8, seed=5)
    leaves = [t.requires_grad_(True) for t in (dA, dBx, C)]
    for pick in (lambda y, h: (h * dh).sum(), lambda y, h: (y * dy).sum()):
        ref = torch.autograd.grad(pick(*ssm_scan_ref(dA, dBx, C)), leaves,
                                  allow_unused=True)
        # C reaches y alone: without y its gradient is zero
        ref = [torch.zeros_like(t) if r is None else r
               for r, t in zip(ref, leaves)]
        got = torch.autograd.grad(pick(*SS.SsmScanFn.apply(dA, dBx, C, None)),
                                  leaves)
        _close_grads(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_crash_and_resume(arch, capsys):
    common = ["--arch", arch, "--smoke", "--steps", "6", "--ckpt-every", "2",
              "--seq-len", "32", "--device", "cpu"]
    d = tempfile.mkdtemp()
    try:
        with pytest.raises(SimulatedFailure):
            TLaunch.main(common + ["--ckpt-dir", d + "/a", "--failure-at",
                                   "3"])
        resumed = TLaunch.main(common + ["--ckpt-dir", d + "/a"])
        whole = TLaunch.main(common + ["--ckpt-dir", d + "/b"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    capsys.readouterr()
    assert resumed["resumed_from"] == 2 and resumed["completed"] == 6
    assert np.isfinite(whole["last_loss"])
    assert resumed["last_loss"] == pytest.approx(whole["last_loss"],
                                                 abs=1e-5)
