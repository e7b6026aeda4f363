"""The port's ContinuousBatcher against the JAX reference batcher (CPU),
and port mirrors of the reference's serving tests.

Both batchers run the same request lists on the same fp32 weights
(bridged from the reference).  Admission traces, ``ServeStats``
summaries, telemetry summaries and every generated token must be
identical.  The reference runs under a test-local shim that copies numpy
arrays in its ``jnp.asarray``: on the CPU, JAX may alias the int32
``slot_pos`` array it is handed while the batcher bumps it in place
right after the launch (ROADMAP Queue 3, fault A).  The port passes
copies itself, so its mirror of
``test_refill_mid_prefill_neighbour_decode_unperturbed`` needs no shim.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import batcher as JB  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import batcher as TB  # noqa: E402

CPU = torch.device("cpu")


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies numpy inputs first."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kw)


@pytest.fixture
def copying_reference(monkeypatch):
    monkeypatch.setattr(JB, "jnp", _CopyingJnp())


def _trace(spec, seed):
    """[(rid, arrive, prompt_len, max_new, tenant)] → prompts from numpy."""
    rng = np.random.default_rng(seed)
    prompts = {rid: rng.integers(0, 128, size=n).tolist()
               for rid, _, n, _, _ in spec}
    return [(rid, arrive, prompts[rid], m, ten)
            for rid, arrive, _, m, ten in spec]


SPEC = [(0, 0, 2, 5, "a"), (1, 0, 9, 4, "b"), (2, 0, 5, 6, "a"),
        (3, 1, 13, 3, "b"), (4, 2, 3, 5, "a"), (5, 4, 7, 2, "b"),
        (6, 5, 1, 4, "a"), (7, 7, 11, 3, "b")]

CASES = {
    "dlbc": ("granite-moe-1b-a400m", "dlbc", None),
    "lc": ("qwen2.5-32b", "lc", None),
    "wdlbc": ("granite-moe-1b-a400m", "wdlbc", {"a": 3.0, "b": 1.0}),
}


def _run(mod, cfg, params, policy, tenants, trace, **kw):
    b = mod.ContinuousBatcher(cfg, params, n_slots=3, cache_len=32,
                              policy=policy, tenants=tenants,
                              prefill_chunk=4, **kw)
    reqs = [mod.Request(rid=r, prompt=list(p), max_new=m, arrive_step=t,
                        tenant=ten if tenants else "default")
            for r, t, p, m, ten in trace]
    b.run(reqs)
    return b, reqs


def _comparable_telemetry(summary: dict) -> dict:
    """Telemetry summary without wall-clock latency fields."""
    return {k: v for k, v in summary.items()
            if k not in ("p50_ms", "p99_ms", "latency_hist")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batcher_matches_reference(copying_reference, case):
    arch, policy, tenants = CASES[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True),
                               dtype="float32")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(jp, CPU)
    trace = _trace(SPEC, seed=1)
    jb, jreqs = _run(JB, cfg, jp, policy, tenants, trace)
    tb, treqs = _run(TB, tcfg, tp, policy, tenants, trace, device="cpu")
    assert tb.admissions == jb.admissions
    assert tb.stats.summary() == jb.stats.summary()
    assert {k: v.summary() for k, v in tb.tenant_stats.items()} \
        == {k: v.summary() for k, v in jb.tenant_stats.items()}
    assert _comparable_telemetry(tb.sched.telemetry.summary()) \
        == _comparable_telemetry(jb.sched.telemetry.summary())
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert tb.sched.telemetry.prefill_chunks > len(SPEC)  # chunking ran


def test_two_tenant_admission_golden():
    """Mirror of the reference's literal golden: weight 3 front-loads
    tenant "a", the a=2/b=2 tie breaks to registration order."""
    cfg = _dense_cfg()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    spec = [(0, 0, 3, "a"), (1, 0, 5, "b"), (2, 0, 4, "a"), (3, 1, 2, "b"),
            (4, 2, 6, "a"), (5, 4, 2, "b"), (6, 4, 3, "a"), (7, 7, 5, "b"),
            (8, 8, 2, "a"), (9, 8, 4, "b"), (10, 12, 3, "a"),
            (11, 12, 2, "b")]
    b = TB.ContinuousBatcher(cfg, params, n_slots=3, cache_len=16,
                             policy="wdlbc", tenants={"a": 3.0, "b": 1.0},
                             device="cpu")
    b.run([TB.Request(rid=r, prompt=[1, 2], max_new=m, arrive_step=t,
                      tenant=ten) for r, t, m, ten in spec])
    assert b.admissions[:6] == [
        (0, 0, 0, "a"), (0, 1, 2, "a"), (0, 2, 1, "b"),
        (3, 0, 4, "a"), (4, 1, 6, "a"), (5, 2, 3, "b"),
    ]
    assert b.sched.telemetry.spawns == b.sched.telemetry.joins == len(spec)


def test_serve_cli_prints_the_reference_schema(capsys):
    """``repro_torch.launch.serve`` prints the reference launcher's JSON
    keys (here on the CPU, with the SMOKE config)."""
    out = t_serve.main(["--arch", "qwen2.5-32b", "--smoke", "--requests",
                        "4", "--device", "cpu", "--dtype", "float32"])
    printed = capsys.readouterr().out
    assert printed.strip().startswith("{")
    assert set(out) == {"arch", "policy", "steps", "utilization",
                        "mean_latency_steps", "p99_latency_steps",
                        "mean_queue_wait", "sched"}
    assert out["sched"]["joins"] == out["sched"]["spawns"] == 4


# -- port mirrors of tests/test_prefill.py and test_serve_regression.py ------


def _dense_cfg(**kw):
    return TModelConfig(name="prefill-test", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab=128, dtype="float32", **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _dense_cfg()
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0),
                               device=CPU)


def _batcher(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", 32)
    return TB.ContinuousBatcher(cfg, params, device="cpu", **kw)


def test_refill_mid_prefill_neighbour_decode_unperturbed(setup):
    """A long-prompt request refilled next to a slot deep in decode does
    not perturb the neighbour, and its own tokens match its solo run."""
    cfg, params = setup
    long_prompt = np.random.default_rng(5).integers(0, cfg.vocab,
                                                    size=14).tolist()

    def steady():
        return TB.Request(rid=0, prompt=[7, 8, 9], max_new=12, arrive_step=0)

    def adversary():
        return TB.Request(rid=1, prompt=list(long_prompt), max_new=4,
                          arrive_step=4)

    solo_s, solo_a = steady(), adversary()
    _batcher(cfg, params, policy="dlbc", prefill_chunk=4).run([solo_s])
    _batcher(cfg, params, policy="dlbc", prefill_chunk=4).run([solo_a])
    s, a = steady(), adversary()
    both = _batcher(cfg, params, policy="dlbc", prefill_chunk=4)
    both.run([s, a])
    assert both.sched.telemetry.prefill_chunks >= 4
    assert s.tokens == solo_s.tokens
    assert a.tokens == solo_a.tokens


def test_refill_mid_decode_tokens_match_solo_run(setup):
    cfg, params = setup
    solo_req = TB.Request(rid=1, prompt=[7, 8, 9], max_new=8, arrive_step=4)
    _batcher(cfg, params, policy="dlbc").run([solo_req])
    late = TB.Request(rid=1, prompt=[7, 8, 9], max_new=8, arrive_step=4)
    long_req = TB.Request(rid=0, prompt=[1, 2], max_new=20, arrive_step=0)
    cont = _batcher(cfg, params, policy="dlbc")
    cont.run([long_req, late])
    assert cont.admissions[1][0] == 4
    assert late.tokens == solo_req.tokens


def test_submit_rejects_empty_prompt(setup):
    cfg, params = setup
    b = _batcher(cfg, params, cache_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit(TB.Request(rid=0, prompt=[], max_new=4))


def test_submit_rejects_out_of_vocab(setup):
    cfg, params = setup
    b = _batcher(cfg, params, cache_len=16)
    with pytest.raises(ValueError, match="outside"):
        b.submit(TB.Request(rid=0, prompt=[1, cfg.vocab], max_new=4))
    with pytest.raises(ValueError, match="outside"):
        b.submit(TB.Request(rid=1, prompt=[-1], max_new=4))


def test_submit_rejects_overlong_prompt(setup):
    cfg, params = setup
    b = _batcher(cfg, params, cache_len=16)
    with pytest.raises(ValueError, match="cannot fit"):
        b.submit(TB.Request(rid=0, prompt=list(range(17)), max_new=4))


def test_submit_rejects_windowed_multi_token_prompt():
    cfg = _dense_cfg(sliding_window=8)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    b = _batcher(cfg, params, cache_len=16)
    with pytest.raises(NotImplementedError, match="single-token"):
        b.submit(TB.Request(rid=0, prompt=[1, 2, 3], max_new=2))
    b.submit(TB.Request(rid=1, prompt=[1], max_new=2))


def test_recurrent_families_are_rejected():
    cfg = TModelConfig(name="serve-ssm", family="ssm", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab=128)
    with pytest.raises(NotImplementedError, match="recurrent"):
        TB.ContinuousBatcher(cfg, params={}, n_slots=2, cache_len=16,
                             device="cpu")


def test_truncated_counter_separates_cache_kills(setup):
    cfg, params = setup
    b = _batcher(cfg, params, cache_len=16, policy="dlbc")
    b.run([TB.Request(rid=0, prompt=[1, 2], max_new=500, arrive_step=0),
           TB.Request(rid=1, prompt=[3], max_new=2, arrive_step=0)])
    assert b.stats.truncated == 1
    assert len(b.stats.latencies) == 2
    assert b.stats.summary()["truncated"] == 1


def test_joins_count_requests_not_chunks(setup):
    cfg, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=13).tolist()
               for _ in range(3)]
    b = _batcher(cfg, params, policy="dlbc", prefill_chunk=4)
    b.run([TB.Request(rid=i, prompt=p, max_new=3, arrive_step=2 * i)
           for i, p in enumerate(prompts)])
    tele = b.sched.telemetry
    assert tele.spawns == tele.joins == 3
    assert tele.prefill_chunks >= 3 * 2
    assert tele.prefill_tokens == 3 * 12
    assert b.stats.summary()["n_done"] == 3


def test_decode_cost_accounting_charges_shared_prefill(setup):
    cfg, params = setup
    long_prompt = np.random.default_rng(13).integers(0, cfg.vocab,
                                                     size=25).tolist()

    def run(mode):
        reqs = [TB.Request(rid=0, prompt=[5, 6], max_new=30, arrive_step=0),
                TB.Request(rid=1, prompt=list(long_prompt), max_new=2,
                           arrive_step=3)]
        b = _batcher(cfg, params, cache_len=48, policy="dlbc",
                     prefill_chunk=6, prefill_mode=mode)
        b.run(reqs)
        return b, reqs
    chunked, creqs = run("chunked")
    whole, wreqs = run("whole")
    assert max(chunked.stats.decode_step_costs) <= 1 + chunked.prefill_chunk
    assert max(whole.stats.decode_step_costs) \
        > max(chunked.stats.decode_step_costs)
    assert [r.tokens for r in creqs] == [r.tokens for r in wreqs]
