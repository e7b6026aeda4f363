"""The port's MoE routing and dispatch against the JAX reference (CPU).

Weights come from the reference's ``moe_init`` through the bridge and
inputs from seeded numpy, in fp32.  Routing ids and the drop / spawn /
round counts must match exactly; outputs within 1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels.moe_dispatch import ops as JOPS  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.sched import ExpertCapacityProvider as JCap  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as TOPS  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.sched import ExpertCapacityProvider as TCap  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(t_get_config(arch, smoke=True), **kw))


def _params(cfg, seed=0):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, bridge.to_torch(jp, "cpu")


def _skewed_tokens(d, T=256, seed=1):
    """Tokens clustered around a few centres, so some experts overflow."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(8, d))
    return (np.repeat(base, T // 8, axis=0)
            + 0.05 * rng.normal(size=(T, d))).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    cfg, _ = _cfgs(arch)
    jp, tp = _params(cfg)
    x = np.random.default_rng(3).normal(size=(96, cfg.d_model)) \
        .astype(np.float32)
    jg, jids, jprobs = JMOE.route(jnp.asarray(x), jp["router"], cfg.top_k)
    tg, tids, tprobs = TMOE.route(torch.tensor(x), tp["router"], cfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=2e-5)


def test_route_ties_keep_lower_index_first():
    """Equal probabilities: the lower expert index comes first, as in
    ``jax.lax.top_k`` (pinned against the reference on constructed
    ties: a zero router makes every probability equal, and duplicated
    router columns make pairs of experts tie)."""
    d, E, K = 8, 6, 4
    router = np.zeros((d, E), np.float32)
    col = np.random.default_rng(0).normal(size=d).astype(np.float32)
    router[:, 1] = router[:, 4] = col
    router[:, 2] = router[:, 5] = 0.5 * col
    x = np.random.default_rng(1).normal(size=(16, d)).astype(np.float32)
    for r in (np.zeros_like(router), router):
        _, jids, _ = JMOE.route(jnp.asarray(x), jnp.asarray(r), K)
        _, tids, _ = TMOE.route(torch.tensor(x), torch.tensor(r), K)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _, tids, _ = TMOE.route(torch.tensor(x[:1]), torch.zeros(d, E), K)
    assert tids[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["lc", "dlbc"])
def test_moe_apply_matches_reference(arch, dispatch):
    cfg, tcfg = _cfgs(arch, moe_dispatch=dispatch, moe_capacity_factor=1.0)
    jp, tp = _params(cfg)
    x = _skewed_tokens(cfg.d_model)
    jy, js = JMOE.moe_apply(jp, cfg, jnp.asarray(x), return_stats=True)
    ty, ts = TMOE.moe_apply(tp, tcfg, torch.tensor(x), return_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    T, K = x.shape[0], cfg.top_k
    j_dropped = int(round(float(js["dropped_frac"]) * T * K))
    assert j_dropped > 0                      # the input does overflow
    assert int(round(float(ts["dropped_frac"]) * T * K)) == j_dropped
    assert int(ts["spawns"]) == int(js["spawns"])
    assert ts["rounds"] == js["rounds"] and ts["joins"] == js["joins"] == 1
    assert ts["total_slots"] == js["total_slots"]


def test_moe_matches_ref_when_capacity_ample():
    """Mirror of the reference test: with enough capacity both
    dispatchers equal the dense oracle."""
    _, tcfg = _cfgs("granite-moe-1b-a400m", moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    p = TMOE.moe_init(gen, tcfg, torch.float32)
    x = torch.randn(64, tcfg.d_model, generator=gen)
    ref = TMOE.moe_ref(p, tcfg, x)
    for dispatch in ("lc", "dlbc"):
        c = dataclasses.replace(tcfg, moe_dispatch=dispatch)
        y, stats = TMOE.moe_apply(p, c, x, return_stats=True)
        assert float(stats["dropped_frac"]) == 0.0
        torch.testing.assert_close(y, ref, atol=2e-4, rtol=2e-3)


def test_moe_ref_matches_reference():
    cfg, tcfg = _cfgs("mixtral-8x7b")
    jp, tp = _params(cfg, seed=2)
    x = np.random.default_rng(4).normal(size=(32, cfg.d_model)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        TMOE.moe_ref(tp, tcfg, torch.tensor(x)).numpy(),
        np.asarray(JMOE.moe_ref(jp, cfg, jnp.asarray(x))), atol=1e-4,
        rtol=1e-4)


def test_moe_dispatch_dlbc_drops_fewer():
    _, tcfg = _cfgs("mixtral-8x7b", moe_capacity_factor=1.0)
    p = TMOE.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.tensor(_skewed_tokens(tcfg.d_model, T=512))
    drops = {}
    for dispatch in ("lc", "dlbc"):
        c = dataclasses.replace(tcfg, moe_dispatch=dispatch)
        _, stats = TMOE.moe_apply(p, c, x, return_stats=True)
        drops[dispatch] = float(stats["dropped_frac"])
    assert drops["dlbc"] < drops["lc"]


def test_moe_kernel_dispatch_matches_einsum_path():
    """Mirror of the reference's adoption test: the grouped-FFN path
    (its plain version on the CPU) agrees with the einsum path."""
    _, tcfg = _cfgs("mixtral-8x7b", moe_dispatch="dlbc")
    assert tcfg.act == "swiglu"
    gen = torch.Generator().manual_seed(0)
    p = TMOE.moe_init(gen, tcfg, torch.float32)
    x = torch.randn(256, tcfg.d_model, generator=gen) * 0.5
    y_einsum = TMOE.moe_apply(p, tcfg, x, use_kernel=False)
    y_kernel = TMOE.moe_apply(p, tcfg, x, use_kernel=True)
    torch.testing.assert_close(y_einsum, y_kernel, atol=2e-4, rtol=2e-4)


def test_dispatch_tokens_dropped_pair_never_overwrites_kept_slot():
    """A dropped pair's clamped slot ids*C + C-1 coincides with a kept
    pair's slot: the kept token must survive (the reference adds a zero
    there; the port masks the dropped pair out)."""
    E, C, d = 2, 2, 4
    x = np.arange(1, 4 * d + 1, dtype=np.float32).reshape(4, d)
    ids = np.array([[0], [0], [0], [1]], np.int32)
    pos = np.array([[0], [1], [2], [0]], np.int32)   # token 2 overflows
    keep = pos < C
    jbuf, jslot = JOPS.dispatch_tokens(jnp.asarray(x), jnp.asarray(keep),
                                       jnp.asarray(ids), jnp.asarray(pos),
                                       E, C)
    tbuf, tslot = TOPS.dispatch_tokens(torch.tensor(x), torch.tensor(keep),
                                       torch.tensor(ids).long(),
                                       torch.tensor(pos).long(), E, C)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert tbuf[0, 1].tolist() == x[1].tolist()


@pytest.mark.parametrize("T,E,K,cf", [(1, 32, 8, 1.25), (8, 32, 8, 1.25),
                                      (256, 32, 8, 1.25), (255, 32, 8, 4.0),
                                      (512, 4, 2, 1.0), (7, 4, 2, 8.0)])
def test_capacity_matches_reference(T, E, K, cf):
    assert TMOE.capacity(T, E, K, cf) == JMOE.capacity(T, E, K, cf)


def test_capacity_provider_residual_and_overflow_match_reference():
    load = np.array([0, 3, 8, 9, 20], np.int64)
    j, t = JCap(5, 8), TCap(5, 8)
    np.testing.assert_array_equal(t.residual(torch.tensor(load)).numpy(),
                                  np.asarray(j.residual(jnp.asarray(load))))
    np.testing.assert_array_equal(t.overflow(torch.tensor(load)).numpy(),
                                  np.asarray(j.overflow(jnp.asarray(load))))
    assert t.total() == j.total() == 40


def test_expert_parallel_without_expert_axis_is_single_host():
    """(``tests/test_torch_ep.py`` and ``tests/test_torch_ep_train.py``
    hold the EP round.)  Without a mesh whose expert axis is larger than 1,
    a config that sets ``expert_parallel`` takes the single-host dispatch,
    as the reference's does: equal to the same config without it."""
    _, tcfg = _cfgs("granite-moe-1b-a400m", expert_parallel=True)
    p = TMOE.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(16, tcfg.d_model)).astype(np.float32))
    want = TMOE.moe_apply(p, dataclasses.replace(tcfg, expert_parallel=False),
                          x)
    assert torch.equal(TMOE.moe_apply(p, tcfg, x), want)


class _ThreadDP:
    """A data axis of ``size`` ranks in one process, one thread per rank
    (a stand-in for ``distributed.comm.Collectives``): ``all_gather``
    meets every rank's tensor at a barrier and counts its calls."""

    def __init__(self, rank, size, shared, barrier):
        self.rank, self.size = rank, size
        self.shared, self.barrier = shared, barrier
        self.counts = {"all_gather": 0}

    def all_gather(self, t):
        self.shared[self.rank] = t
        self.barrier.wait()
        out = torch.cat([self.shared[r] for r in range(self.size)])
        self.barrier.wait()
        self.counts["all_gather"] += 1
        return out


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["lc", "dlbc"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_data_parallel_matches_whole_batch(arch, dispatch, cf):
    """Fault M: 2 data ranks, each with its half of a skewed batch whose
    experts overflow, give the reference's result on the whole batch
    (within 1e-4) and its drop and spawn counts exactly, from one
    all-gather of pair counts (``lc``) or two (``dlbc``); the whole
    batch's rows cut per rank, as the train step cuts them."""
    import threading

    jc, tc = _cfgs(arch, moe_dispatch=dispatch, moe_capacity_factor=cf)
    jp, tp = _params(jc)
    x = _skewed_tokens(jc.d_model)
    want, jst = JMOE.moe_apply(jp, jc, jnp.asarray(x), return_stats=True)
    # round 1 overflows (dlbc at 1.25 re-admits every pair in round 2)
    _, lst = JMOE.moe_apply(jp, dataclasses.replace(jc, moe_dispatch="lc"),
                            jnp.asarray(x), return_stats=True)
    assert float(lst["dropped_frac"]) > 0
    D, n = 2, x.shape[0] // 2
    shared, barrier, got = {}, threading.Barrier(D, timeout=60), {}

    def rank(r):
        dp = _ThreadDP(r, D, shared, barrier)
        y, st = TMOE.moe_apply(tp, tc, torch.tensor(x[r * n:(r + 1) * n]),
                               return_stats=True, use_kernel=False, dp=dp)
        got[r] = (y, st, dp.counts["all_gather"])

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(D)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(got) == D
    y = torch.cat([got[r][0] for r in range(D)])
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4)
    for r in range(D):
        _, st, gathers = got[r]
        assert gathers == (1 if dispatch == "lc" else 2)
        assert int(st["spawns"]) == int(jst["spawns"])
        assert float(st["dropped_frac"]) == pytest.approx(
            float(jst["dropped_frac"]), abs=1e-7)
        assert st["total_slots"] == jst["total_slots"]
