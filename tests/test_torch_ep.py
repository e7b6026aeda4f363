"""The port's expert-parallel dispatch (``repro_torch.ep``) on the CPU.

* **Plan** — ``tests/test_ep.py``'s host-side ``plan_exchange`` /
  ``lane_capacity`` tests, run against the port's verbatim copy of
  ``repro.ep.plan`` (the file's source with ``repro.ep.plan`` and
  ``repro.sched`` read as the port's), and the capacity provider's
  residual/overflow split on torch tensors.
* **EP round, 2 gloo ranks** — one module-scoped subprocess spawns two
  ranks (a ``file://`` store under the test's temporary directory) on an
  ``(expert 2, data 1, model 1)`` mesh at granite-moe SMOKE widths, fp32,
  weights and tokens from seeded numpy.  It holds the round to the
  properties the reference's ``test_ep.py`` states (red here, ROADMAP
  Queue 3 B: the reference's ``shard_map(..., check_rep=...)`` is
  refused by jax 0.9, so its EP round cannot run and the port's is held
  to those properties and to the single-host path instead): EP equal to
  the single-host dispatch below 1e-5, token-ordered and sorted; the
  ``ppermute`` ring equal to ``all_to_all`` below 1e-6; one join per
  round; ``sent == received == spawns == T·K`` at ample capacity; a hot
  router reassigning before the collective with ``spawns + dropped ==
  T·K``; a lost shard degrading the round without aborting it.
* **Single host** — the port's ``moe_apply`` against the reference's on
  the same bridged weights.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.sched import ExpertCapacityProvider  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
T, K = 64, 2


def _mirror_plan_tests() -> dict:
    src = (HERE / "test_ep.py").read_text() \
        .replace("from repro.ep.plan", "from repro_torch.ep.plan") \
        .replace("from repro.sched", "from repro_torch.sched")
    ns = {"__name__": f"{__name__}.test_ep"}
    exec(compile(src, str(HERE / "test_ep.py"), "exec"), ns)
    names = ("test_plan_exchange_reassigns_before_dropping",
             "test_plan_exchange_drops_only_above_total_capacity",
             "test_plan_exchange_zero_capacity_drops_everything",
             "test_lane_capacity_holds_balanced_load",
             "test_plan_exchange_conservation_property")
    return {f"test_ep__{n[5:]}": ns[n] for n in names}


globals().update(_mirror_plan_tests())


def test_capacity_residual_clamps_and_overflow_exposes_drop():
    cap = ExpertCapacityProvider(n_experts=4, slots_per_expert=8)
    load = torch.tensor([20, 8, 12, 5])
    assert int(load.sum()) > cap.total()
    assert cap.residual(load).tolist() == [0, 0, 0, 3]
    assert cap.overflow(load).tolist() == [12, 0, 4, 0]
    assert (torch.clamp(load, max=8) + cap.overflow(load)).tolist() == \
        load.tolist()


def test_token_shards_and_expert_axis():
    """How many ways the EP path shards a call: the expert axis's size
    when it is larger than 1 and divides both T and E, else None."""
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.ep import has_expert_axis, token_shards

    mesh = MeshShape(("expert", "data", "model"), (4, 1, 1))
    assert has_expert_axis(mesh) and token_shards(64, 8, mesh) == 4
    assert token_shards(62, 8, mesh) is None     # T not divisible
    assert token_shards(64, 6, mesh) is None     # E not divisible
    one = MeshShape(("expert", "data", "model"), (1, 1, 1))
    assert token_shards(64, 8, one) is None
    plain = MeshShape(("data", "model"), (2, 1))
    assert not has_expert_axis(plain) and not has_expert_axis(None)
    assert token_shards(64, 8, plain) is None


# ---------------------------------------------------------------------------
# The EP round on 2 gloo ranks (one subprocess for the module)
# ---------------------------------------------------------------------------

SCRIPT = textwrap.dedent("""
    import dataclasses, json, queue, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    T, K, WORLD = 64, 2, 2


    def weights(cfg, seed):
        rng = np.random.default_rng(seed)
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        w = lambda *s: torch.tensor(
            (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32))
        return {"router": w(d, E), "w1": w(E, d, f), "w3": w(E, d, f),
                "w2": w(E, f, d)}


    def tokens(cfg, n, seed):
        return torch.tensor(np.random.default_rng(seed).normal(
            size=(n, cfg.d_model)).astype(np.float32))


    def run(rank):
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import mesh_context
        from repro_torch.ep.dispatch import ep_dispatch_combine, ep_round
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import moe as MOE
        from repro_torch.sched import SchedTelemetry
        from repro_torch.sched.faults import (
            FaultPlan, FaultSpec, injected_faults)

        stats = lambda st: {k: float(v) for k, v in st.items()}
        # ample capacity: no admission differences, outputs must agree
        cfg = dataclasses.replace(
            get_config("granite-moe-1b-a400m", smoke=True),
            dtype="float32", moe_capacity_factor=8.0, expert_parallel=True)
        host = dataclasses.replace(cfg, expert_parallel=False)
        p, x = weights(cfg, 0), tokens(cfg, T, 1)
        y_ref = MOE.moe_apply(p, host, x)
        out = {}
        mesh = make_test_mesh(data=1, model=1, expert=WORLD,
                              device_type="cpu")
        with mesh_context(mesh):
            y_ep, st = MOE.moe_apply(p, cfg, x, return_stats=True)
            y_pp = ep_dispatch_combine(p, cfg, x, mesh=mesh,
                                       impl="ppermute")
            tel = SchedTelemetry()
            _, st_rd = ep_round(p, cfg, x, mesh=mesh, telemetry=tel)
            # a token count the expert axis does not divide: zero-padded
            x_odd = x[:T - 1]
            y_odd, st_odd = MOE.moe_apply(p, cfg, x_odd, return_stats=True)
        out["max_diff"] = float((y_ep - y_ref).abs().max())
        out["sorted_diff"] = float((torch.sort(y_ep, dim=0).values -
                                    torch.sort(y_ref, dim=0).values)
                                   .abs().max())
        out["ppermute_diff"] = float((y_pp - y_ep).abs().max())
        out["odd_diff"] = float(
            (y_odd - MOE.moe_apply(p, host, x_odd)).abs().max())
        out["odd_padded"] = int(st_odd["padded_tokens"])
        out["stats"], out["round"] = stats(st), stats(st_rd)
        out["telemetry"] = dict(joins=tel.joins, spawns=tel.spawns,
                                exchange=tel.exchange.summary())

        # hot expert at capacity factor 1: the overflowing lane's pairs
        # are reassigned to the other shard before the collective
        cfg_hot = dataclasses.replace(cfg, moe_capacity_factor=1.0)
        p_hot = dict(p, router=p["router"].clone())
        p_hot["router"][:, 0] += 4.0
        with mesh_context(mesh):
            _, sth = MOE.moe_apply(p_hot, cfg_hot, tokens(cfg, 2 * T, 3),
                                   return_stats=True)
        out["hot"] = stats(sth)

        # shard loss: losing shard 1 closes its lanes; the round retries
        # once with its traffic rerouted to the live shard (every rank
        # runs the same seeded plan, so every rank sees the loss)
        plan = FaultPlan([FaultSpec(site="ep.round", kind="shard_loss",
                                    every=1, shard=1, max_injections=1)],
                         seed=0)
        tel_d = SchedTelemetry()
        with mesh_context(mesh), injected_faults(plan):
            y_d, st_d = ep_round(p, cfg, x, mesh=mesh, telemetry=tel_d)
        out["degraded"] = {
            "stats": stats(st_d), "retries": tel_d.retries,
            "joins": tel_d.joins, "exchange": tel_d.exchange.summary(),
            "finite": bool(torch.isfinite(y_d).all())}
        return out


    def worker(rank, store, q):
        try:
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=WORLD)
            q.put((rank, run(rank)))
        except BaseException:
            q.put((rank, {"error": traceback.format_exc()}))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=worker, args=(r, sys.argv[1], q))
                 for r in range(WORLD)]
        for pr in procs:
            pr.start()
        got = {}
        try:
            while len(got) < WORLD:
                r, res = q.get(timeout=240)
                got[r] = res
                if "error" in res:
                    break
        finally:
            for pr in procs:
                pr.join(10)
                if pr.is_alive():
                    pr.kill()
        errors = [res["error"] for res in got.values() if "error" in res]
        if errors:
            sys.exit("".join(errors))
        print("RESULT " + json.dumps(got))
""")


@pytest.fixture(scope="module")
def ep_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_ranks")
    script = tmp / "ep_ranks.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(tmp / "store")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError("no RESULT line:\n" + out.stdout)


@pytest.mark.parametrize("rank", ["0", "1"])
def test_ep_matches_single_host_dispatch(ep_results, rank):
    r = ep_results[rank]
    assert r["max_diff"] < 1e-5 and r["sorted_diff"] < 1e-5
    # a token count the axis does not divide: padded, sliced back, equal
    assert r["odd_padded"] == 1 and r["odd_diff"] < 1e-5


def test_ep_ppermute_matches_all_to_all(ep_results):
    for r in ep_results.values():
        assert r["ppermute_diff"] < 1e-6


def test_ep_single_join_per_round(ep_results):
    for r in ep_results.values():
        st, tel = r["stats"], r["telemetry"]
        assert st["joins"] == 1 and st["rounds"] == 1
        assert tel["joins"] == 1 and tel["exchange"]["rounds"] == 1
        assert tel["exchange"]["sent"] == tel["exchange"]["received"]
        assert tel["spawns"] == r["round"]["spawns"]


def test_ep_stats_conservation(ep_results):
    # ample capacity: every (token, choice) pair admitted, none dropped
    for r in ep_results.values():
        st = r["stats"]
        assert st["dropped_frac"] == 0.0 and st["n_shards"] == 2
        assert st["sent"] == st["received"] == st["spawns"] == T * K


def test_ep_hot_router_reassigns_under_pressure(ep_results):
    hot = ep_results["0"]["hot"]
    assert hot["reassigned"] > 0          # DLBC moved overflow pre-collective
    assert hot["sent"] == hot["received"]
    assert hot["spawns"] + hot["dropped"] == 2 * T * K


def test_ep_shard_loss_degrades_not_aborts(ep_results):
    """A lost shard degrades the round (lanes rerouted pre-collective), it
    does not abort it: one retry, one join, posted == completed, the
    degraded flag set, and with ample capacity nothing drops (the dead
    shard's pairs are served by experts of the live shard)."""
    for r in ep_results.values():
        d = r["degraded"]
        st, ex = d["stats"], d["exchange"]
        assert st["degraded"] == 1 and st["dead_shards"] == 1
        assert st["reassigned"] > 0 and st["dropped"] == 0
        assert d["retries"] == 1 and d["joins"] == 1
        assert ex["degraded_rounds"] == 1
        assert ex["posted"] == ex["completed"] == 1
        assert d["finite"]


@pytest.mark.parametrize("dispatch", ["lc", "dlbc"])
def test_single_host_moe_matches_reference(dispatch):
    """The port's single-host path (the one EP is held to above) against
    the reference's ``moe_apply`` on the same bridged weights, fp32."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              moe_capacity_factor=8.0, moe_dispatch=dispatch)
    tcfg = dataclasses.replace(
        t_get_config("granite-moe-1b-a400m", smoke=True),
        moe_capacity_factor=8.0, moe_dispatch=dispatch)
    jp = JMOE.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=(T, cfg.d_model)) \
        .astype(np.float32)
    want, jst = JMOE.moe_apply(jp, cfg, jnp.asarray(x), return_stats=True)
    got, tst = TMOE.moe_apply(bridge.to_torch(jp, "cpu"), tcfg,
                              torch.tensor(x), return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert int(tst["spawns"]) == int(jst["spawns"]) == T * K
