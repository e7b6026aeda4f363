"""The port's verbatim copy of ``repro.core`` (the async-finish IR, the
AFE/LC/DLBC transforms, the runtime simulator, the RTP kernels) against
the reference package.

* Fig. 10 (``benchmarks/bench_fig10_counts.py``): for every RTP kernel
  × ``UnOpt LC DCAFE`` at the test scale, ``repro_torch.core.run_scheme``
  gives the reference's ``finishes``, ``asyncs``, time and ``ok``.
* The unit tests of ``tests/test_ir_transforms.py``,
  ``tests/test_runtime_sim.py`` and ``tests/test_schemes.py``, run
  against the copy: each file's source with ``repro.core`` read as
  ``repro_torch.core``, every test (and every parametrised case) one
  test here, named ``test_<file>__<test>``.
* ``tests/test_afe_property.py``'s semantics property on programs that
  are race-free by construction: the ``if`` guards read ``flag``, which
  no statement writes.  The reference's generator lets a guard read
  ``g0`` while an unjoined async may still bump it — the race behind its
  red ``[AFE]`` and ``[DCAFE]`` cases (``main = async { finish { g0 += 1
  } }; rec(2)`` with ``rec = if (g0 >= 1) g0 += 1 else g0 += 2``: the
  source gives 3, AFE 2, both legal schedules), where exact heap equality
  is no oracle.  ``derandomize=True`` makes every run draw the same
  programs, so the count of passing cases is fixed.
"""

from pathlib import Path

import pytest

from repro.core import build_kernel as ref_build_kernel
from repro.core import run_scheme as ref_run_scheme
from repro_torch.core import build_kernel, run_scheme

HERE = Path(__file__).resolve().parent
KERNELS = ["BFS", "BY", "DR", "DST", "MST", "NQ", "HL", "FL"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("scheme", ["UnOpt", "LC", "DCAFE"])
def test_fig10_counts_match_reference(kernel, scheme):
    want = ref_run_scheme(ref_build_kernel(kernel, "test"), scheme,
                          workers=8)
    got = run_scheme(build_kernel(kernel, "test"), scheme, workers=8)
    assert (got.finishes, got.asyncs, got.time, got.ok) == \
        (want.finishes, want.asyncs, want.time, want.ok)
    assert got.ok


def _mirror(stem: str) -> dict:
    """The reference test file ``stem``'s tests, importing the copy."""
    src = (HERE / f"{stem}.py").read_text().replace(
        "repro.core", "repro_torch.core")
    ns = {"__name__": f"{__name__}.{stem}"}
    exec(compile(src, str(HERE / f"{stem}.py"), "exec"), ns)
    return {f"test_{stem[5:]}__{k[5:]}": v for k, v in ns.items()
            if k.startswith("test_") and callable(v)}


for _stem in ("test_ir_transforms", "test_runtime_sim", "test_schemes"):
    globals().update(_mirror(_stem))


# ---------------------------------------------------------------------------
# The AFE property on race-free programs
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

from repro_torch.core.afe import apply_afe  # noqa: E402
from repro_torch.core.dlbc import apply_dcafe, apply_dlbc  # noqa: E402
from repro_torch.core.ir import (  # noqa: E402
    Async, Call, Compute, Finish, ForLoop, If, MethodDef, Program, binop,
    const, expr, seq, var,
)
from repro_torch.core.lc import apply_lc  # noqa: E402
from repro_torch.core.runtime import run_program  # noqa: E402

HEAP_VARS = ("g0", "g1", "g2")


def bump(name, amount):
    return Compute(
        fn=lambda env, _n=name, _a=amount: env.set_heap(_n, env[_n] + _a),
        reads=frozenset({f"{name}[+]"}), writes=frozenset({f"{name}[+]"}),
        cost=0.3, label=f"{name}+={amount}")


@st.composite
def stmt_strategy(draw, depth, allow_call):
    """The reference's statement generator, with ``if`` guards on the
    never-written ``flag`` instead of ``g0``."""
    choices = ["bump", "seq", "async", "finish"]
    if depth > 0:
        choices += ["loop", "if", "finish_async"]
    if allow_call:
        choices += ["call", "call"]
    kind = draw(st.sampled_from(choices))
    if kind == "bump" or depth <= 0:
        return bump(draw(st.sampled_from(HEAP_VARS)),
                    draw(st.integers(1, 3)))
    sub = lambda: draw(stmt_strategy(depth=depth - 1,  # noqa: E731
                                     allow_call=allow_call))
    if kind == "seq":
        return seq(sub(), sub())
    if kind == "async":
        return Async(body=sub())
    if kind == "finish":
        return Finish(body=sub())
    if kind == "finish_async":
        return Finish(body=Async(body=sub()))
    if kind == "loop":
        return ForLoop(loopvar=f"i{depth}", lo=const(0),
                       hi=const(draw(st.integers(1, 3))), step=const(1),
                       body=sub())
    if kind == "if":
        thr = draw(st.integers(0, 2))
        return If(
            cond=expr(lambda env, _t=thr: env["flag"] >= _t, "flag",
                      label=f"flag>={thr}"),
            then=sub(), els=sub())
    if kind == "call":
        return If(
            cond=expr(lambda env: env["d"] > 0, "d", label="d>0"),
            then=Call(callee="rec",
                      args=(binop("-", var("d"), const(1)),)),
        )
    raise AssertionError(kind)


@st.composite
def program_strategy(draw):
    main_body = draw(stmt_strategy(depth=3, allow_call=False))
    rec_body = draw(stmt_strategy(depth=2, allow_call=True))
    rec = MethodDef(name="rec", params=("d",), body=rec_body)
    main = MethodDef(
        name="main", params=(),
        body=seq(main_body, Call(callee="rec", args=(const(2),))))
    return Program(methods=(main, rec))


def fresh_heap():
    return {"g0": 0, "g1": 0, "g2": 0, "flag": 1}


SCHEMES = {
    "AFE": lambda p: apply_afe(p)[0],
    "LC": apply_lc,
    "DLBC": apply_dlbc,
    "DCAFE": lambda p: apply_dcafe(p)[0],
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(prog=program_strategy(), workers=st.sampled_from([1, 3]))
def test_scheme_preserves_semantics_race_free(scheme, prog, workers):
    base = run_program(prog, n_workers=workers, heap=fresh_heap(),
                       max_events=2_000_000)
    assert base.ok, base.error
    out = run_program(SCHEMES[scheme](prog), n_workers=workers,
                      heap=fresh_heap(), max_events=2_000_000)
    assert out.ok, out.error
    for k in HEAP_VARS:
        assert out.heap[k] == base.heap[k], (scheme, k)


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(prog=program_strategy())
def test_afe_halts_and_is_idempotent_on_counts(prog):
    p1, _ = apply_afe(prog)
    p2, _ = apply_afe(p1)
    r1 = run_program(p1, n_workers=2, heap=fresh_heap(),
                     max_events=2_000_000)
    r2 = run_program(p2, n_workers=2, heap=fresh_heap(),
                     max_events=2_000_000)
    assert r1.ok and r2.ok
    for k in HEAP_VARS:
        assert r1.heap[k] == r2.heap[k]
