"""The DCAFE mini-transformations (paper Figs. 2, 4, 8 and 9).

Each rule is a function ``rule(stmt, ctx) -> Stmt | None`` that matches at a
single node, checks the paper's preconditions, and returns the transformed
node (or ``None`` when it does not apply).  :func:`rewrite_fixpoint` applies
the rule set bottom-up to a fixpoint — the paper notes the rules may be
applied in any order; we use a fixed deterministic order for reproducibility.

Exception handling: when ``ctx.exceptions_possible`` finds a statement that
may throw, the exception-extended variants of Figs. 8/9 are generated
(pending-exception lists carried on ``Finish.exlist``, ME re-wrapping for
tail elimination, try-guards for expansion rules).  When nothing can throw,
the plain Fig. 2/4 forms are produced.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from .analysis import (
    Summaries, depends_on_easyncs, loop_carried_dependence, stmt_reads,
    stmt_writes,
)
from .errors import ExcValue, make_me
from .ir import (
    Assign, Async, Barrier, Break, Call, Compute, Continue, Expr, Finish,
    ForLoop, If, Seq, Skip, Stmt, Throw, TryCatch, While, children, const,
    expr, fresh, rebuild, seq, var, walk,
)

# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    summaries: Summaries
    assume_no_exceptions: bool = False
    stats: dict = field(default_factory=dict)
    # Names bound method/task-locally in the method under rewrite —
    # by-value captured, so excluded from cross-task dependence checks.
    private: frozenset = frozenset()

    def bump(self, rule: str):
        self.stats[rule] = self.stats.get(rule, 0) + 1

    def may_throw(self, s: Stmt) -> bool:
        if self.assume_no_exceptions:
            return False
        return self.summaries.stmt_may_throw(s)

    def escaping(self, s: Stmt):
        return self.summaries.stmt_escaping_effects(s)


# ---------------------------------------------------------------------------
# Small codegen helpers (exception plumbing)
# ---------------------------------------------------------------------------


def assign_null(v: str) -> Stmt:
    return Assign(target=v, value=const(None), declare_local=True)


def catch_into(body: Stmt, v: str, types: tuple = ("Exception",)) -> Stmt:
    """``try { body } catch(e1:types) { v = e1 }``"""
    e1 = fresh("e")
    return TryCatch(
        body=body,
        exc_var=e1,
        handler=Assign(target=v, value=var(e1)),
        exc_types=types,
    )


def if_null(v: str, then: Stmt, els: Stmt = Skip()) -> Stmt:
    return If(
        cond=expr(lambda env, _v=v: env[_v] is None, v, label=f"{v}==null"),
        then=then,
        els=els,
    )


def throw_var(v: str) -> Stmt:
    return Compute(
        fn=lambda env, _v=v: env.rethrow(env[_v]),
        reads=frozenset({v}),
        writes=frozenset(),
        cost=0.0,
        label=f"throw {v}",
    )


def throw_me_of(v: str) -> Stmt:
    """``throw new ME(v)`` — rewrap an exception value (Fig. 9 #3, Fig. 8 #5)."""
    return Compute(
        fn=lambda env, _v=v: env.rethrow(make_me(env[_v])),
        reads=frozenset({v}),
        writes=frozenset(),
        cost=0.0,
        label=f"throw ME({v})",
    )


def exlist_guard(exlist: tuple, sink: str) -> Stmt:
    """``try { exlist } catch(e1) { sink = e1 }`` with short-circuit.

    Evaluates the pending-exception checks; the first pending exception is
    captured into ``sink`` instead of being thrown.
    """
    checks = []
    for v in exlist:
        checks.append(
            If(
                cond=expr(
                    lambda env, _v=v, _s=sink: env[_v] is not None
                    and env[_s] is None,
                    v,
                    sink,
                    label=f"{v}!=null&&{sink}==null",
                ),
                then=Assign(target=sink, value=var(v)),
            )
        )
    return seq(*checks)


def all_null_cond(names: tuple) -> Expr:
    return expr(
        lambda env, _ns=tuple(names): all(env[n] is None for n in _ns),
        *names,
        label="&&".join(f"{n}==null" for n in names) or "true",
    )


# ---------------------------------------------------------------------------
# Rule 1 (Fig. 2): Loop-Finish Interchange
# ---------------------------------------------------------------------------


def loop_finish_interchange(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """``for(...) { finish S3 }  ⇒  finish { for(...) { S3 } }``"""
    if not (isinstance(s, ForLoop) and isinstance(s.body, Finish)):
        return None
    inner: Finish = s.body
    eff = ctx.escaping(inner.body)
    if not eff.escapes:
        return None  # nothing to gain, and Finish Elimination handles it
    # Precondition: loop condition must not depend on e-asyncs; no
    # loop-carried dependence through the e-asyncs.
    if loop_carried_dependence(s, ctx.summaries, ctx.private):
        return None
    from .analysis import drop_private
    from .ir import sets_conflict

    bound_reads = drop_private(s.lo.reads | s.hi.reads | s.step.reads,
                               ctx.private)
    if sets_conflict(drop_private(eff.writes, ctx.private), bound_reads):
        return None
    if not ctx.may_throw(inner.body) and not inner.exlist:
        ctx.bump("loop_finish_interchange")
        return Finish(body=replace(s, body=inner.body))
    # Exception-extended variant (Fig. 9 #1).  Loop bounds here are pure, so
    # only S3/exlist can throw synchronously.
    if eff.may_throw:
        return None  # precondition: e-asyncs do not throw
    me = fresh("me")
    e = fresh("e")
    # Build:  try { S3 } catch(ex) { me = ME(ex); break }  ; exlist-guard→e,break
    ex = fresh("ex")
    loop_body = seq(
        TryCatch(
            body=inner.body,
            exc_var=ex,
            handler=seq(
                Assign(
                    target=me,
                    value=expr(
                        lambda env, _x=ex: make_me(env[_x]), ex, label=f"ME({ex})"
                    ),
                ),
                Break(),
            ),
        ),
        exlist_guard(inner.exlist, e),
        If(
            cond=expr(lambda env, _e=e: env[_e] is not None, e, label=f"{e}!=null"),
            then=Break(),
        ),
    )
    ctx.bump("loop_finish_interchange_exc")
    return seq(
        assign_null(me),
        assign_null(e),
        Finish(body=replace(s, body=loop_body)),
        If(
            cond=expr(lambda env, _e=e: env[_e] is not None, e, label=f"{e}!=null"),
            then=throw_var(e),
        ),
        If(
            cond=expr(lambda env, _m=me: env[_m] is not None, me, label=f"{me}!=null"),
            then=throw_var(me),
        ),
    )


# ---------------------------------------------------------------------------
# Rule 2 (Fig. 2): Finish Fusion — applied to adjacent Seq elements
# ---------------------------------------------------------------------------


def finish_fusion_pair(a: Finish, b: Finish, ctx: Ctx) -> Optional[Stmt]:
    effA = ctx.escaping(a.body)
    if depends_on_easyncs(b.body, effA.reads, effA.writes, ctx.summaries,
                          private=ctx.private):
        return None
    clean = (
        not ctx.may_throw(a.body)
        and not ctx.may_throw(b.body)
        and not a.exlist
        and not effA.may_throw
    )
    if clean:
        ctx.bump("finish_fusion")
        return Finish(body=seq(a.body, b.body), exlist=b.exlist)
    # Exception-extended (Fig. 9 #2): S2 runs only if exlist1 is clean; the
    # pending exceptions of S1 remain pending after the fused finish.
    effB = ctx.escaping(b.body)
    if effA.may_throw or effB.may_throw:
        return None  # precondition: e-asyncs of S1 and S2 do not throw
    guard = If(cond=all_null_cond(a.exlist), then=b.body) if a.exlist else b.body
    ctx.bump("finish_fusion_exc")
    return Finish(body=seq(a.body, guard), exlist=a.exlist + b.exlist)


# ---------------------------------------------------------------------------
# Rule 3 (Fig. 2): Tail Finish Elimination
# ---------------------------------------------------------------------------


def tail_finish_elimination(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """``finish { finish S1 }  ⇒  finish S1`` (+ ME rewrap when throwing)."""
    if not isinstance(s, Finish):
        return None
    inner = s.body
    if isinstance(inner, Seq) and len(inner.stmts) == 1:
        inner = inner.stmts[0]
    if not isinstance(inner, Finish):
        return None
    if not ctx.may_throw(inner) and not inner.exlist:
        ctx.bump("tail_finish_elimination")
        return Finish(body=inner.body, exlist=s.exlist)
    # Fig. 9 #3: keep the double ME-wrapping the nested finish produced.
    e = fresh("e")
    from .ir import lower_pending

    inner_lowered = lower_pending(inner)
    ctx.bump("tail_finish_elimination_exc")
    return Finish(
        body=TryCatch(
            body=inner_lowered,
            exc_var=e,
            handler=throw_me_of(e),
            exc_types=("Exception",),
        ),
        exlist=s.exlist,
    )


# ---------------------------------------------------------------------------
# Rule 4 (Fig. 4 #1 / Fig. 8 #1): Finish-If Interchange
# ---------------------------------------------------------------------------


def finish_if_interchange(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    if not isinstance(s, If):
        return None
    then_f = s.then if isinstance(s.then, Finish) else None
    els_f = s.els if isinstance(s.els, Finish) else None
    if then_f is None and els_f is None:
        return None
    if s.cond.intrinsic:
        return None  # hoisting an intrinsic read changes its sample point

    def branch_ok(branch: Stmt) -> bool:
        """A non-finish branch may be pulled inside the new finish when its
        escaping asyncs are unclocked (early join is a legal strengthening
        in the async-finish model) and it cannot throw (the finish would
        re-wrap the exception as ME)."""
        if isinstance(branch, (Break, Continue)):
            return False
        if ctx.escaping(branch).clocked:
            return False
        if ctx.may_throw(branch):
            return False
        return True

    if then_f is None and not branch_ok(s.then):
        return None
    if els_f is None and not branch_ok(s.els):
        return None
    v = fresh("c")
    new_then = then_f.body if then_f else s.then
    new_els = els_f.body if els_f else s.els
    exlist = (then_f.exlist if then_f else ()) + (els_f.exlist if els_f else ())
    ctx.bump("finish_if_interchange")
    return seq(
        Assign(target=v, value=s.cond, declare_local=True),
        Finish(body=If(cond=var(v), then=new_then, els=new_els), exlist=exlist),
    )


# ---------------------------------------------------------------------------
# Rule 5 (Fig. 4 #2 / Fig. 8 #2): Finish Expansion Upper
# ---------------------------------------------------------------------------


def _bad_stmt_to_absorb(s: Stmt) -> bool:
    return isinstance(s, (Break, Continue))


def finish_expansion_upper(s1: Stmt, f: Finish, ctx: Ctx) -> Optional[Stmt]:
    """``S1; finish{S2}  ⇒  finish{S1; S2}`` — S1 has no clocked e-asyncs."""
    if _bad_stmt_to_absorb(s1) or isinstance(s1, Finish):
        return None
    eff1 = ctx.escaping(s1)
    if eff1.clocked:
        return None
    if not ctx.may_throw(s1):
        ctx.bump("finish_expansion_upper")
        return Finish(body=seq(s1, f.body), exlist=f.exlist)
    if eff1.may_throw:
        return None  # precondition (Fig. 8 #2): e-asyncs in S1 do not throw
    e = fresh("e")
    ctx.bump("finish_expansion_upper_exc")
    return seq(
        assign_null(e),
        Finish(
            body=seq(catch_into(s1, e), if_null(e, f.body)),
            exlist=(e,) + f.exlist,
        ),
    )


# ---------------------------------------------------------------------------
# Rule 6 (Fig. 4 #3 / Fig. 8 #3): Finish Expansion Lower
# ---------------------------------------------------------------------------


def finish_expansion_lower(f: Finish, s2: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """``finish{S1}; S2  ⇒  finish{S1; S2}``"""
    if _bad_stmt_to_absorb(s2) or isinstance(s2, Finish):
        return None
    eff1 = ctx.escaping(f.body)
    if depends_on_easyncs(s2, eff1.reads, eff1.writes, ctx.summaries,
                          private=ctx.private):
        return None
    if ctx.summaries.stmt_has_barrier(s2):
        return None
    eff2 = ctx.escaping(s2)
    if eff2.clocked:
        return None
    if not ctx.may_throw(s2) and not f.exlist and not eff1.may_throw:
        ctx.bump("finish_expansion_lower")
        return Finish(body=seq(f.body, s2), exlist=())
    if eff1.may_throw or eff2.may_throw:
        return None  # precondition: e-asyncs of S1 and S2 do not throw
    e = fresh("e")
    ctx.bump("finish_expansion_lower_exc")
    return seq(
        assign_null(e),
        Finish(
            body=seq(
                f.body,
                exlist_guard(f.exlist, e),
                if_null(e, catch_into(s2, e)),
            ),
            exlist=(e,),
        ),
    )


# ---------------------------------------------------------------------------
# Rule 7 (Fig. 4 #4 / Fig. 8 #4): Async-Finish Interchange
# ---------------------------------------------------------------------------


def async_finish_interchange(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """``async { finish S1 }  ⇒  finish { async S1 }``"""
    if not isinstance(s, Async):
        return None
    inner = s.body
    if isinstance(inner, Seq) and len(inner.stmts) == 1:
        inner = inner.stmts[0]
    if not isinstance(inner, Finish):
        return None
    if inner.exlist:
        return None  # Fig. 8 #4: requires no pending exceptions
    if ctx.may_throw(inner.body) or ctx.escaping(inner.body).may_throw:
        if not ctx.assume_no_exceptions:
            return None  # precondition: S1 throws no exceptions
    ctx.bump("async_finish_interchange")
    return Finish(body=Async(body=inner.body, clocks=s.clocks))


# ---------------------------------------------------------------------------
# Rule 8 (Fig. 8 #5): Try-Finish Exchange
# ---------------------------------------------------------------------------


def try_finish_exchange(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """``try { finish{S1}<ex> } catch(e:Ex){ S2 }``  ⇒  hoisted form."""
    if not isinstance(s, TryCatch):
        return None
    inner = s.body
    if isinstance(inner, Seq) and len(inner.stmts) == 1:
        inner = inner.stmts[0]
    if not isinstance(inner, Finish):
        return None
    if ctx.escaping(inner.body).may_throw:
        return None  # precondition: e-asyncs in S1 do not throw
    e = fresh("e")
    e1 = fresh("e")
    wrapped = TryCatch(
        body=inner.body,
        exc_var=e1,
        handler=throw_me_of(e1),
        exc_types=("Exception",),
    )
    ctx.bump("try_finish_exchange")
    return seq(
        assign_null(e),
        Finish(
            body=TryCatch(
                body=seq(wrapped, exlist_guard(inner.exlist, e)),
                exc_var=e1,
                handler=Assign(target=e, value=var(e1)),
                exc_types=s.exc_types,
            ),
        ),
        If(
            cond=expr(lambda env, _e=e: env[_e] is not None, e, label=f"{e}!=null"),
            then=seq(
                Assign(target=s.exc_var, value=var(e)),
                s.handler,
            ),
        ),
    )


# ---------------------------------------------------------------------------
# Seq-level driver: fusion + expansion need adjacency
# ---------------------------------------------------------------------------


def _try_seq_rules(s: Seq, ctx: Ctx) -> Optional[Stmt]:
    stmts = list(s.stmts)
    # Finish Fusion on adjacent pairs.
    for i in range(len(stmts) - 1):
        a, b = stmts[i], stmts[i + 1]
        if isinstance(a, Finish) and isinstance(b, Finish):
            fused = finish_fusion_pair(a, b, ctx)
            if fused is not None:
                return seq(*stmts[:i], fused, *stmts[i + 2 :])
    # Finish Expansion Upper: S1; finish{S2}
    for i in range(len(stmts) - 1):
        a, b = stmts[i], stmts[i + 1]
        if not isinstance(a, Finish) and isinstance(b, Finish):
            out = finish_expansion_upper(a, b, ctx)
            if out is not None:
                return seq(*stmts[:i], out, *stmts[i + 2 :])
    # Finish Expansion Lower: finish{S1}; S2
    for i in range(len(stmts) - 1):
        a, b = stmts[i], stmts[i + 1]
        if isinstance(a, Finish) and not isinstance(b, Finish):
            out = finish_expansion_lower(a, b, ctx)
            if out is not None:
                return seq(*stmts[:i], out, *stmts[i + 2 :])
    return None


NODE_RULES = (
    tail_finish_elimination,
    loop_finish_interchange,
    finish_if_interchange,
    async_finish_interchange,
    try_finish_exchange,
)


def rewrite_once(s: Stmt, ctx: Ctx) -> Optional[Stmt]:
    """Try one rule application anywhere in the tree (bottom-up)."""
    kids = children(s)
    for i, c in enumerate(kids):
        out = rewrite_once(c, ctx)
        if out is not None:
            new_kids = list(kids)
            new_kids[i] = out
            return rebuild(s, new_kids)
    if isinstance(s, Seq):
        out = _try_seq_rules(s, ctx)
        if out is not None:
            return out
    for rule in NODE_RULES:
        out = rule(s, ctx)
        if out is not None:
            return out
    return None


def rewrite_fixpoint(s: Stmt, ctx: Ctx, max_steps: int = 400) -> Stmt:
    cur = s
    for _ in range(max_steps):
        out = rewrite_once(cur, ctx)
        if out is None:
            return cur
        cur = out
        # Summaries may be stale after rewriting; the facts we rely on
        # (escaping effects / may-throw) only shrink under these rules, so
        # reusing them stays conservative.
    return cur
