"""Aggressive Finish Elimination — the AFE driver (paper §3.1).

Applies the mini-transformations leaf-up over the call graph:

1. visit methods in reverse-topological order over the SCC condensation
   (recursion cycles visited once — "avoiding the already visited nodes");
2. per method, rewrite to fixpoint with the helper+main rules
   (:mod:`repro.core.transforms`);
3. if the body normalizes to a single top-level ``finish`` (modulo leading
   local declarations feeding it), apply **Finish-Method Pull** (Fig. 4 #5 /
   the ``gex`` protocol of §4.1 when exceptions are possible): strip the
   finish from the method and wrap every *non-recursive* call site in the
   rest of the program with a finish — recursive call sites (same SCC) are
   left bare, which is the entire point: the join disappears from the
   recursion;
4. otherwise **partial rollback** — all-or-nothing per method (§3.1):
   the method reverts to its pre-AFE state.

Halting (paper argument): finite call sites, every method processed once,
no finish added to recursive call sites.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from .analysis import Summaries, bound_locals, call_graph, leafup_order, scc_of
from .ir import (
    Assign, Call, Finish, MethodDef, Program, Seq, Skip, Stmt, children,
    fresh, rebuild, seq, walk,
)
from .transforms import Ctx, rewrite_fixpoint, throw_var


@dataclass
class AFEReport:
    pulled: list = field(default_factory=list)      # methods whose finish was pulled
    rolled_back: list = field(default_factory=list)
    rule_stats: dict = field(default_factory=dict)


def _strip_leading_locals(body: Stmt):
    """Split ``body`` into (leading local Assigns, rest) — AFE-generated
    bodies often look like ``val v=...; finish {...}``."""
    if isinstance(body, Seq):
        lead = []
        rest = list(body.stmts)
        while rest and isinstance(rest[0], Assign) and rest[0].declare_local:
            lead.append(rest.pop(0))
        return lead, seq(*rest)
    return [], body


def _normalized_finish(body: Stmt):
    """Return (leading, Finish, trailing) if body ≡ locals; finish{...};
    pending-throws — else None."""
    lead, rest = _strip_leading_locals(body)
    if isinstance(rest, Finish):
        return lead, rest, []
    if isinstance(rest, Seq):
        stmts = list(rest.stmts)
        # Allow trailing pending-exception throw guards generated by the
        # exception-extended rules (they travel with the finish).
        head = stmts[0] if stmts else None
        if isinstance(head, Finish):
            from .ir import If

            trailing = stmts[1:]
            if all(isinstance(x, If) for x in trailing):
                return lead, head, trailing
    return None


def _wrap_callsites(prog: Program, target: str, exclude: frozenset,
                    gex_var: Optional[str]) -> Program:
    """Wrap every call to ``target`` outside ``exclude`` in a finish.

    With the ``gex`` protocol (exceptions possible), the wrapper also
    rethrows the pending exception the callee parked in the task-local
    ``gex`` slot:  ``finish { f(); } ; if (gex_f != null) throw gex_f``.
    """

    def rewrite_stmt(s: Stmt) -> Stmt:
        kids = [rewrite_stmt(c) for c in children(s)]
        s2 = rebuild(s, kids) if kids else s
        if isinstance(s2, Call) and s2.callee == target:
            wrapped: Stmt = Finish(body=s2)
            if gex_var is not None:
                from .ir import If, expr

                wrapped = seq(
                    wrapped,
                    If(
                        cond=expr(
                            lambda env, _v=gex_var: env.get(_v) is not None,
                            gex_var,
                            label=f"{gex_var}!=null",
                        ),
                        then=throw_var(gex_var),
                    ),
                )
            return wrapped
        return s2

    methods = []
    for m in prog.methods:
        if m.name in exclude:
            methods.append(m)
        else:
            methods.append(replace(m, body=rewrite_stmt(m.body)))
    return Program(methods=tuple(methods), main=prog.main)


def _pull_conflicts(prog: Program, scc: frozenset, target: str,
                    esc_reads: frozenset, esc_writes: frozenset,
                    summaries: Summaries) -> bool:
    """MHBD safety for Finish-Method Pull (the paper's "due to MHBD" blocker).

    After the pull, a *recursive* call site no longer joins the callee's
    tasks.  Statements sequenced after such a call — within the same task
    and the same enclosing-finish scope — would newly race those tasks.
    X10 finish is transitive, so statements beyond the innermost enclosing
    finish (and siblings of an enclosing async) keep their pre-pull
    may-race sets; only the intra-task post-call window must be checked.
    """
    from .analysis import depends_on_easyncs
    from .ir import Async, ForLoop, If, TryCatch, While

    bad = [False]

    def depends(s, iteration_private=(), private=frozenset()):
        return depends_on_easyncs(
            s, esc_reads, esc_writes, summaries,
            iteration_private=iteration_private, private=private,
        )

    def chk(s) -> bool:
        """Returns: is a live (un-joined) call site pending after ``s``?"""
        if bad[0]:
            return False
        if isinstance(s, Call):
            return s.callee in scc
        if isinstance(s, Finish):
            chk(s.body)
            return False  # transitive join protects everything after
        if isinstance(s, Async):
            chk(s.body)  # intra-child-task window checked independently
            return False  # parent-side races are unchanged by the pull
        if isinstance(s, Seq):
            live = False
            for st in s.stmts:
                if live and depends(st):
                    bad[0] = True
                live = chk(st) or live
            return live
        if isinstance(s, ForLoop):
            live = chk(s.body)
            if live:
                priv = (s.loopvar,)
                if depends(s.body, iteration_private=priv):
                    bad[0] = True
                from .ir import sets_conflict

                if sets_conflict(esc_writes, s.lo.reads | s.hi.reads | s.step.reads):
                    bad[0] = True
            return live
        if isinstance(s, While):
            live = chk(s.body)
            if live and (depends(s.body) or bool(esc_writes & s.cond.reads)):
                bad[0] = True
            return live
        if isinstance(s, If):
            return chk(s.then) | chk(s.els)
        if isinstance(s, TryCatch):
            a = chk(s.body)
            b = chk(s.handler)
            return a or b
        return False

    for mname in scc:
        m = prog.method(mname)
        private = frozenset(m.params) | bound_locals(m.body)
        _saved = depends

        def depends(s, iteration_private=(), _p=private):  # noqa: F811
            return depends_on_easyncs(
                s, esc_reads, esc_writes, summaries,
                iteration_private=iteration_private, private=_p,
            )

        chk(m.body)
        depends = _saved
        if bad[0]:
            return True
    return False


def finish_method_pull(prog: Program, name: str, ctx: Ctx) -> Optional[Program]:
    """Fig. 4 #5 (+ §4.1 gex protocol).  Returns the new program or None."""
    m = prog.method(name)
    if m.finish_pulled:
        return None  # paper precondition: not already applied
    if name == prog.main:
        return None  # finish reached main — done, nothing to pull further
    norm = _normalized_finish(m.body)
    if norm is None:
        return None
    lead, fin, trailing = norm
    sccs = scc_of(prog)
    exclude = sccs[name]  # never wrap recursive call sites
    # MHBD safety: recursive call sites lose their join — check the
    # post-call windows against the tasks that will now escape.
    eff = ctx.summaries.stmt_escaping_effects(fin.body)
    # Tasks previously joined by this finish become escaping after pull:
    from .analysis import stmt_reads as _sr, stmt_writes as _sw
    from .ir import Async as _A, walk as _walk

    esc_reads, esc_writes = set(eff.reads), set(eff.writes)
    for n in _walk(fin.body):
        if isinstance(n, _A):
            esc_reads |= _sr(n.body, ctx.summaries)
            esc_writes |= _sw(n.body, ctx.summaries)
    # Method/task-local names are by-value captured — they never carry a
    # cross-task dependence; keep only shared-heap effects.
    from .analysis import bound_locals as _bl, drop_private as _dp

    private = frozenset(m.params) | _bl(m.body)
    esc_reads = _dp(frozenset(esc_reads), private)
    esc_writes = _dp(frozenset(esc_writes), private)
    if _pull_conflicts(prog, exclude, name, esc_reads, esc_writes,
                       ctx.summaries):
        return None
    # Does anything escaping need a finish at the callers at all?
    may_throw = not ctx.assume_no_exceptions and (
        ctx.summaries.stmt_may_throw(fin) or bool(fin.exlist) or bool(trailing)
    )
    gex_var = None
    new_body_parts = lead + [fin.body]
    if may_throw:
        # gex protocol: park the callee's pending exception in a slot the
        # caller checks after its finish.
        gex_var = f"__gex_{name}"
        from .ir import Compute, TryCatch, expr

        e1 = fresh("e")
        parked = TryCatch(
            body=seq(*([*lead, fin.body] + trailing)),
            exc_var=e1,
            handler=Compute(
                fn=lambda env, _v=gex_var, _e=e1: env.set_heap(_v, env[_e]),
                reads=frozenset({e1}),
                writes=frozenset({gex_var}),
                cost=0.0,
                label=f"{gex_var}=e",
            ),
            exc_types=("Exception",),
        )
        clear = Compute(
            fn=lambda env, _v=gex_var: env.set_heap(_v, None),
            reads=frozenset(),
            writes=frozenset({gex_var}),
            cost=0.0,
            label=f"{gex_var}=null",
        )
        new_body = seq(clear, parked)
    else:
        new_body = seq(*new_body_parts)
    new_m = replace(m, body=new_body, finish_pulled=True)
    out = prog.with_method(new_m)
    out = _wrap_callsites(out, name, exclude, gex_var)
    ctx.bump("finish_method_pull")
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def apply_afe(prog: Program, *, assume_no_exceptions: bool = False
              ) -> tuple[Program, AFEReport]:
    report = AFEReport()
    order = leafup_order(prog)
    visited = set()
    for name in order:
        if name in visited:
            continue
        visited.add(name)
        summaries = Summaries.compute(prog)
        m = prog.method(name)
        ctx = Ctx(summaries=summaries, assume_no_exceptions=assume_no_exceptions,
                  stats=report.rule_stats,
                  private=frozenset(m.params) | bound_locals(m.body))
        snapshot = m  # all-or-nothing rollback point
        new_body = rewrite_fixpoint(m.body, ctx)
        candidate = prog.with_method(replace(m, body=new_body))
        if name == prog.main:
            # Scenario (a): finish pushed to main — keep the rewrite.
            prog = candidate
            continue
        ctx.summaries = Summaries.compute(candidate)
        pulled = finish_method_pull(candidate, name, ctx)
        if pulled is not None:
            prog = pulled
            report.pulled.append(name)
        else:
            # Keep intra-method rewrites only if they removed finishes or
            # did nothing harmful; the paper's all-or-nothing strategy
            # reverts the method when the finish cannot be pulled out.
            from .ir import Finish as _F

            n_before = sum(1 for n in walk(snapshot.body) if isinstance(n, _F))
            n_after = sum(1 for n in walk(new_body) if isinstance(n, _F))
            if n_after < n_before:
                prog = candidate  # net win inside the method (main rules fired)
            else:
                prog = prog.with_method(snapshot)
                report.rolled_back.append(name)
    # Translate away any surviving pending-exception constructs.
    from .ir import lower_program_pending

    return lower_program_pending(prog), report
