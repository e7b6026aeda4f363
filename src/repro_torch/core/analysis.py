"""Static analysis for the DCAFE transformation framework.

Implements the facts the paper's preconditions need (Figs. 2/4/8/9):

* escaping asyncs (*e-asyncs*) of a statement — asyncs whose IEF is not
  enclosed within the statement [Guo et al. 2009];
* inter-procedural method summaries: may-spawn-escaping, read/write sets of
  escaping tasks, clocked-ness, may-throw, contains-barrier — a fixpoint
  over the call graph (the paper's inter-procedural MHP extension of
  Agarwal et al. 2007);
* may-happen-before dependence (MHBD) checks between a statement and a set
  of e-asyncs (conservative location-set intersection, with per-iteration
  array privatisation for loop-carried tests);
* call-graph construction + SCC condensation (leaf-up AFE ordering).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ir import (
    Assign, Async, Barrier, Break, Call, Compute, Continue, Finish, ForLoop,
    If, MethodDef, NewClock, Program, Seq, Skip, Stmt, Throw, TryCatch, While,
    children, sets_conflict, walk,
)

# ---------------------------------------------------------------------------
# Local read/write/effect collection
# ---------------------------------------------------------------------------


def stmt_reads(s: Stmt, summaries=None) -> frozenset:
    reads = set()
    for n in walk(s):
        if isinstance(n, Assign):
            reads |= n.value.reads
        elif isinstance(n, Compute):
            reads |= n.reads
        elif isinstance(n, (ForLoop,)):
            reads |= n.lo.reads | n.hi.reads | n.step.reads
        elif isinstance(n, (While, If)):
            reads |= n.cond.reads
        elif isinstance(n, Call):
            for a in n.args:
                reads |= a.reads
            if summaries is not None and n.callee in summaries:
                reads |= summaries[n.callee].reads
        elif isinstance(n, Throw):
            reads |= n.payload.reads
    return frozenset(reads)


def stmt_writes(s: Stmt, summaries=None) -> frozenset:
    writes = set()
    for n in walk(s):
        if isinstance(n, Assign):
            writes.add(n.target)
        elif isinstance(n, Compute):
            writes |= n.writes
        elif isinstance(n, ForLoop):
            writes.add(n.loopvar)
        elif isinstance(n, NewClock):
            writes.add(n.target)
        elif isinstance(n, Call) and summaries is not None and n.callee in summaries:
            writes |= summaries[n.callee].writes
    return frozenset(writes)


def bound_locals(s: Stmt) -> frozenset:
    """Names bound task/method-locally within ``s`` (X10 ``val``/``var``
    declarations, loop variables, clock handles, catch variables).

    Locals are captured *by value* into spawned asyncs, so they can never
    carry a cross-task dependence — dependence checks subtract them.
    """
    out = set()
    for n in walk(s):
        if isinstance(n, Assign) and n.declare_local:
            out.add(n.target)
        elif isinstance(n, ForLoop):
            out.add(n.loopvar)
        elif isinstance(n, NewClock):
            out.add(n.target)
        elif isinstance(n, TryCatch):
            out.add(n.exc_var)
    return frozenset(out)


def drop_private(locs: frozenset, private: frozenset) -> frozenset:
    """Remove task-private scalar names (bracketed heap locations stay)."""
    if not private:
        return locs
    return frozenset(l for l in locs if "[" in l or l not in private)


# ---------------------------------------------------------------------------
# e-asyncs
# ---------------------------------------------------------------------------


def e_asyncs(s: Stmt) -> list:
    """Asyncs in ``s`` whose IEF is not enclosed within ``s`` (syntactic part).

    A call to a method that escapes tasks also contributes; use
    :func:`Summaries.stmt_escaping_effects` for the inter-procedural version.
    """
    out = []

    def go(n: Stmt, under_finish: bool):
        if isinstance(n, Finish):
            go(n.body, True)
            return
        if isinstance(n, Async):
            if not under_finish:
                out.append(n)
            # Asyncs nested inside this async body escape iff this one does
            # and there is no finish in between.
            go(n.body, under_finish)
            return
        for c in children(n):
            go(c, under_finish)

    go(s, False)
    return out


def has_syntactic_easync(s: Stmt) -> bool:
    return bool(e_asyncs(s))


def contains_barrier_syntactic(s: Stmt) -> bool:
    return any(isinstance(n, Barrier) for n in walk(s))


def may_throw_syntactic(s: Stmt) -> bool:
    """Throw nodes + rethrow computes (conservative: any Compute labelled
    ``throw ...`` counts — those are generated by pending-exception lowering)."""
    for n in walk(s):
        if isinstance(n, Throw):
            return True
        if isinstance(n, Compute) and n.label.startswith("throw"):
            return True
    return False


# ---------------------------------------------------------------------------
# Inter-procedural summaries
# ---------------------------------------------------------------------------


@dataclass
class MethodSummary:
    reads: frozenset = frozenset()
    writes: frozenset = frozenset()
    escapes_tasks: bool = False        # may leave e-asyncs running on return
    escaping_clocked: bool = False     # ... that are registered on clocks
    escaping_reads: frozenset = frozenset()
    escaping_writes: frozenset = frozenset()
    escaping_may_throw: bool = False
    may_throw: bool = False            # synchronous exception may escape call
    has_barrier: bool = False
    spawns: bool = False               # any async at all (even joined)


class Summaries(dict):
    """name -> MethodSummary, computed to fixpoint over the call graph."""

    @classmethod
    def compute(cls, prog: Program) -> "Summaries":
        summ = cls({m.name: MethodSummary() for m in prog.methods})
        changed = True
        iters = 0
        while changed:
            changed = False
            iters += 1
            assert iters < 200, "summary fixpoint diverged"
            for m in prog.methods:
                new = summ._summarize_method(m)
                old = summ[m.name]
                if vars(new) != vars(old):
                    summ[m.name] = new
                    changed = True
        return summ

    # -- per-method transfer ------------------------------------------------

    def _summarize_method(self, m: MethodDef) -> MethodSummary:
        s = MethodSummary()
        private = frozenset(m.params) | bound_locals(m.body)
        s.reads = drop_private(stmt_reads(m.body, self), private)
        s.writes = drop_private(stmt_writes(m.body, self), private)
        esc = self.stmt_escaping_effects(m.body)
        s.escapes_tasks = esc.escapes
        s.escaping_clocked = esc.clocked
        s.escaping_reads = drop_private(esc.reads, private)
        s.escaping_writes = drop_private(esc.writes, private)
        s.escaping_may_throw = esc.may_throw
        s.may_throw = self.stmt_may_throw(m.body)
        s.has_barrier = self.stmt_has_barrier(m.body)
        s.spawns = any(isinstance(n, Async) for n in walk(m.body)) or any(
            isinstance(n, Call) and n.callee in self and self[n.callee].spawns
            for n in walk(m.body)
        )
        return s

    # -- inter-procedural statement queries ----------------------------------

    def stmt_may_throw(self, s: Stmt) -> bool:
        """May a synchronous exception escape execution of ``s``?

        Conservative: try/catch with a universal catch ("Exception"/"ME")
        swallows; anything else propagates.  Exceptions thrown inside a
        ``finish`` re-emerge as MultipleExceptions, so a finish whose body
        (or whose spawned tasks) may throw also may throw.
        """
        if isinstance(s, Throw):
            return True
        if isinstance(s, Compute):
            return s.label.startswith("throw")
        if isinstance(s, TryCatch):
            swallows = "Exception" in s.exc_types or "ME" in s.exc_types
            body_throws = self.stmt_may_throw(s.body)
            handler_throws = self.stmt_may_throw(s.handler)
            return (body_throws and not swallows) or handler_throws
        if isinstance(s, Call):
            summ = self.get(s.callee)
            return summ.may_throw if summ else True
        if isinstance(s, Async):
            # Exception in the async is caught by its IEF, not here.
            return False
        if isinstance(s, Finish):
            eff = self.stmt_escaping_effects(s.body)
            return (
                self.stmt_may_throw(s.body)
                or eff.may_throw
                or self._joined_tasks_may_throw(s.body)
            )
        return any(self.stmt_may_throw(c) for c in children(s))

    def _joined_tasks_may_throw(self, s: Stmt) -> bool:
        for n in walk(s):
            if isinstance(n, Async) and self.stmt_may_throw(n.body):
                return True
            if isinstance(n, Async) and self.stmt_escaping_effects(n.body).may_throw:
                return True
            if isinstance(n, Call):
                summ = self.get(n.callee)
                if summ and summ.escaping_may_throw:
                    return True
        return False

    def stmt_has_barrier(self, s: Stmt) -> bool:
        """May the *executing task* reach a ``Clock.advanceAll()`` inside
        ``s``?  Barriers inside spawned asyncs run in child tasks and do not
        make ``s`` "a barrier" (Fig. 4 #3 precondition) — what matters is
        whether moving ``s`` into a finish changes when the current task
        advances its clocks."""
        if isinstance(s, Barrier):
            return True
        if isinstance(s, Async):
            return False  # executes in a child task
        if isinstance(s, Call):
            summ = self.get(s.callee)
            return True if summ is None else summ.has_barrier
        return any(self.stmt_has_barrier(c) for c in children(s))

    @dataclass
    class Escaping:
        escapes: bool = False
        clocked: bool = False
        reads: frozenset = frozenset()
        writes: frozenset = frozenset()
        may_throw: bool = False

    def stmt_escaping_effects(self, s: Stmt) -> "Summaries.Escaping":
        """Effects of tasks spawned in ``s`` that escape ``s`` (inter-proc)."""
        eff = Summaries.Escaping()

        def absorb_async(a: Async):
            eff.escapes = True
            eff.clocked = eff.clocked or bool(a.clocks)
            eff.reads = eff.reads | stmt_reads(a.body, self)
            eff.writes = eff.writes | stmt_writes(a.body, self)
            eff.may_throw = (
                eff.may_throw
                or self.stmt_may_throw(a.body)
                or self.stmt_escaping_effects(a.body).may_throw
            )

        def go(n: Stmt, under_finish: bool):
            if isinstance(n, Finish):
                go(n.body, True)
                return
            if isinstance(n, Async):
                if not under_finish:
                    absorb_async(n)
                go(n.body, under_finish)
                return
            if isinstance(n, Call) and not under_finish:
                summ = self.get(n.callee)
                if summ is None:
                    eff.escapes = True
                    eff.clocked = True
                    eff.may_throw = True
                elif summ.escapes_tasks:
                    eff.escapes = True
                    eff.clocked = eff.clocked or summ.escaping_clocked
                    eff.reads = eff.reads | summ.escaping_reads
                    eff.writes = eff.writes | summ.escaping_writes
                    eff.may_throw = eff.may_throw or summ.escaping_may_throw
                return
            for c in children(n):
                go(c, under_finish)

        go(s, False)
        return eff


# ---------------------------------------------------------------------------
# MHBD-style dependence checks
# ---------------------------------------------------------------------------


def depends_on_easyncs(
    s: Stmt,
    easync_reads: frozenset,
    easync_writes: frozenset,
    summaries: Summaries,
    *,
    iteration_private: tuple = (),
    private: frozenset = frozenset(),
) -> bool:
    """May ``s`` have a may-happen-before dependence on the e-asyncs?

    True if (reads(s) ∪ writes(s)) ∩ writes(e) ≠ ∅ or writes(s) ∩ reads(e) ≠ ∅.
    Task-private scalar names (``private``) never carry dependences —
    asyncs capture them by value.
    """
    sr = drop_private(stmt_reads(s, summaries), private)
    sw = drop_private(stmt_writes(s, summaries), private)
    er = drop_private(easync_reads, private)
    ew = drop_private(easync_writes, private)
    return (
        sets_conflict(sr | sw, ew, iteration_private=iteration_private)
        or sets_conflict(sw, er, iteration_private=iteration_private)
    )


def loop_carried_dependence(
    loop: ForLoop, summaries: Summaries, private: frozenset = frozenset()
) -> bool:
    """Loop-carried dependence test for Loop-Finish Interchange (Fig. 2 #1).

    Checks whether any e-async of the loop body conflicts with the next
    iteration's condition/update/body.  Array accesses indexed by the loop
    variable are per-iteration private; task-local scalars are by-value.
    """
    eff = summaries.stmt_escaping_effects(
        loop.body if not isinstance(loop.body, Finish) else loop.body.body
    )
    if not eff.escapes:
        return False
    body = loop.body.body if isinstance(loop.body, Finish) else loop.body
    priv_names = private | bound_locals(body) | frozenset({loop.loopvar})
    priv = (loop.loopvar,)
    eff_writes = drop_private(eff.writes, priv_names)
    eff_reads = drop_private(eff.reads, priv_names)
    body_reads = drop_private(stmt_reads(body, summaries), priv_names)
    body_writes = drop_private(stmt_writes(body, summaries), priv_names)
    bound_reads = drop_private(
        loop.lo.reads | loop.hi.reads | loop.step.reads, priv_names
    )
    # e-async writes vs (bounds ∪ next-iteration reads/writes) across
    # iterations — loop-var-indexed accesses are disjoint across iterations.
    if sets_conflict(eff_writes, bound_reads, iteration_private=priv):
        return True
    if sets_conflict(eff_writes, body_reads | body_writes, iteration_private=priv):
        return True
    if sets_conflict(eff_reads, body_writes, iteration_private=priv):
        return True
    # Writes to the loop variable itself from inside tasks.
    if sets_conflict(eff.writes, frozenset({loop.loopvar})):
        return True
    return False


# ---------------------------------------------------------------------------
# Call graph
# ---------------------------------------------------------------------------


def call_graph(prog: Program) -> dict:
    g = {m.name: set() for m in prog.methods}
    for m in prog.methods:
        for n in walk(m.body):
            if isinstance(n, Call) and n.callee in g:
                g[m.name].add(n.callee)
    return g


def leafup_order(prog: Program) -> list:
    """Methods in reverse-topological (leaf-up) order over the SCC
    condensation of the call graph.  Members of a cycle (recursion) appear
    together; each method is visited once (paper §3.1 halting argument)."""
    g = call_graph(prog)
    index = {}
    low = {}
    on_stack = {}
    stack = []
    sccs = []
    counter = [0]

    def strongconnect(v):
        # Iterative Tarjan to survive deep call graphs.
        work = [(v, iter(sorted(g[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(g[w]))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(g):
        if v not in index:
            strongconnect(v)
    # Tarjan emits SCCs in reverse topological order already (callees first).
    order = []
    for comp in sccs:
        order.extend(sorted(comp))
    return order


def scc_of(prog: Program) -> dict:
    """name -> frozenset of methods in the same call-graph SCC."""
    g = call_graph(prog)
    order = leafup_order(prog)
    # Recompute SCC membership with a simple reachability check (small graphs).
    reach = {}

    def reachable(a):
        if a in reach:
            return reach[a]
        seen = set()
        frontier = [a]
        while frontier:
            x = frontier.pop()
            for y in g.get(x, ()):
                if y not in seen:
                    seen.add(y)
                    frontier.append(y)
        reach[a] = seen
        return seen

    out = {}
    for name in order:
        comp = {name} | {
            other for other in g if name in reachable(other) and other in reachable(name)
        }
        out[name] = frozenset(comp)
    return out
