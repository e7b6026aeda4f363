"""Async-finish task IR for recursive task-parallel (RTP) programs.

This is the faithful substrate for the DCAFE paper (Gupta, Shrivastava,
Nandivada 2015): an X10-like mini-language with ``async`` / ``finish`` /
clocks / exceptions, rich enough to express the paper's eight mini-
transformations (Figs. 2/4/8/9), the LC and DLBC code-generation schemes
(Figs. 1/6/7) and the eight RTP benchmark kernels.

Design notes
------------
* Nodes are frozen dataclasses → transformations build new trees; rollback
  (the paper's all-or-nothing strategy) is a pointer swap.
* Expressions carry an explicit ``reads`` set so the dependence analysis in
  :mod:`repro.core.analysis` stays purely structural.
* Memory locations are strings.  The convention ``"arr[i]"`` denotes an
  array element indexed by the *loop variable* ``i``; two accesses
  ``arr[i]`` from different iterations of the same counted loop are
  disjoint (X10 ``Rail`` element writes by iteration index).  ``"arr[*]"``
  is an unknown index and conflicts with every ``arr[...]`` access.
* X10 ``val`` capture semantics: an ``Async`` body executes with a by-value
  snapshot of the spawner's local frame (this is why LC emits
  ``val ni = ii`` — the same pattern works unchanged here).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    """An opaque expression: a pure function of the environment.

    ``reads`` lists every location the expression may read.  ``intrinsic``
    marks runtime intrinsics (``idle_workers`` / ``n_threads``) that read
    scheduler state instead of the heap.
    """

    fn: Callable[["EnvView"], Any]
    reads: frozenset = frozenset()
    label: str = ""
    intrinsic: str = ""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Expr({self.label or self.intrinsic or 'λ'})"


def const(v: Any) -> Expr:
    return Expr(fn=lambda env, _v=v: _v, reads=frozenset(), label=repr(v))


def var(name: str) -> Expr:
    return Expr(fn=lambda env, _n=name: env[_n], reads=frozenset({name}), label=name)


def expr(fn: Callable[["EnvView"], Any], *reads: str, label: str = "") -> Expr:
    return Expr(fn=fn, reads=frozenset(reads), label=label)


def binop(op: str, a: Expr, b: Expr) -> Expr:
    import operator

    ops = {
        "+": operator.add, "-": operator.sub, "*": operator.mul,
        "//": operator.floordiv, "%": operator.mod,
        "<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq, "!=": operator.ne,
        "and": lambda x, y: x and y, "or": lambda x, y: x or y,
        "min": min, "max": max,
    }
    f = ops[op]
    return Expr(
        fn=lambda env, _f=f, _a=a, _b=b: _f(_a.fn(env), _b.fn(env)),
        reads=a.reads | b.reads,
        label=f"({a.label}{op}{b.label})",
    )


def idle_workers() -> Expr:
    """``Runtime.retIdleWorkers()`` — deliberately non-atomic (paper §3.2.1)."""
    return Expr(fn=lambda env: env.runtime_idle_workers(), reads=frozenset(),
                label="retIdleWorkers()", intrinsic="idle_workers")


def n_threads() -> Expr:
    """``Runtime.retNthreads()`` — initial worker count (paper Fig. 1(b))."""
    return Expr(fn=lambda env: env.runtime_n_threads(), reads=frozenset(),
                label="retNthreads()", intrinsic="n_threads")


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


class Stmt:
    """Base class for IR statements (all subclasses are frozen dataclasses)."""

    __slots__ = ()


@dataclass(frozen=True)
class Skip(Stmt):
    pass


@dataclass(frozen=True)
class Seq(Stmt):
    stmts: tuple = ()

    def __post_init__(self):
        assert all(isinstance(s, Stmt) for s in self.stmts)


@dataclass(frozen=True)
class Assign(Stmt):
    """``var = expr`` — writes a single location."""

    target: str
    value: Expr
    cost: float = 0.0
    declare_local: bool = False  # X10 ``val``/``var`` declaration (task-local)


@dataclass(frozen=True)
class Compute(Stmt):
    """Opaque computation with declared read/write sets and a cost.

    ``fn(env)`` mutates the environment (only locations in ``writes``).
    ``cost`` may be a float or an Expr evaluated at runtime (simulated
    work units).
    """

    fn: Callable[["EnvView"], None]
    reads: frozenset = frozenset()
    writes: frozenset = frozenset()
    cost: Any = 1.0
    label: str = ""


@dataclass(frozen=True)
class Async(Stmt):
    body: Stmt = Skip()
    clocks: tuple = ()  # names of clock-valued locals the task registers on


@dataclass(frozen=True)
class Finish(Stmt):
    body: Stmt = Skip()
    # Pending-exception list (paper §4): sequence of local variable names;
    # lowered by ``lower_pending`` into ``if (v != null) throw v`` trailers.
    exlist: tuple = ()


@dataclass(frozen=True)
class ForLoop(Stmt):
    """Counted loop ``for (var v = lo; v < hi; v += step) body``."""

    loopvar: str
    lo: Expr = const(0)
    hi: Expr = const(0)
    step: Expr = const(1)
    body: Stmt = Skip()


@dataclass(frozen=True)
class While(Stmt):
    cond: Expr = const(True)
    body: Stmt = Skip()


@dataclass(frozen=True)
class Break(Stmt):
    pass


@dataclass(frozen=True)
class Continue(Stmt):
    pass


@dataclass(frozen=True)
class If(Stmt):
    cond: Expr = const(True)
    then: Stmt = Skip()
    els: Stmt = Skip()


@dataclass(frozen=True)
class Call(Stmt):
    callee: str
    args: tuple = ()  # tuple[Expr, ...] — by-value (X10 val) parameters


@dataclass(frozen=True)
class NewClock(Stmt):
    """``val c = Clock.make()`` — creator task is registered on the clock."""

    target: str


@dataclass(frozen=True)
class Barrier(Stmt):
    """``Clock.advanceAll()`` — advance every clock this task is registered on."""

    pass


@dataclass(frozen=True)
class Throw(Stmt):
    exc_type: str = "Exception"
    payload: Expr = const(None)


@dataclass(frozen=True)
class TryCatch(Stmt):
    body: Stmt = Skip()
    exc_var: str = "e"
    handler: Stmt = Skip()
    exc_types: tuple = ("Exception",)  # "ME" catches MultipleExceptions


@dataclass(frozen=True)
class MethodDef:
    name: str
    params: tuple = ()
    body: Stmt = Skip()
    # Set by AFE when Finish-Method Pull has been applied (halting guard).
    finish_pulled: bool = False


@dataclass(frozen=True)
class Program:
    methods: tuple = ()  # tuple[MethodDef, ...]
    main: str = "main"

    def method(self, name: str) -> MethodDef:
        for m in self.methods:
            if m.name == name:
                return m
        raise KeyError(name)

    def with_method(self, m: MethodDef) -> "Program":
        return Program(
            methods=tuple(m if x.name == m.name else x for x in self.methods),
            main=self.main,
        )

    def names(self):
        return [m.name for m in self.methods]


# ---------------------------------------------------------------------------
# Structural helpers
# ---------------------------------------------------------------------------


def children(s: Stmt):
    """Immediate child statements of ``s``."""
    if isinstance(s, Seq):
        return list(s.stmts)
    if isinstance(s, (Async, Finish)):
        return [s.body]
    if isinstance(s, ForLoop):
        return [s.body]
    if isinstance(s, While):
        return [s.body]
    if isinstance(s, If):
        return [s.then, s.els]
    if isinstance(s, TryCatch):
        return [s.body, s.handler]
    return []


def rebuild(s: Stmt, new_children) -> Stmt:
    if isinstance(s, Seq):
        return Seq(tuple(new_children))
    if isinstance(s, Async):
        return replace(s, body=new_children[0])
    if isinstance(s, Finish):
        return replace(s, body=new_children[0])
    if isinstance(s, ForLoop):
        return replace(s, body=new_children[0])
    if isinstance(s, While):
        return replace(s, body=new_children[0])
    if isinstance(s, If):
        return replace(s, then=new_children[0], els=new_children[1])
    if isinstance(s, TryCatch):
        return replace(s, body=new_children[0], handler=new_children[1])
    assert not new_children
    return s


def walk(s: Stmt):
    """Pre-order traversal of every statement in the subtree."""
    yield s
    for c in children(s):
        yield from walk(c)


def tree_size(s: Stmt) -> int:
    return sum(1 for _ in walk(s))


def seq(*stmts: Stmt) -> Stmt:
    """Smart Seq constructor: flattens nested Seq, drops Skip."""
    flat = []
    for st in stmts:
        if isinstance(st, Skip):
            continue
        if isinstance(st, Seq):
            flat.extend(x for x in st.stmts if not isinstance(x, Skip))
        else:
            flat.append(st)
    if not flat:
        return Skip()
    if len(flat) == 1:
        return flat[0]
    return Seq(tuple(flat))


_FRESH = itertools.count()


def fresh(prefix: str = "t") -> str:
    return f"__{prefix}{next(_FRESH)}"


# ---------------------------------------------------------------------------
# Location algebra ("arr[i]" / "arr[*]" / scalars)
# ---------------------------------------------------------------------------


def loc_base(loc: str) -> str:
    return loc.split("[", 1)[0]


def loc_index(loc: str) -> Optional[str]:
    if "[" in loc:
        return loc[loc.index("[") + 1 : -1]
    return None


def locs_conflict(a: str, b: str, *, iteration_private: tuple = ()) -> bool:
    """Do locations ``a`` and ``b`` possibly alias?

    ``iteration_private`` lists loop variables for which same-index accesses
    from *different iterations* are known disjoint (used for loop-carried
    dependence tests): ``arr[i]`` vs ``arr[i]`` with i ∈ iteration_private is
    treated as a conflict ONLY when checking same-iteration dependence — the
    caller flips the meaning by passing the private set.
    """
    if loc_base(a) != loc_base(b):
        return False
    ia, ib = loc_index(a), loc_index(b)
    if ia is None or ib is None:
        return True  # scalar vs scalar (same base) or scalar vs array base
    if ia == "+" and ib == "+":
        # Commutative-reduction accesses ("arr[+]"): atomic monotone updates
        # (min/max/sum accumulators) commute with each other, so two
        # reduction accesses to the same base never constitute an ordering
        # dependence.  A reduction access vs a plain read/write DOES conflict
        # (handled below).  This mirrors how X10 dependence analyses treat
        # accumulator idioms.
        return False
    if ia == "*" or ib == "*":
        return True
    if ia == ib and ia in iteration_private:
        # Same symbolic index, privatised per iteration → disjoint across
        # iterations.
        return False
    if ia == ib:
        return True
    # Distinct symbolic indices: conservatively assume they may alias unless
    # both are integer literals.
    try:
        return int(ia) == int(ib)
    except ValueError:
        return True


def sets_conflict(A, B, *, iteration_private: tuple = ()) -> bool:
    return any(
        locs_conflict(a, b, iteration_private=iteration_private)
        for a in A
        for b in B
    )


# ---------------------------------------------------------------------------
# Pending-exception lowering (paper §4: finish{S}<exlist> ⇒ finish{S}; exlist)
# ---------------------------------------------------------------------------


def _throw_if_set(v: str) -> Stmt:
    return If(
        cond=expr(lambda env, _v=v: env[_v] is not None, v, label=f"{v}!=null"),
        then=Compute(
            fn=lambda env, _v=v: env.rethrow(env[_v]),
            reads=frozenset({v}),
            writes=frozenset(),
            cost=0.0,
            label=f"throw {v}",
        ),
    )


def lower_pending(s: Stmt) -> Stmt:
    """Translate away temporary ``finish{S}<exlist>`` constructs."""
    kids = [lower_pending(c) for c in children(s)]
    s2 = rebuild(s, kids) if kids else s
    if isinstance(s2, Finish) and s2.exlist:
        trailers = [_throw_if_set(v) for v in s2.exlist]
        return seq(Finish(body=s2.body), *trailers)
    return s2


def lower_program_pending(p: Program) -> Program:
    return Program(
        methods=tuple(replace(m, body=lower_pending(m.body)) for m in p.methods),
        main=p.main,
    )


# ---------------------------------------------------------------------------
# Pretty printer (debugging / DESIGN docs)
# ---------------------------------------------------------------------------


def pretty(s: Stmt, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(s, Skip):
        return pad + "skip;"
    if isinstance(s, Seq):
        return "\n".join(pretty(c, indent) for c in s.stmts)
    if isinstance(s, Assign):
        kw = "val " if s.declare_local else ""
        return f"{pad}{kw}{s.target} = {s.value.label};"
    if isinstance(s, Compute):
        return f"{pad}compute[{s.label or 'work'}](r={sorted(s.reads)}, w={sorted(s.writes)});"
    if isinstance(s, Async):
        ck = f" clocked({','.join(s.clocks)})" if s.clocks else ""
        return f"{pad}async{ck} {{\n{pretty(s.body, indent + 1)}\n{pad}}}"
    if isinstance(s, Finish):
        ex = f"<{','.join(s.exlist)}>" if s.exlist else ""
        return f"{pad}finish {{\n{pretty(s.body, indent + 1)}\n{pad}}}{ex}"
    if isinstance(s, ForLoop):
        return (
            f"{pad}for ({s.loopvar} = {s.lo.label}; {s.loopvar} < {s.hi.label}; "
            f"{s.loopvar} += {s.step.label}) {{\n{pretty(s.body, indent + 1)}\n{pad}}}"
        )
    if isinstance(s, While):
        return f"{pad}while ({s.cond.label}) {{\n{pretty(s.body, indent + 1)}\n{pad}}}"
    if isinstance(s, Break):
        return pad + "break;"
    if isinstance(s, Continue):
        return pad + "continue;"
    if isinstance(s, If):
        out = f"{pad}if ({s.cond.label}) {{\n{pretty(s.then, indent + 1)}\n{pad}}}"
        if not isinstance(s.els, Skip):
            out += f" else {{\n{pretty(s.els, indent + 1)}\n{pad}}}"
        return out
    if isinstance(s, Call):
        return f"{pad}{s.callee}({', '.join(a.label for a in s.args)});"
    if isinstance(s, NewClock):
        return f"{pad}val {s.target} = Clock.make();"
    if isinstance(s, Barrier):
        return pad + "Clock.advanceAll();"
    if isinstance(s, Throw):
        return f"{pad}throw {s.exc_type};"
    if isinstance(s, TryCatch):
        return (
            f"{pad}try {{\n{pretty(s.body, indent + 1)}\n{pad}}} "
            f"catch({s.exc_var}:{'|'.join(s.exc_types)}) {{\n"
            f"{pretty(s.handler, indent + 1)}\n{pad}}}"
        )
    return pad + repr(s)


def pretty_program(p: Program) -> str:
    out = []
    for m in p.methods:
        out.append(f"def {m.name}({', '.join(m.params)}) {{")
        out.append(pretty(m.body, 1))
        out.append("}")
    return "\n".join(out)
