"""Loop Chunking (LC) — the Nandivada et al. 2013 baseline (paper Fig. 1(b), Fig. 7(b)).

Splits each parallel loop ``finish { for (i) async [clocked] B }`` into
``nChunks = Runtime.retNthreads()`` chunks of serial iterations, each chunk
executed by one spawned task.  For clocked bodies (``B = S0; advanceAll;
S1; ...``) each phase is chunked inside the async with the barriers kept
between phases (Fig. 7(b)).

This is the comparison target the paper requires ("the base X10 compiler
extended with loop-chunking of Nandivada et al."), implemented here so the
evaluation ladder UnOpt / LC / LC+AFE / DLBC / DCAFE is complete.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from .analysis import Summaries, loop_carried_dependence
from .ir import (
    Assign, Async, Barrier, Call, Finish, ForLoop, If, MethodDef, Program,
    Seq, Skip, Stmt, binop, children, const, expr, fresh, n_threads, rebuild,
    seq, var, walk,
)
from ..sched.policy import static_chunk_size


# ---------------------------------------------------------------------------
# Pattern matching
# ---------------------------------------------------------------------------


@dataclass
class ParallelLoop:
    loop: ForLoop
    async_: Async
    phases: List[Stmt]  # async body split on top-level barriers
    clocked: bool


def _single(s: Stmt) -> Stmt:
    while isinstance(s, Seq) and len(s.stmts) == 1:
        s = s.stmts[0]
    return s


def split_phases(body: Stmt) -> List[Stmt]:
    """Split an async body on its top-level ``Clock.advanceAll()`` calls."""
    if isinstance(body, Seq):
        phases: List[List[Stmt]] = [[]]
        for st in body.stmts:
            if isinstance(st, Barrier):
                phases.append([])
            else:
                phases[-1].append(st)
        return [seq(*p) for p in phases]
    if isinstance(body, Barrier):
        return [Skip(), Skip()]
    return [body]


def match_parallel_loop(s: Stmt) -> Optional[ParallelLoop]:
    """Match ``for (i=lo; i<hi; i+=1) { async [clocked] B }``."""
    if not isinstance(s, ForLoop):
        return None
    body = _single(s.body)
    if not isinstance(body, Async):
        return None
    # Only unit-step loops are chunked (all the paper's kernels).
    try:
        if s.step.fn(None) != 1:  # step must be the constant 1
            return None
    except Exception:
        return None
    phases = split_phases(body.body)
    return ParallelLoop(loop=s, async_=body, phases=phases,
                        clocked=bool(body.clocks))


def chunkable(pl: ParallelLoop, summaries: Summaries,
              private: frozenset = frozenset()) -> bool:
    """Is the loop safe to chunk?

    Serializing parallel iterations is always a legal schedule restriction
    in the async-finish model (no futures/conditions in the IR; clocked
    bodies are phase-split so a chunk never blocks on a sibling iteration).
    The only hard requirement is that spawned tasks must not modify the
    loop bounds or the induction variable.
    """
    from .analysis import bound_locals, drop_private

    eff = summaries.stmt_escaping_effects(pl.async_)
    priv = (private | bound_locals(pl.async_.body)
            | frozenset({pl.loop.loopvar}))
    eff_writes = drop_private(eff.writes, priv)
    bound_reads = drop_private(
        pl.loop.lo.reads | pl.loop.hi.reads | pl.loop.step.reads, priv
    )
    from .ir import sets_conflict

    if sets_conflict(eff_writes, bound_reads):
        return False
    if sets_conflict(eff.writes, frozenset({pl.loop.loopvar})):
        return False
    return True


# ---------------------------------------------------------------------------
# LC codegen (Fig. 1(b) / Fig. 7(b))
# ---------------------------------------------------------------------------


def lc_chunked_loop(pl: ParallelLoop) -> Stmt:
    i = pl.loop.loopvar
    lo, hi = pl.loop.lo, pl.loop.hi
    nchunks = fresh("nChunks")
    csize = fresh("chunkSize")
    ii = fresh("ii")
    ni = fresh("ni")
    kx = fresh("kx")

    def phase_chunk(p: Stmt) -> Stmt:
        return ForLoop(loopvar=i, lo=var(ni), hi=var(kx), step=const(1), body=p)

    inner: List[Stmt] = [
        Assign(target=kx,
               value=binop("min", binop("+", var(ni), var(csize)), hi),
               declare_local=True),
    ]
    for idx, p in enumerate(pl.phases):
        if idx > 0:
            inner.append(Barrier())
        inner.append(phase_chunk(p))

    total = binop("-", hi, lo)
    return seq(
        Assign(target=nchunks, value=n_threads(), declare_local=True),
        Assign(
            target=csize,
            value=expr(
                lambda env, _t=total, _n=nchunks: static_chunk_size(
                    _t.fn(env), env[_n]
                ),
                *(total.reads | frozenset({nchunks})),
                label=f"ceil(({total.label})/{nchunks})",
            ),
            declare_local=True,
        ),
        ForLoop(
            loopvar=ii, lo=lo, hi=hi, step=var(csize),
            body=seq(
                Assign(target=ni, value=var(ii), declare_local=True),
                Async(body=seq(*inner), clocks=pl.async_.clocks),
            ),
        ),
    )


def apply_lc(prog: Program) -> Program:
    """Chunk every parallel loop in every method (whole-program, like the
    paper's implementation in x10c)."""
    from .analysis import bound_locals

    summaries = Summaries.compute(prog)

    def rw_method(m: MethodDef) -> MethodDef:
        private = frozenset(m.params) | bound_locals(m.body)

        def rw(s: Stmt) -> Stmt:
            kids = [rw(c) for c in children(s)]
            s2 = rebuild(s, kids) if kids else s
            pl = match_parallel_loop(s2)
            if pl is not None and chunkable(pl, summaries, private):
                return lc_chunked_loop(pl)
            return s2

        return replace(m, body=rw(m.body))

    return Program(
        methods=tuple(rw_method(m) for m in prog.methods),
        main=prog.main,
    )
