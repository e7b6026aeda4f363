"""Dynamic Load-Balanced loop Chunking — DLBC codegen (paper §3.2, Figs. 6/7(c)).

For each parallel loop ``[finish] { for (i=lo; i<hi; i++) async [clocked] B }``
emit the three-block structure:

* **chunked block** — spawned only when ``Runtime.retIdleWorkers() > 0``;
  the remaining iterations are divided *equally among idle workers + the
  current worker* with the current worker receiving the **smallest** chunk:
  ``eqChunk = actualn / totWorkers``, remainder distributed one-per-chunk
  from the front via ``rem = actualn % totWorkers + workers`` and
  ``kx = ii + eqChunk + rem / totWorkers; rem--`` (Fig. 6 lines 7–16);
* **parent block** — the current worker executes its own (smallest) chunk
  serially before waiting at the join (Fig. 6 lines 21–24);
* **serial block** — when no workers are idle, execute iterations serially,
  re-reading the idle count after *each* iteration; when ≥1 worker frees up
  and ≥2 iterations remain, jump back to the parallel path (Fig. 6 lines
  26–31).

Clocked loops (Fig. 7(c)) get a ``phase`` counter: the serial block runs a
whole phase over all iterations, advances the clock, then re-checks for
idle workers; chunked/parent blocks guard each phase with ``phase <= p``
(the switch-with-fallthrough of the paper) so already-executed phases are
skipped.

When AFE has already removed the enclosing finish (DCAFE), the chunked and
parent blocks are emitted WITHOUT a finish — the spawned tasks escape to
the single outer join, which is precisely how DCAFE reaches "1 finish,
~1000× fewer tasks" on NQ-style kernels.

The chunk arithmetic itself (totWorkers / eqChunk / chunkEnd / rem / kx)
is NOT re-derived here: the emitted expressions call the canonical
``fig6_*`` helpers of :mod:`repro.sched.policy`, the single owner of the
remainder-spread recurrence shared with the host pools and the serving
batcher.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional

from .analysis import Summaries
from .ir import (
    Assign, Async, Barrier, Break, Call, Continue, Finish, ForLoop, If,
    MethodDef, Program, Seq, Skip, Stmt, While, binop, children, const, expr,
    fresh, idle_workers, rebuild, seq, var, walk,
)
from .lc import ParallelLoop, chunkable, match_parallel_loop, split_phases
from ..sched.policy import (
    fig6_chunk_end, fig6_eq, fig6_next, fig6_rem0, fig6_tot,
)


def _phase_guard(phase_var: str, p: int, body: Stmt) -> Stmt:
    return If(
        cond=expr(
            lambda env, _v=phase_var, _p=p: env[_v] <= _p,
            phase_var,
            label=f"{phase_var}<={p}",
        ),
        then=body,
    )


def dlbc_loop(pl: ParallelLoop, *, with_finish: bool,
              serial_check_every: int = 1,
              min_parallel: bool = False) -> Stmt:
    """Emit the DLBC structure for one parallel loop.

    The paper's §6 design alternatives are selectable for the design-choice
    study (benchmarks/bench_design_choices.py):

    * ``serial_check_every=k`` — re-check for idle workers only every k-th
      serial iteration (paper §6(b): "the complexity of the additional
      checks did not pay off");
    * ``min_parallel=True`` — instead of full serialization, always split
      the remaining iterations into one spawned task + the current worker
      (paper §6(c): "may end up creating more tasks than required ...
      the cons outweighed the pros").
    """
    i = pl.loop.loopvar
    lo, hi = pl.loop.lo, pl.loop.hi
    clocked = pl.clocked
    nphases = len(pl.phases)

    ii = fresh("ii")
    workers = fresh("workers")
    tot = fresh("totWorkers")
    actualn = fresh("actualn")
    eqc = fresh("eqChunk")
    chunk_end = fresh("chunkEnd")
    rem = fresh("rem")
    ni = fresh("ni")
    kx = fresh("kx")
    phase = fresh("phase")
    resume = fresh("resume")
    si = fresh("si")

    def iter_loop(lo_e, hi_e, body: Stmt) -> Stmt:
        return ForLoop(loopvar=i, lo=lo_e, hi=hi_e, step=const(1), body=body)

    # ---- chunked block (spawned tasks) --------------------------------------
    async_phases: List[Stmt] = []
    for p, ph in enumerate(pl.phases):
        blk = iter_loop(var(ni), var(kx), ph)
        if clocked:
            parts: List[Stmt] = [blk]
            if p < nphases - 1:
                parts.append(Barrier())
            async_phases.append(_phase_guard(phase, p, seq(*parts)))
        else:
            async_phases.append(blk)
    chunk_async = Async(body=seq(*async_phases), clocks=pl.async_.clocks)

    chunked_block = While(
        cond=expr(
            lambda env, _ii=ii, _ce=chunk_end: env[_ii] < env[_ce],
            ii, chunk_end, label=f"{ii}<{chunk_end}",
        ),
        body=seq(
            Assign(
                target=kx,
                value=expr(
                    lambda env, _ii=ii, _e=eqc, _r=rem, _t=tot: fig6_next(
                        env[_ii], env[_e], env[_r], env[_t]),
                    ii, eqc, rem, tot,
                    label=f"{ii}+{eqc}+{rem}/{tot}",
                ),
                declare_local=True,
            ),
            Assign(target=ni, value=var(ii), declare_local=True),
            Assign(target=rem, value=binop("-", var(rem), const(1))),
            Assign(target=ii, value=var(kx)),
            chunk_async,
        ),
    )

    # ---- parent block (current worker's smallest chunk) ----------------------
    parent_phases: List[Stmt] = []
    for p, ph in enumerate(pl.phases):
        blk = iter_loop(var(chunk_end), hi, ph)
        if clocked:
            parts = [blk]
            if p < nphases - 1:
                parts.append(Barrier())
            parent_phases.append(_phase_guard(phase, p, seq(*parts)))
        else:
            parent_phases.append(blk)
    parent_block = seq(*parent_phases)

    par_body = seq(chunked_block, parent_block)
    if with_finish:
        par_body = Finish(body=par_body)

    parallel_arm = seq(
        Assign(target=tot,
               value=expr(lambda env, _w=workers: fig6_tot(env[_w]),
                          workers, label=f"{workers}+1"),
               declare_local=True),
        Assign(target=actualn, value=binop("-", hi, var(ii)),
               declare_local=True),
        Assign(target=eqc,
               value=expr(
                   lambda env, _a=actualn, _t=tot: fig6_eq(env[_a], env[_t]),
                   actualn, tot, label=f"{actualn}//{tot}"),
               declare_local=True),
        Assign(
            target=chunk_end,
            value=expr(
                lambda env, _ii=ii, _a=actualn, _e=eqc: fig6_chunk_end(
                    env[_ii], env[_a], env[_e]),
                ii, actualn, eqc, label=f"{ii}+{actualn}-{eqc}",
            ),
            declare_local=True,
        ),
        Assign(
            target=rem,
            value=expr(
                lambda env, _a=actualn, _t=tot, _w=workers: fig6_rem0(
                    env[_a], env[_t], env[_w]),
                actualn, tot, workers, label=f"{actualn}%{tot}+{workers}",
            ),
            declare_local=True,
        ),
        par_body,
        Break(),
    )

    # ---- serial block ---------------------------------------------------------
    if not clocked:
        # Re-check idle workers after each iteration (Fig. 6).
        serial_arm = seq(
            Assign(target=resume, value=const(False), declare_local=True),
            Assign(target=si, value=var(ii), declare_local=True),
            While(
                cond=expr(
                    lambda env, _s=si: env[_s] < hi.fn(env),
                    si, *hi.reads, label=f"{si}<{hi.label}",
                ),
                body=seq(
                    iter_loop(var(si), binop("+", var(si), const(1)),
                              pl.async_.body),
                    Assign(target=si, value=binop("+", var(si), const(1))),
                    Assign(target=workers, value=idle_workers()),
                    If(
                        cond=expr(
                            lambda env, _w=workers, _s=si,
                            _k=serial_check_every: env[_w] > 0
                            and (hi.fn(env) - env[_s]) >= 2
                            and env[_s] % _k == 0,
                            workers, si, *hi.reads,
                            label=f"{workers}>0&&left>=2&&si%k==0",
                        ),
                        then=seq(
                            Assign(target=ii, value=var(si)),
                            Assign(target=resume, value=const(True)),
                            Break(),
                        ),
                    ),
                ),
            ),
            If(
                cond=expr(lambda env, _r=resume: not env[_r], resume,
                          label=f"!{resume}"),
                then=Break(),
            ),
        )
    else:
        # Fig. 7(c): run a whole phase serially, advance, then re-check once
        # per phase boundary (the paper deliberately does NOT re-check per
        # iteration here, §3.2.3 last paragraph).
        serial_parts: List[Stmt] = [
            Assign(target=resume, value=const(False), declare_local=True),
        ]
        for p, ph in enumerate(pl.phases):
            run_phase = seq(
                _phase_guard(
                    phase, p,
                    seq(
                        iter_loop(lo, hi, ph),
                        *( [Barrier()] if p < nphases - 1 else [] ),
                        *(
                            [
                                Assign(target=workers, value=idle_workers()),
                                If(
                                    cond=expr(
                                        lambda env, _w=workers: env[_w] > 0,
                                        workers, label=f"{workers}>0",
                                    ),
                                    then=seq(
                                        Assign(target=phase,
                                               value=const(p + 1)),
                                        Assign(target=resume,
                                               value=const(True)),
                                        Break(),
                                    ),
                                ),
                            ]
                            if p < nphases - 1
                            else []
                        ),
                    ),
                )
            )
            serial_parts.append(run_phase)
        # Wrap phases in a one-shot loop so Break above exits cleanly.
        serial_arm = seq(
            Assign(target=resume, value=const(False), declare_local=True),
            While(
                cond=expr(lambda env: True, label="true"),
                body=seq(*serial_parts[1:], Break()),
            ),
            If(
                cond=expr(lambda env, _r=resume: not env[_r], resume,
                          label=f"!{resume}"),
                then=Break(),
            ),
        )

    if min_parallel and not clocked:
        # §6(c): no idle workers → still split into (spawned, parent) halves.
        mid = fresh("mid")
        split_body = iter_loop(var(ii), var(mid), pl.async_.body)
        parent_half = iter_loop(var(mid), hi, pl.async_.body)
        two_way = seq(
            Assign(
                target=mid,
                value=expr(lambda env, _i=ii: (env[_i] + hi.fn(env)) // 2,
                           ii, *hi.reads, label=f"({ii}+{hi.label})/2"),
                declare_local=True,
            ),
            Async(body=split_body, clocks=pl.async_.clocks),
            parent_half,
            Break(),
        )
        serial_arm_final = Finish(body=two_way) if with_finish else two_way
        if not with_finish:
            serial_arm_final = seq(two_way)
    else:
        serial_arm_final = serial_arm

    out = seq(
        Assign(target=ii, value=lo, declare_local=True),
        Assign(target=phase, value=const(0), declare_local=True),
        Assign(target=workers, value=idle_workers(), declare_local=True),
        While(
            cond=expr(lambda env: True, label="true"),
            body=seq(
                If(
                    cond=expr(lambda env, _w=workers: env[_w] > 0, workers,
                              label=f"{workers}>0"),
                    then=parallel_arm,
                    els=serial_arm_final,
                ),
                # Re-entering the parallel arm: refresh the worker count the
                # serial block observed (it stored it in ``workers``).
            ),
        ),
    )
    return out


# ---------------------------------------------------------------------------
# Whole-program application
# ---------------------------------------------------------------------------


def apply_dlbc(prog: Program, *, serial_check_every: int = 1,
               min_parallel: bool = False) -> Program:
    """Apply DLBC to every chunkable parallel loop.

    Two patterns are handled:

    * ``Finish(for(async B))`` — DLBC emits its own finish around the
      chunked+parent blocks (Fig. 6, DLBC applied alone);
    * a bare ``for(async B)`` whose tasks escape (AFE already pulled the
      finish) — no new finish is emitted; spawned chunks escape to the one
      outer join (the DCAFE composition).
    """
    from .analysis import bound_locals

    summaries = Summaries.compute(prog)

    def rw_method(m: MethodDef) -> MethodDef:
        private = frozenset(m.params) | bound_locals(m.body)

        def rw(s: Stmt) -> Stmt:
            # Pattern 1: finish { for { async } }  (match before recursing so
            # the finish and loop are consumed together).
            if isinstance(s, Finish) and not s.exlist:
                inner = s.body
                while isinstance(inner, Seq) and len(inner.stmts) == 1:
                    inner = inner.stmts[0]
                pl = match_parallel_loop(inner)
                if pl is not None and chunkable(pl, summaries, private):
                    pl = replace(pl,
                                 async_=replace(pl.async_,
                                                body=rw(pl.async_.body)))
                    pl.phases[:] = split_phases(pl.async_.body)
                    return dlbc_loop(pl, with_finish=True,
                                     serial_check_every=serial_check_every,
                                     min_parallel=min_parallel)
            pl = match_parallel_loop(s)
            if pl is not None and chunkable(pl, summaries, private):
                pl = replace(pl,
                             async_=replace(pl.async_, body=rw(pl.async_.body)))
                pl.phases[:] = split_phases(pl.async_.body)
                return dlbc_loop(pl, with_finish=False,
                                 serial_check_every=serial_check_every,
                                 min_parallel=min_parallel)
            kids = [rw(c) for c in children(s)]
            return rebuild(s, kids) if kids else s

        return replace(m, body=rw(m.body))

    return Program(
        methods=tuple(rw_method(m) for m in prog.methods),
        main=prog.main,
    )


def apply_dcafe(prog: Program, *, assume_no_exceptions: bool = False):
    """DCAFE = AFE ∘ DLBC (paper Fig. 3: MHP → AFE → DLBC → codegen)."""
    from .afe import apply_afe

    afe_prog, report = apply_afe(prog, assume_no_exceptions=assume_no_exceptions)
    return apply_dlbc(afe_prog), report
