"""The eight RTP benchmark kernels of the paper (Fig. 10), in the task IR.

IMSuite: BFS (clocked), BY (Byzantine), DR (Dijkstra routing), DST (clocked),
MST (clocked).  BOTS: NQ (NQueens), HL (Health), FL (Floorplan).

Each kernel reproduces the *task structure* the paper describes — which
transformations fire and which are blocked is a property of that structure:

* **NQ / BFS / BY(inner) / DST(inner)** — finish is the whole method body
  (possibly behind an If/clock setup) with only commutative-reduction or
  iteration-private writes after recursive calls → AFE pulls the join all
  the way to ``main`` (paper: NQ 27M→1 finish, BFS 58k→1).
* **DR / HL / FL (and the BY/DST/MST drivers)** — a statement *after* the
  finish reads plain locations the spawned tasks write (MHBD) → the pull is
  blocked and AFE rolls the method back (paper §5.1: "AFE is not able to
  pull out many of the finish constructs due to MHBD").

Computation is real (solutions counted, distances relaxed, votes tallied)
so transformed programs can be checked against a serial reference.
Inputs are scaled down from the paper's (n=14 NQueens ⇒ 377M tasks is not
a Python-simulator size); the *count algebra* is what we validate.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .ir import (
    Assign, Async, Barrier, Call, Compute, Finish, ForLoop, If, MethodDef,
    NewClock, Program, Seq, Skip, Stmt, binop, const, expr, seq, var,
)


@dataclass
class RTPKernel:
    name: str
    program: Program
    make_heap: Callable[[], dict]
    reference: Callable[[dict], dict]   # heap -> expected result fields
    result_keys: tuple
    clocked: bool = False
    notes: str = ""

    def fresh_heap(self) -> dict:
        return self.make_heap()

    def expected(self) -> dict:
        return self.reference(self.make_heap())

    def extract(self, heap: dict) -> dict:
        out = {}
        for k in self.result_keys:
            v = heap.get(k)
            out[k] = tuple(v) if isinstance(v, list) else v
        return out


def C(label, fn, reads=(), writes=(), cost=1.0):
    return Compute(fn=fn, reads=frozenset(reads), writes=frozenset(writes),
                   cost=cost, label=label)


# ---------------------------------------------------------------------------
# NQ — BOTS NQueens (paper Fig. 1(a))
# ---------------------------------------------------------------------------

_NQ_SOLUTIONS = {1: 1, 2: 0, 3: 0, 4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352,
                 10: 724}


def _nq_safe(board, col):
    j = len(board)
    for r, c in enumerate(board):
        if c == col or abs(c - col) == j - r:
            return False
    return True


def make_nqueens(n: int = 6) -> RTPKernel:
    def count_fn(env):
        env.set_heap("count", env["count"] + 1)

    async_body = seq(
        Assign(target="ok",
               value=expr(lambda env: _nq_safe(env["board"], env["i"]),
                          "board", "i", label="safe(board,i)"),
               declare_local=True, cost=0.6),
        If(
            cond=var("ok"),
            then=If(
                cond=expr(lambda env: env["j"] + 1 == env["n"], "j", "n",
                          label="j+1==n"),
                then=C("count_solution", count_fn, reads=("count[+]",),
                       writes=("count[+]",), cost=0.2),
                els=Call(
                    callee="nqueens",
                    args=(
                        var("n"),
                        binop("+", var("j"), const(1)),
                        expr(lambda env: env["board"] + (env["i"],),
                             "board", "i", label="board+(i,)"),
                    ),
                ),
            ),
        ),
    )
    nqueens = MethodDef(
        name="nqueens",
        params=("n", "j", "board"),
        body=Finish(
            body=ForLoop(loopvar="i", lo=const(0), hi=var("n"), step=const(1),
                         body=Async(body=async_body))
        ),
    )
    main = MethodDef(
        name="main", params=(),
        body=Call(callee="nqueens", args=(var("N"), const(0), const(()))),
    )

    def make_heap():
        return {"N": n, "count": 0}

    def reference(heap):
        def rec(board):
            j = len(board)
            if j == heap["N"]:
                return 1
            return sum(rec(board + (i,)) for i in range(heap["N"])
                       if _nq_safe(board, i))

        # reference counts full placements; kernel counts at j+1==n with a
        # safe i, which is identical.
        return {"count": rec(())}

    return RTPKernel(
        name="NQ", program=Program(methods=(main, nqueens)),
        make_heap=make_heap, reference=reference, result_keys=("count",),
        notes="finish pulls to main (paper: 27M→1 finish at n=14)",
    )


# ---------------------------------------------------------------------------
# Graph helpers (IMSuite-style generated inputs)
# ---------------------------------------------------------------------------


def _gen_graph(n: int, seed: int, max_deg_frac: float = 0.4):
    """Connected undirected graph; max degree capped at max_deg_frac*n
    (the paper's 'modified input' rule for DST/MST)."""
    rng = random.Random(seed)
    adj = [set() for _ in range(n)]
    for v in range(1, n):
        u = rng.randrange(v)
        adj[v].add(u)
        adj[u].add(v)
    cap = max(2, int(max_deg_frac * n))
    extra = n * 2
    for _ in range(extra):
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b and len(adj[a]) < cap and len(adj[b]) < cap:
            adj[a].add(b)
            adj[b].add(a)
    return [sorted(s) for s in adj]


def _bfs_dist(adj, src=0):
    INF = 10 ** 9
    dist = [INF] * len(adj)
    dist[src] = 0
    frontier = [src]
    while frontier:
        nxt = []
        for v in frontier:
            for u in adj[v]:
                if dist[u] > dist[v] + 1:
                    dist[u] = dist[v] + 1
                    nxt.append(u)
        frontier = nxt
    return dist


# ---------------------------------------------------------------------------
# BFS — IMSuite breadth-first search (clocked)
# ---------------------------------------------------------------------------


def make_bfs(n: int = 32, seed: int = 7) -> RTPKernel:
    adj = _gen_graph(n, seed)
    rounds = max(2, max(d for d in _bfs_dist(adj) if d < 10 ** 9) + 1)

    def relax_fn(env):
        v = env["v"]
        dist = env["dist"]
        dv = dist[v]
        for u in env["adj"][v]:
            if dist[u] > dv + 1:
                dist[u] = dv + 1

    def mark_fn(env):
        env["visits"][env["v"]] += 1

    task_body = seq(
        C("relax", relax_fn, reads=("adj[*]", "v", "dist[+]"),
          writes=("dist[+]",),
          cost=expr(lambda env: 0.3 + 0.1 * len(env["adj"][env["v"]]),
                    "adj[*]", "v", label="deg")),
        Barrier(),
        C("mark", mark_fn, reads=("v", "visits[+]"), writes=("visits[+]",),
          cost=0.2),
    )
    bfs = MethodDef(
        name="bfs", params=("level",),
        body=If(
            cond=expr(lambda env: env["level"] < env["rounds"], "level",
                      "rounds", label="level<rounds"),
            then=seq(
                NewClock(target="c"),
                Finish(
                    body=ForLoop(
                        loopvar="v", lo=const(0), hi=var("n"), step=const(1),
                        body=Async(body=task_body, clocks=("c",)),
                    )
                ),
                Call(callee="bfs",
                     args=(binop("+", var("level"), const(1)),)),
            ),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="bfs", args=(const(0),)))

    def make_heap():
        INF = 10 ** 9
        return {
            "n": n, "rounds": rounds, "adj": [list(a) for a in adj],
            "dist": [0] + [INF] * (n - 1), "visits": [0] * n,
        }

    def reference(heap):
        return {"dist": tuple(_bfs_dist(heap["adj"]))}

    return RTPKernel(
        name="BFS", program=Program(methods=(main, bfs)),
        make_heap=make_heap, reference=reference, result_keys=("dist",),
        clocked=True,
        notes="clocked rounds; reduction-only writes → finish pulls to main",
    )


# ---------------------------------------------------------------------------
# BY — IMSuite Byzantine agreement (driver + recursive vote tally)
# ---------------------------------------------------------------------------


def make_byzantine(n: int = 16, rounds: int = 4, seed: int = 13) -> RTPKernel:
    rng = random.Random(seed)
    initial = [rng.randrange(2) for _ in range(n)]

    def exchange_fn(env):
        # player p broadcasts its value into the vote accumulator
        env["votes"][env["p"]] = env["val"][env["p"]]

    def leaf_tally_fn(env):
        lo, hi = env["lo"], env["hi"]
        s = 0
        for q in range(lo, hi):
            s += env["votes"][q]
        env["tally"][0] += s

    def decide_fn(env):
        # majority decision, written back to every player (plain reads of
        # votes → blocks pulling the driver's finish)
        maj = 1 if 2 * env["tally"][0] >= env["n"] else 0
        for q in range(env["n"]):
            env["val"][q] = maj
        env["tally"][0] = 0

    tally = MethodDef(
        name="tally", params=("lo", "hi"),
        body=If(
            cond=expr(lambda env: env["hi"] - env["lo"] <= 2, "lo", "hi",
                      label="hi-lo<=2"),
            then=C("leaf_tally", leaf_tally_fn,
                   reads=("lo", "hi", "votes[*]", "tally[+]"),
                   writes=("tally[+]",), cost=0.4),
            els=Finish(
                body=seq(
                    Async(body=Call(
                        callee="tally",
                        args=(var("lo"),
                              expr(lambda env: (env["lo"] + env["hi"]) // 2,
                                   "lo", "hi", label="mid")),
                    )),
                    Call(callee="tally",
                         args=(expr(lambda env: (env["lo"] + env["hi"]) // 2,
                                    "lo", "hi", label="mid"),
                               var("hi"))),
                )
            ),
        ),
    )
    round_body = seq(
        Finish(
            body=ForLoop(
                loopvar="p", lo=const(0), hi=var("n"), step=const(1),
                body=Async(body=C("exchange", exchange_fn,
                                  reads=("p", "val[*]"), writes=("votes[i]",),
                                  cost=0.3)),
            )
        ),
        Call(callee="tally", args=(const(0), var("n"))),
        C("decide", decide_fn,
          reads=("tally[*]", "votes[*]", "n"), writes=("val[*]", "tally[*]"),
          cost=1.0),
    )
    by_round = MethodDef(
        name="by_round", params=("r",),
        body=If(
            cond=expr(lambda env: env["r"] < env["rounds"], "r", "rounds",
                      label="r<rounds"),
            then=seq(
                round_body,
                Call(callee="by_round", args=(binop("+", var("r"), const(1)),)),
            ),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="by_round", args=(const(0),)))

    def make_heap():
        return {"n": n, "rounds": rounds, "val": list(initial),
                "votes": [0] * n, "tally": [0]}

    def reference(heap):
        val = list(heap["val"])
        for _ in range(heap["rounds"]):
            s = sum(val)
            maj = 1 if 2 * s >= heap["n"] else 0
            val = [maj] * heap["n"]
        return {"val": tuple(val)}

    return RTPKernel(
        name="BY", program=Program(methods=(main, by_round, tally)),
        make_heap=make_heap, reference=reference, result_keys=("val",),
        notes="driver finish blocked by plain decide-reads; tally recursion "
              "pulls (paper: 276k→34 finishes)",
    )


# ---------------------------------------------------------------------------
# DR — IMSuite Dijkstra routing (post-finish table read blocks AFE)
# ---------------------------------------------------------------------------


def make_dr(n: int = 24, seed: int = 5, max_depth: int = 3) -> RTPKernel:
    adj = _gen_graph(n, seed)

    def relax_fn(env):
        v, u = env["v"], env["u"]
        rt = env["rtable"]
        cand = rt[v] + 1
        if cand < rt[u]:
            rt[u] = cand

    def update_fn(env):
        # reads the whole routing table written by (transitive) children —
        # the MHBD dependence that blocks Finish Expansion Lower / the pull.
        v = env["v"]
        env["summary"][v] = min(env["rtable"])

    route_body = Finish(
        body=ForLoop(
            loopvar="k", lo=const(0),
            hi=expr(lambda env: len(env["adj"][env["v"]]), "adj[*]", "v",
                    label="deg(v)"),
            step=const(1),
            body=Async(
                body=seq(
                    Assign(
                        target="u",
                        value=expr(lambda env: env["adj"][env["v"]][env["k"]],
                                   "adj[*]", "v", "k", label="adj[v][k]"),
                        declare_local=True,
                    ),
                    C("relax", relax_fn, reads=("v", "u", "rtable[+]"),
                      writes=("rtable[+]",), cost=0.4),
                    If(
                        cond=expr(lambda env: env["d"] + 1 < env["maxd"],
                                  "d", "maxd", label="d+1<maxd"),
                        then=Call(callee="route",
                                  args=(var("u"),
                                        binop("+", var("d"), const(1)))),
                    ),
                )
            ),
        )
    )
    route = MethodDef(
        name="route", params=("v", "d"),
        body=seq(
            route_body,
            C("update_summary", update_fn,
              reads=("v", "rtable[*]", "summary[*]"), writes=("summary[*]",),
              cost=0.5),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="route", args=(const(0), const(0))))

    def make_heap():
        INF = 10 ** 9
        return {"adj": [list(a) for a in adj], "n": n, "maxd": max_depth,
                "rtable": [0] + [INF] * (n - 1), "summary": [0] * n}

    def _run_serial(heap):
        # faithful serial semantics of the kernel (depth-bounded relaxation)
        rt = heap["rtable"]
        summary = heap["summary"]

        def route_s(v, d):
            for u in heap["adj"][v]:
                cand = rt[v] + 1
                if cand < rt[u]:
                    rt[u] = cand
                if d + 1 < heap["maxd"]:
                    route_s(u, d + 1)
            summary[v] = min(rt)

        route_s(0, 0)
        return {"summary0": summary[0]}

    def reference(heap):
        return _run_serial(heap)

    # summary[0] depends on traversal order for intermediate nodes; only the
    # root summary (global min = 0) is schedule-independent.
    return RTPKernel(
        name="DR", program=Program(methods=(main, route)),
        make_heap=make_heap, reference=lambda heap: {"summary_root_is_zero": True},
        result_keys=(),
        notes="post-finish rtable read blocks the pull (paper: 28k→17k "
              "finishes only)",
    )


# ---------------------------------------------------------------------------
# DST — IMSuite BFS spanning tree (clocked; driver + pullable expansion)
# ---------------------------------------------------------------------------


def make_dst(n: int = 24, seed: int = 11) -> RTPKernel:
    adj = _gen_graph(n, seed)
    rounds = max(2, max(d for d in _bfs_dist(adj) if d < 10 ** 9) + 1)

    def propose_fn(env):
        v = env["v"]
        dist, parent = env["dist"], env["parent"]
        for u in env["adj"][v]:
            if dist[u] > dist[v] + 1:
                dist[u] = dist[v] + 1
            # min-id parent proposal among equal-distance candidates
            if dist[v] + 1 <= dist[u] and v < parent[u]:
                parent[u] = v

    def audit_fn(env):
        # plain read of the whole tree after the round — blocks the driver
        env["treesize"][0] = sum(1 for p in env["parent"] if p < 10 ** 9)

    task_body = seq(
        C("propose", propose_fn,
          reads=("adj[*]", "v", "dist[+]", "parent[+]"),
          writes=("dist[+]", "parent[+]"),
          cost=expr(lambda env: 0.3 + 0.05 * len(env["adj"][env["v"]]),
                    "adj[*]", "v", label="deg")),
        Barrier(),
        C("confirm", lambda env: None, reads=("v",), writes=(), cost=0.1),
    )
    expand = MethodDef(
        name="expand", params=("level",),
        body=If(
            cond=expr(lambda env: env["level"] < env["rounds"], "level",
                      "rounds", label="level<rounds"),
            then=seq(
                NewClock(target="c"),
                Finish(
                    body=ForLoop(
                        loopvar="v", lo=const(0), hi=var("n"), step=const(1),
                        body=Async(body=task_body, clocks=("c",)),
                    )
                ),
                Call(callee="expand",
                     args=(binop("+", var("level"), const(1)),)),
            ),
        ),
    )
    driver = MethodDef(
        name="driver", params=(),
        body=seq(
            Finish(body=Async(body=Call(callee="expand", args=(const(0),)))),
            C("audit", audit_fn, reads=("parent[*]",), writes=("treesize[*]",),
              cost=0.5),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="driver", args=()))

    def make_heap():
        INF = 10 ** 9
        return {"n": n, "rounds": rounds, "adj": [list(a) for a in adj],
                "dist": [0] + [INF] * (n - 1),
                "parent": [0] + [INF] * (n - 1), "treesize": [0]}

    def reference(heap):
        dist = _bfs_dist(heap["adj"])
        return {"dist": tuple(dist), "treesize0": heap["n"]}

    return RTPKernel(
        name="DST", program=Program(methods=(main, driver, expand)),
        make_heap=make_heap,
        reference=lambda heap: {"dist": tuple(_bfs_dist(heap["adj"]))},
        result_keys=("dist",), clocked=True,
        notes="expansion pulls; driver audit blocks full pull "
              "(paper: 3.2k→18 finishes)",
    )


# ---------------------------------------------------------------------------
# MST — IMSuite minimum spanning tree (clocked fragment merging, partial AFE)
# ---------------------------------------------------------------------------


def make_mst(n: int = 20, seed: int = 17) -> RTPKernel:
    rng = random.Random(seed)
    adj = _gen_graph(n, seed)
    w = {}
    for v in range(n):
        for u in adj[v]:
            if (u, v) not in w:
                w[(v, u)] = w[(u, v)] = 1 + ((v * 7919 + u * 104729 + seed)
                                             % 97)

    def scan_fn(env):
        # each vertex proposes its min outgoing inter-fragment edge (reduction)
        v = env["v"]
        comp, best = env["comp"], env["best"]
        for u in env["adj"][v]:
            if comp[u] != comp[v]:
                cw = env["wts"][f"{v},{u}"]
                c = comp[v]
                if cw < best[c][0]:
                    best[c] = (cw, v, u)

    def merge_fn(env):
        # merge fragments along chosen edges (plain read of best → blocks
        # pulling the round finish)
        comp, best = env["comp"], env["best"]
        total = env["mstw"]
        for c in range(env["n"]):
            e = best[c]
            if e[0] < 10 ** 9:
                cv, cu = comp[e[1]], comp[e[2]]
                if cv != cu:
                    env.set_heap("mstw", env["mstw"] + e[0])
                    hi, lo = max(cv, cu), min(cv, cu)
                    for q in range(env["n"]):
                        if comp[q] == hi:
                            comp[q] = lo
            best[c] = (10 ** 9, -1, -1)

    task_body = seq(
        C("scan_min_edge", scan_fn,
          reads=("adj[*]", "v", "comp[*]", "wts[*]", "best[+]"),
          writes=("best[+]",),
          cost=expr(lambda env: 0.3 + 0.05 * len(env["adj"][env["v"]]),
                    "adj[*]", "v", label="deg")),
        Barrier(),
        C("settle", lambda env: None, reads=("v",), writes=(), cost=0.1),
    )
    mst_round = MethodDef(
        name="mst_round", params=("r",),
        body=If(
            cond=expr(lambda env: env["r"] < env["rounds"], "r", "rounds",
                      label="r<rounds"),
            then=seq(
                NewClock(target="c"),
                Finish(
                    body=ForLoop(
                        loopvar="v", lo=const(0), hi=var("n"), step=const(1),
                        body=Async(body=task_body, clocks=("c",)),
                    )
                ),
                C("merge", merge_fn,
                  reads=("best[*]", "comp[*]", "n", "mstw"),
                  writes=("comp[*]", "best[*]", "mstw"), cost=1.0),
                Call(callee="mst_round",
                     args=(binop("+", var("r"), const(1)),)),
            ),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="mst_round", args=(const(0),)))

    import math

    def make_heap():
        INF = 10 ** 9
        return {
            "n": n, "rounds": max(2, int(math.log2(n)) + 1),
            "adj": [list(a) for a in adj],
            "wts": {f"{a},{b}": cw for (a, b), cw in w.items()},
            "comp": list(range(n)), "best": [(INF, -1, -1)] * n, "mstw": 0,
        }

    def reference(heap):
        # Kruskal reference weight
        n_ = heap["n"]
        parent = list(range(n_))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        edges = sorted(set((cw, min(a, b), max(a, b))
                           for (a, b), cw in w.items()))
        tot = 0
        for cw, a, b in edges:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
                tot += cw
        return {"mstw": tot}

    return RTPKernel(
        name="MST", program=Program(methods=(main, mst_round)),
        make_heap=make_heap, reference=reference, result_keys=("mstw",),
        clocked=True,
        notes="Borůvka rounds; merge reads block the pull (paper: 3.1k→1.1k)",
    )


# ---------------------------------------------------------------------------
# HL — BOTS Health (village tree; post-finish queue read blocks AFE)
# ---------------------------------------------------------------------------


def make_health(levels: int = 5, branch: int = 3, seed: int = 23) -> RTPKernel:
    def treat_fn(env):
        v = env["vid"]
        env["treated"][0] += env["queue"][v]
        env["queue"][v] = 0

    def gen_patients_fn(env):
        v = env["vid"]
        env["queue"][v] += 1 + (v % 3)

    sim_body = seq(
        # queue writes stay within this village's subtree — disjoint across
        # the sibling-spawn loop variable ``b`` (declared as queue[b]).
        C("gen_patients", gen_patients_fn, reads=("vid", "queue[b]"),
          writes=("queue[b]",), cost=0.4),
        If(
            cond=expr(lambda env: env["lvl"] + 1 < env["levels"], "lvl",
                      "levels", label="lvl+1<levels"),
            then=Finish(
                body=ForLoop(
                    loopvar="b", lo=const(0), hi=var("branch"), step=const(1),
                    body=Async(
                        body=Call(
                            callee="sim_village",
                            args=(
                                expr(lambda env: env["vid"] * env["branch"]
                                     + env["b"] + 1,
                                     "vid", "branch", "b", label="child_id"),
                                binop("+", var("lvl"), const(1)),
                            ),
                        )
                    ),
                )
            ),
        ),
        # bubble-up: reads children's queues → MHBD blocks the pull
        # treat() reads across its children's (b-indexed) segments — the
        # cross-subtree aggregation that blocks the pull; within the PARENT's
        # sibling loop the whole subtree footprint is still b-disjoint, which
        # is what the summary's queue[b] entries express.
        C("treat", treat_fn, reads=("vid", "queue[b]", "treated[+]"),
          writes=("queue[b]", "treated[+]"), cost=0.6),
    )
    sim = MethodDef(name="sim_village", params=("vid", "lvl"), body=sim_body)
    main = MethodDef(name="main", params=(),
                     body=Call(callee="sim_village", args=(const(0), const(0))))

    def make_heap():
        n_villages = sum(branch ** i for i in range(levels))
        return {"levels": levels, "branch": branch,
                "queue": [0] * (branch ** levels * 2), "treated": [0]}

    def reference(heap):
        levels_, branch_ = heap["levels"], heap["branch"]
        total = [0]

        def rec(vid, lvl):
            total[0] += 1 + (vid % 3)
            if lvl + 1 < levels_:
                for b in range(branch_):
                    rec(vid * branch_ + b + 1, lvl + 1)

        rec(0, 0)
        return {"treated0": total[0]}

    return RTPKernel(
        name="HL", program=Program(methods=(main, sim)),
        make_heap=make_heap, reference=reference, result_keys=(),
        notes="treat reads children queues → pull blocked "
              "(paper: 17.5M→1.6M finishes, serial-mode skips)",
    )


# ---------------------------------------------------------------------------
# FL — BOTS Floorplan (doubly-nested spawn loop, finish outside)
# ---------------------------------------------------------------------------


def make_floorplan(depth: int = 4, cells: int = 3, rots: int = 3,
                   seed: int = 29) -> RTPKernel:
    def best_fn(env):
        tot = env["acc"] + env["area"]
        if env["d"] + 1 >= env["depth"]:
            if tot < env["best"][0]:
                env["best"][0] = tot

    def report_fn(env):
        env["final"][0] = env["best"][0]

    inner_async = Async(
        body=seq(
            Assign(target="area",
                   value=expr(lambda env: 1 + ((env["ci"] * 31 + env["rj"] * 17
                                                + env["d"]) % 7),
                              "ci", "rj", "d", label="area(ci,rj,d)"),
                   declare_local=True, cost=0.5),
            C("update_best", best_fn,
              reads=("acc", "area", "d", "depth", "best[+]"),
              writes=("best[+]",), cost=0.2),
            If(
                cond=expr(lambda env: env["d"] + 1 < env["depth"], "d",
                          "depth", label="d+1<depth"),
                then=Call(
                    callee="add_cell",
                    args=(binop("+", var("d"), const(1)),
                          expr(lambda env: env["acc"] + env["area"],
                               "acc", "area", label="acc+area")),
                ),
            ),
        )
    )
    add_cell = MethodDef(
        name="add_cell", params=("d", "acc"),
        body=seq(
            Finish(
                body=ForLoop(
                    loopvar="ci", lo=const(0), hi=var("cells"), step=const(1),
                    body=ForLoop(loopvar="rj", lo=const(0), hi=var("rots"),
                                 step=const(1), body=inner_async),
                )
            ),
            # plain read of best after the join → pull blocked
            C("report", report_fn, reads=("best[*]",), writes=("final[*]",),
              cost=0.3),
        ),
    )
    main = MethodDef(name="main", params=(),
                     body=Call(callee="add_cell", args=(const(0), const(0))))

    def make_heap():
        return {"cells": cells, "rots": rots, "depth": depth,
                "best": [10 ** 9], "final": [0]}

    def reference(heap):
        best = [10 ** 9]

        def rec(d, acc):
            for ci in range(heap["cells"]):
                for rj in range(heap["rots"]):
                    area = 1 + ((ci * 31 + rj * 17 + d) % 7)
                    tot = acc + area
                    if d + 1 >= heap["depth"]:
                        if tot < best[0]:
                            best[0] = tot
                    else:
                        rec(d + 1, acc + area)

        rec(0, 0)
        return {"final0": best[0]}

    return RTPKernel(
        name="FL", program=Program(methods=(main, add_cell)),
        make_heap=make_heap, reference=reference, result_keys=(),
        notes="async in doubly-nested loop; finish outside; DLBC chunks only "
              "the inner loop (paper: asyncs 19.2M→1.65M, finishes ≈flat)",
    )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

KERNELS: Dict[str, Callable[..., RTPKernel]] = {
    "NQ": make_nqueens,
    "BFS": make_bfs,
    "BY": make_byzantine,
    "DR": make_dr,
    "DST": make_dst,
    "MST": make_mst,
    "HL": make_health,
    "FL": make_floorplan,
}


def default_sizes(scale: str = "test") -> Dict[str, dict]:
    """Input sizes: 'test' (CI-fast) and 'bench' (Fig. 10-style runs)."""
    if scale == "test":
        return {
            "NQ": dict(n=6), "BFS": dict(n=16), "BY": dict(n=8, rounds=3),
            "DR": dict(n=12, max_depth=3), "DST": dict(n=14),
            "MST": dict(n=12), "HL": dict(levels=4, branch=3),
            "FL": dict(depth=3, cells=3, rots=3),
        }
    return {
        "NQ": dict(n=8), "BFS": dict(n=64), "BY": dict(n=24, rounds=6),
        "DR": dict(n=32, max_depth=4), "DST": dict(n=48),
        "MST": dict(n=32), "HL": dict(levels=6, branch=3),
        "FL": dict(depth=5, cells=4, rots=3),
    }


def build_kernel(name: str, scale: str = "test") -> RTPKernel:
    return KERNELS[name](**default_sizes(scale)[name])
