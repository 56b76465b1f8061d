"""Dataflow graphs: logical operators → physical tasks → failure regions.

Region derivation follows Flink: tasks connected by *pipelined* channels
must recover together; the physical connected components of the channel
graph are the failure-recovery regions. Pointwise hops (forward / rescale
pairs) keep chains separate — a DS-style source→sink pipeline yields one
region per parallel chain — while any all-to-all hop (hash / rebalance /
backlog / weakhash) merges everything it touches (the SS join case).

A verbatim copy of ``src/repro/streams/graph.py`` (plain numpy): the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

POINTWISE = ("forward",)
ALL_TO_ALL = ("hash", "rebalance", "backlog", "weakhash", "group_rescale",
              "rescale")


@dataclasses.dataclass(frozen=True)
class LogicalOp:
    name: str
    parallelism: int
    service_rate: float            # records/s per task at speed 1
    selectivity: float = 1.0       # output records per input record
    is_source: bool = False
    state_bytes_per_task: int = 0  # checkpoint size
    source_rate: float = 0.0       # records/s (whole op) when is_source


@dataclasses.dataclass(frozen=True)
class LogicalEdge:
    src: str
    dst: str
    partitioner: str = "rebalance"     # see core/backlog_shuffle.py names
    n_groups: int = 1                  # for group_rescale / weakhash
    key_skew_zipf: float = 0.0         # >0: keyed traffic with Zipf skew


@dataclasses.dataclass(frozen=True)
class LogicalGraph:
    name: str
    ops: tuple[LogicalOp, ...]
    edges: tuple[LogicalEdge, ...]

    def op(self, name: str) -> LogicalOp:
        return next(o for o in self.ops if o.name == name)

    def downstream(self, name: str) -> list[LogicalEdge]:
        return [e for e in self.edges if e.src == name]

    def upstream(self, name: str) -> list[LogicalEdge]:
        return [e for e in self.edges if e.dst == name]

    def topo_order(self) -> list[str]:
        return list(_topo_order(self))


@functools.lru_cache(maxsize=None)
def _topo_order(g: "LogicalGraph") -> tuple[str, ...]:
    """Cached DFS topo order (graphs are frozen/hashable; the engine asks
    for the order every tick, so recomputing the DFS would dominate small
    graphs' tick time)."""
    order, seen = [], set()

    def visit(n):
        if n in seen:
            return
        seen.add(n)
        for e in g.upstream(n):
            visit(e.src)
        order.append(n)

    for o in g.ops:
        visit(o.name)
    return tuple(order)


def namespaced(graph: LogicalGraph, prefix: str) -> LogicalGraph:
    """Clone `graph` with every op (and edge endpoint) renamed
    ``prefix + name`` — the building block of multi-job arena packing
    (`streams.engine.pack_arena`): namespacing keeps op names unique when
    several jobs' graphs are concatenated into one arena, while the
    per-job structure (edges, partitioners, rates) is untouched."""
    return LogicalGraph(
        graph.name,
        ops=tuple(dataclasses.replace(o, name=prefix + o.name)
                  for o in graph.ops),
        edges=tuple(dataclasses.replace(e, src=prefix + e.src,
                                        dst=prefix + e.dst)
                    for e in graph.edges))


@dataclasses.dataclass
class Task:
    op: str
    index: int
    task_id: int
    host: int


@dataclasses.dataclass
class PhysicalGraph:
    logical: LogicalGraph
    tasks: list[Task]
    # channels[(src_op, dst_op)] = (n_src, n_dst, connectivity)  where
    # connectivity is bool (n_src, n_dst)
    channels: dict[tuple[str, str], np.ndarray]
    regions: list[set[int]]          # sets of task_ids
    task_region: dict[int, int]

    def tasks_of(self, op: str) -> list[Task]:
        return [t for t in self.tasks if t.op == op]


def expand(graph: LogicalGraph, *, n_hosts: int,
           seed: int = 0) -> PhysicalGraph:
    """Logical → physical: instantiate tasks, place them on hosts
    round-robin (co-location emerges naturally), derive channels + regions."""
    tasks: list[Task] = []
    tid = 0
    for op in graph.ops:
        for i in range(op.parallelism):
            tasks.append(Task(op.name, i, tid, host=tid % n_hosts))
            tid += 1
    by_op = {op.name: [t for t in tasks if t.op == op.name]
             for op in graph.ops}

    channels: dict[tuple[str, str], np.ndarray] = {}
    for e in graph.edges:
        ns, nd = len(by_op[e.src]), len(by_op[e.dst])
        conn = np.zeros((ns, nd), bool)
        if e.partitioner == "forward":
            assert ns == nd, (e, ns, nd)
            conn[np.arange(ns), np.arange(nd)] = True
        elif e.partitioner == "rescale":
            # each src connects to a contiguous block of dsts
            per = max(1, nd // ns)
            for s in range(ns):
                lo = (s * per) % nd
                conn[s, lo:lo + per] = True
        elif e.partitioner == "group_rescale":
            g = e.n_groups
            for s in range(ns):
                grp = s * g // ns
                lo, hi = grp * nd // g, (grp + 1) * nd // g
                conn[s, lo:hi] = True
        else:  # all-to-all family
            conn[:] = True
        channels[(e.src, e.dst)] = conn

    # regions = connected components over channel connectivity. For
    # component purposes a src connected to a dst-set only needs a union
    # with ONE member, plus unions chaining the dst-set itself ("hub"
    # unions) — O(ns + nd) per edge instead of O(nnz), which matters for
    # all-to-all hops at large parallelism.
    parent = list(range(len(tasks)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for e in graph.edges:
        conn = channels[(e.src, e.dst)]
        st, dtt = by_op[e.src], by_op[e.dst]
        if e.partitioner not in POINTWISE and conn.all():
            # all-to-all: everything merges into one component
            hub = dtt[0].task_id
            for t in st:
                union(t.task_id, hub)
            for t in dtt[1:]:
                union(t.task_id, hub)
            continue
        # pointwise / blocky hops: first connected dst per src acts as the
        # row hub; the rest of the row chains to it once (rows produced by
        # forward/rescale/group_rescale that share a first dst are
        # identical blocks, so one chaining per hub suffices)
        chained: set[int] = set()
        for s, row in enumerate(conn):
            dd = np.nonzero(row)[0]
            if len(dd) == 0:
                continue
            hub = dtt[dd[0]].task_id
            union(st[s].task_id, hub)
            if hub not in chained:
                chained.add(hub)
                for d in dd[1:]:
                    union(dtt[d].task_id, hub)

    groups: dict[int, set[int]] = {}
    for t in tasks:
        groups.setdefault(find(t.task_id), set()).add(t.task_id)
    regions = sorted(groups.values(), key=lambda s: min(s))
    task_region = {t: r for r, s in enumerate(regions) for t in s}
    return PhysicalGraph(graph, tasks, channels, regions, task_region)
