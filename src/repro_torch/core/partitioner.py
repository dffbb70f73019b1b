"""Optimal model partitioning (paper §3.2.1, Algorithm 1).

Pipeline:
  candidate points  ->  transfer sizes t_k = eta(p_k)/lambda (Eq. 4)
                    ->  partition DAG G_p (Eqs. 6-7)
                    ->  memoized min-cost root->leaf path (Algorithm 1)
                    ->  PartitionPlan (dispatcher partition prepended)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bottleneck import DEFAULT_COMPRESSION
from .graph import LayerGraph


class PartitionInfeasible(Exception):
    """No contiguous segmentation fits the node memory capacity."""


class NotPartitionable(Exception):
    """Model DAG has no interior candidate partition points (NASNet-style)."""


@dataclass
class PartitionPlan:
    """Result of Algorithm 1.

    points          -- candidate partition points (layer names), p_0 = source
    runs            -- list of (i, j) index pairs into ``points``; run r owns
                       segments i..j.  runs[0] starts at 0, runs[-1] ends at
                       len(points)-1, and runs are contiguous.
    boundary_sizes  -- compressed bytes crossing each boundary, **including
                       the dispatcher edge first** (len == len(runs)).
                       boundary_sizes[0] = eta(p_0)/lambda (model input);
                       boundary_sizes[r] = t at the cut between run r-1, r.
    partition_layers-- layer names owned by each run (same order as runs)
    memory_bytes    -- omega of each run
    candidate_sizes -- transfer size of *every* candidate point (the paper's
                       distribution used for class binning, §5.2.1)
    compute_flops   -- forward FLOPs per run (emulator compute model)
    lam             -- compression factor the transfer sizes were divided by
                       (recorded so the stage-execution IR can carry it)
    """

    points: list[str]
    runs: list[tuple[int, int]]
    boundary_sizes: list[float]
    partition_layers: list[list[str]]
    memory_bytes: list[float]
    candidate_sizes: list[float]
    compute_flops: list[float]
    total_cost: float
    lam: float = DEFAULT_COMPRESSION

    @property
    def n_partitions(self) -> int:
        return len(self.runs)

    @property
    def n_nodes_required(self) -> int:
        # one node per compute partition + the dispatcher node
        return len(self.runs) + 1


def transfer_sizes(graph: LayerGraph, points: list[str],
                   segs: list[list[str]],
                   lam: float = DEFAULT_COMPRESSION) -> list[float]:
    """t_k for every candidate point (Eq. 4), including side-input bytes that
    a cut after p_k would have to carry (enc-dec / VLM, DESIGN.md §4).
    ``segs`` must be ``graph.segment_layers(points)`` (all callers'); the
    side-input charge comes from the O(1) suffix-max index."""
    return graph.accounting(points, segs).transfer_sizes(lam)


def build_partition_graph(graph: LayerGraph, points: list[str],
                          segs: list[list[str]], capacity_bytes: float):
    """Explicit G_p (Eqs. 6-7): vertices = contiguous runs fitting capacity;
    edge (u, v) iff u ends right before v starts.  Returns (vertices, edges)
    with vertices as (i, j) tuples and edges as {(u, v): cut_index}."""
    acc = graph.accounting(points, segs)
    k = len(points)
    vertices = []
    mem = {}
    mm = acc.memory_matrix()
    stops = acc.fit_stops(capacity_bytes).tolist()
    for i in range(k):
        # memory is non-decreasing in j for fixed i (params only accumulate;
        # shared groups are counted once per run), so runs starting at i fit
        # exactly up to the first unfit j.
        for j in range(i, stops[i]):
            vertices.append((i, j))
            mem[(i, j)] = float(mm[i, j])
    edges = {}
    starts: dict[int, list[tuple[int, int]]] = {}
    for v in vertices:
        starts.setdefault(v[0], []).append(v)
    for (i, j) in vertices:
        for v2 in starts.get(j + 1, ()):
            edges[((i, j), v2)] = j             # cut after points[j]
    return vertices, edges, mem


def optimal_partitions(graph: LayerGraph, capacity_bytes: float,
                       lam: float = DEFAULT_COMPRESSION,
                       points: list[str] | None = None) -> PartitionPlan:
    """Algorithm 1: min-total-transfer segmentation under the memory cap.

    Implemented as the paper's memoized min-cost path on G_p, expressed as a
    suffix DP over candidate-point indices (identical result, O(K^2)):
      best[i] = min over runs (i..j) fitting capacity of
                  (0 if j == K-1 else t_j + best[j+1])
    """
    if points is None:
        points = graph.candidate_partition_points()
    if len(points) < 2:
        raise NotPartitionable(
            f"model has {len(points)} candidate partition point(s); "
            "NASNet-style cross-links admit no single-cut vertices")
    acc = graph.accounting(points)
    segs = acc.segs
    tsizes = acc.transfer_sizes(lam)
    k = len(points)

    INF = float("inf")
    # All capacity breaks come from one O(K^2) vectorized memory matrix
    # (RunAccounting.fit_stops); the suffix DP itself is then a tight scalar
    # scan over the feasible windows only — sum(window sizes) float adds,
    # with the same ascending-j strict-< tie-break as ever.
    stops = acc.fit_stops(capacity_bytes).tolist()
    cut = list(tsizes)
    cut[k - 1] = 0.0                    # the final run has no outgoing cut
    best: list[float] = [INF] * (k + 1)
    choice = [-1] * k
    best[k] = 0.0
    for i in range(k - 1, -1, -1):
        b = INF
        ch = -1
        for j in range(i, stops[i]):
            cand = cut[j] + best[j + 1]
            if cand < b:
                b = cand
                ch = j
        best[i] = b
        choice[i] = ch
    if best[0] == INF:
        raise PartitionInfeasible(
            f"no segmentation of {k} candidate points fits capacity "
            f"{capacity_bytes/1e6:.1f} MB")

    runs: list[tuple[int, int]] = []
    i = 0
    while i < k:
        j = choice[i]
        runs.append((i, j))
        i = j + 1

    # dispatcher boundary first (model input, compressed like everything else)
    boundary = [graph.layers[points[0]].out_bytes / lam]
    for (i, j) in runs[:-1]:
        boundary.append(tsizes[j])
    part_layers = [sum((segs[s] for s in range(i, j + 1)), []) for (i, j) in runs]
    mems = [acc.run_memory_bytes(i, j) for (i, j) in runs]
    flops = [sum(graph.layers[n].flops for n in names) for names in part_layers]
    return PartitionPlan(
        points=points, runs=runs, boundary_sizes=boundary,
        partition_layers=part_layers, memory_bytes=mems,
        candidate_sizes=tsizes, compute_flops=flops, total_cost=float(best[0]),
        lam=lam)


def min_cost_path_reference(graph: LayerGraph, capacity_bytes: float,
                            lam: float = DEFAULT_COMPRESSION):
    """Paper Algorithm 1 verbatim: recursive MIN-COST-PATH over the explicit
    partition graph with the ``pathFrom`` memo keyed on the run's last
    segment.  Used by tests to cross-check :func:`optimal_partitions`.
    Returns (runs, cost)."""
    points = graph.candidate_partition_points()
    if len(points) < 2:
        raise NotPartitionable("no interior candidate points")
    segs = graph.segment_layers(points)
    tsizes = transfer_sizes(graph, points, segs, lam)
    vertices, edges, _ = build_partition_graph(graph, points, segs, capacity_bytes)
    k = len(points)
    children: dict[tuple[int, int], list[tuple[int, int]]] = {v: [] for v in vertices}
    for (u, v) in edges:
        children[u].append(v)

    path_from: dict[int, tuple[list[tuple[int, int]], float]] = {}

    def min_cost(v: tuple[int, int]) -> tuple[list[tuple[int, int]], float]:
        if not children[v]:
            if v[1] != k - 1:           # dead end that is not a leaf
                return [v], float("inf")
            return [v], 0.0
        last = v[1]
        if last not in path_from:
            best_path, best_cost = [], float("inf")
            for c in children[v]:
                p, cost = min_cost(c)
                if cost < best_cost:
                    best_path, best_cost = p, cost
            path_from[last] = (best_path, best_cost)
        min_path, min_cost_v = path_from[last]
        w = tsizes[v[1]]                # weight of edge v -> chosen child
        return [v] + min_path, min_cost_v + w

    roots = [v for v in vertices if v[0] == 0]
    if not roots:
        raise PartitionInfeasible("no feasible first partition")
    best_path, best_cost = None, float("inf")
    for r in roots:
        p, cost = min_cost(r)
        if cost < best_cost:
            best_path, best_cost = p, cost
    if best_path is None or best_cost == float("inf"):
        # a single run covering everything has no outgoing edge and cost 0
        full = [(i, j) for (i, j) in vertices if i == 0 and j == k - 1]
        if full:
            return full, 0.0
        raise PartitionInfeasible("no root-to-leaf path in partition graph")
    return best_path, best_cost
