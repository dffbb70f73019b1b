"""Baseline algorithms from the paper's evaluation (§6.1) plus an exact
optimum (beyond-paper) used for approximation-ratio audits.

  * random algorithm      -- random feasible partitioning + random placement
  * joint-optimization    -- greedy joint partitioning-placement
  * exact optimum         -- min over all simple node paths of the bottleneck
                             (subset DP, n <= 16), vs. Theorem 1's bound
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bottleneck import DEFAULT_COMPRESSION, PlanEvaluation, evaluate
from .cluster import ClusterGraph
from .graph import LayerGraph
from .partitioner import PartitionInfeasible, transfer_sizes


@dataclass
class BaselineResult:
    runs: list[tuple[int, int]]
    sizes: list[float]
    nodes: list[int]
    evaluation: PlanEvaluation

    @property
    def bottleneck_s(self) -> float:
        return self.evaluation.bottleneck_s


def _feasible_ends(graph, points, segs, capacity, i):
    """All j >= i such that run (i, j) fits capacity (memory monotone)."""
    out = []
    for j in range(i, len(points)):
        if graph.run_memory_bytes(points, segs, i, j) < capacity:
            out.append(j)
        else:
            break
    return out


def _sizes_for_runs(graph, points, segs, runs, lam):
    tsz = transfer_sizes(graph, points, segs, lam)
    sizes = [graph.layers[points[0]].out_bytes / lam]
    for (i, j) in runs[:-1]:
        sizes.append(tsz[j])
    return sizes


def random_algorithm(graph: LayerGraph, cluster: ClusterGraph,
                     capacity_bytes: float,
                     rng: np.random.Generator | int = 0,
                     lam: float = DEFAULT_COMPRESSION) -> BaselineResult:
    """§6.1(1): select a random node and a random partition that fits it."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    points = graph.candidate_partition_points()
    segs = graph.segment_layers(points)
    k = len(points)
    runs: list[tuple[int, int]] = []
    i = 0
    while i < k:
        ends = _feasible_ends(graph, points, segs, capacity_bytes, i)
        if not ends:
            raise PartitionInfeasible(f"segment {i} alone exceeds capacity")
        j = int(rng.choice(ends))
        runs.append((i, j))
        i = j + 1
    need = len(runs) + 1
    if need > cluster.n:
        raise PartitionInfeasible(f"need {need} nodes, have {cluster.n}")
    nodes = [int(v) for v in rng.choice(cluster.n, size=need, replace=False)]
    sizes = _sizes_for_runs(graph, points, segs, runs, lam)
    return BaselineResult(runs, sizes, nodes, evaluate(sizes, nodes, cluster))


def joint_greedy(graph: LayerGraph, cluster: ClusterGraph,
                 capacity_bytes: float,
                 lam: float = DEFAULT_COMPRESSION) -> BaselineResult:
    """§6.1(2): for every starting node, greedily co-build (smallest-transfer
    partition, highest-bandwidth next hop); keep the best bottleneck."""
    points = graph.candidate_partition_points()
    segs = graph.segment_layers(points)
    tsz = transfer_sizes(graph, points, segs, lam)
    k = len(points)
    best: BaselineResult | None = None
    for n0 in range(cluster.n):
        runs: list[tuple[int, int]] = []
        nodes = [n0]
        used = {n0}
        i = 0
        feasible = True
        while i < k:
            ends = _feasible_ends(graph, points, segs, capacity_bytes, i)
            if not ends:
                feasible = False
                break
            # smallest outgoing transfer; a run reaching the sink transfers 0
            j = min(ends, key=lambda j: 0.0 if j == k - 1 else tsz[j])
            runs.append((i, j))
            i = j + 1
            # next hop: highest-bandwidth edge from the current node
            cand = [(cluster.bw[nodes[-1], v], v)
                    for v in range(cluster.n) if v not in used]
            if not cand:
                feasible = False
                break
            _, v = max(cand)
            nodes.append(int(v))
            used.add(int(v))
        if not feasible:
            continue
        sizes = _sizes_for_runs(graph, points, segs, runs, lam)
        res = BaselineResult(runs, sizes, nodes, evaluate(sizes, nodes, cluster))
        if best is None or res.bottleneck_s < best.bottleneck_s:
            best = res
    if best is None:
        raise PartitionInfeasible("joint-greedy found no feasible plan")
    return best


# ---------------------------------------------------------------------------
# Exact optimum (beyond paper): minimize max_k sizes[k]/bw(N_k, N_k+1) over
# all simple paths of m+1 distinct nodes.  Subset DP with position-dependent
# edge constraints; exponential in n — audit-sized instances only.
# ---------------------------------------------------------------------------

def exact_optimal_bottleneck(sizes, cluster: ClusterGraph,
                             max_n: int = 16) -> float:
    sizes = np.asarray(sizes, dtype=float)
    n = cluster.n
    if n > max_n:
        raise ValueError(f"exact DP limited to n <= {max_n}, got {n}")
    m = len(sizes)
    if m + 1 > n:
        raise ValueError("more boundaries than nodes")
    bw = cluster.bw
    # candidate bottleneck values: sizes[i] / bw[u, v]
    pos = bw[np.triu_indices(n, 1)]
    pos = pos[pos > 0]
    cand = np.unique(np.concatenate([sizes[i] / pos for i in range(m)]))

    def feasible(beta: float) -> bool:
        req = sizes / beta                       # min bandwidth per position
        masks = [bw >= r for r in req]           # (m) of (n, n) bool
        full_states = 1 << n
        # dp maps subset -> bool vector over end vertices; iterate by popcount
        by_pop: list[list[int]] = [[] for _ in range(n + 1)]
        dp = {}
        for v in range(n):
            s = 1 << v
            dp[s] = np.zeros(n, dtype=bool)
            dp[s][v] = True
            by_pop[1].append(s)
        for p in range(1, m + 1):
            mask = masks[p - 1]
            for s in by_pop[p]:
                ends = dp[s]
                if not ends.any():
                    continue
                reach = (ends @ mask.astype(np.uint8)) > 0
                for w in np.flatnonzero(reach):
                    if s >> w & 1:
                        continue
                    s2 = s | (1 << w)
                    if s2 not in dp:
                        dp[s2] = np.zeros(n, dtype=bool)
                        by_pop[p + 1].append(s2)
                    dp[s2][w] = True
            if p == m:
                return any(dp[s].any() for s in by_pop[m + 1])
        return False

    lo, hi = 0, len(cand) - 1
    best = cand[-1]
    while lo <= hi:
        mid = (lo + hi) // 2
        if feasible(float(cand[mid])):
            best = float(cand[mid])
            hi = mid - 1
        else:
            lo = mid + 1
    return best
