"""Placement of partitions onto the cluster graph (paper §3.2.2, Algs. 2-3).

Transfer sizes are binned into classes; cluster edges are thresholded with
tau (Eq. 8); the longest highest-class subarrays of S are matched first onto
maximin-bandwidth k-paths found by color-coding with a binary search over the
edge-weight threshold (Algorithm 2).  Theorem 1 gives the lower bound
max(S)/max(E_c) that the matching tries to reach.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bottleneck import PlanEvaluation, evaluate
from .cluster import ClusterGraph
from .kpath import find_k_path, replay_infeasible


class PlacementInfeasible(Exception):
    pass


@dataclass
class PlacementResult:
    nodes: list[int]                 # N: len(S)+1 node ids; N[0] = dispatcher
    evaluation: PlanEvaluation
    n_classes: int
    thresholds: list[float] = field(default_factory=list)

    @property
    def bottleneck_s(self) -> float:
        return self.evaluation.bottleneck_s


def classify(values, n_classes: int, basis=None) -> np.ndarray:
    """Quantile-bin ``values`` into classes 0..n_classes-1 (higher = larger),
    with bin edges from ``basis`` (default: the values themselves) — §5.2.1's
    histogram-style transfer-size classes."""
    values = np.asarray(values, dtype=float)
    basis = values if basis is None else np.asarray(basis, dtype=float)
    if n_classes <= 1 or len(np.unique(basis)) <= 1:
        return np.zeros(len(values), dtype=int)
    qs = np.quantile(basis, np.linspace(0, 1, n_classes + 1)[1:-1])
    return np.searchsorted(qs, values, side="left").astype(int)


def _threshold_levels(cluster: ClusterGraph, max_levels: int = 1500) -> np.ndarray:
    """Candidate thresholds for Algorithm 2's binary search: the full sorted
    edge list (as in the paper — needed to hit the Theorem-1 optimum, which
    requires isolating the single best edge), quantile-coarsened only for
    very large clusters."""
    w = np.unique(cluster.edge_weights())
    if len(w) > max_levels:
        w = np.unique(np.quantile(w, np.linspace(0, 1, max_levels)))
    return w


def _uf_prune_level(cluster: ClusterGraph, levels: np.ndarray, k: int,
                    start: int | None, end: int | None,
                    avail: np.ndarray | None) -> int:
    """Union-find feasibility curve over the sorted edge list: the index of
    the *highest* threshold level at which a k-path is not ruled out by cheap
    necessary conditions, or -1 if every level is ruled out.

    Conditions checked on the avail-induced subgraph {e : w(e) >= level}
    (each monotone as the threshold drops, so the curve is a single cutoff):
      * some component holds >= k available vertices — containing start/end
        (in the same component) when those are pinned;
      * >= k available vertices of degree >= 1 and >= k-2 of degree >= 2
        (a simple k-path needs k endpoints-or-interiors, k-2 interiors).

    The conditions are *necessary*, never sufficient: a level above the
    returned index provably has no k-path, so the caller may skip the
    color-coding search there (replaying its rng draws); levels at or below
    it still need the real search.
    """
    n = cluster.n
    avail = np.ones(n, dtype=bool) if avail is None else avail.astype(bool).copy()
    if start is not None:
        avail[start] = True
    if end is not None:
        avail[end] = True
    iu, ju = np.triu_indices(n, k=1)
    keep = avail[iu] & avail[ju]
    w = cluster.bw[iu, ju]
    keep &= w > 0
    iu, ju, w = iu[keep], ju[keep], w[keep]
    order = np.argsort(-w, kind="stable")
    iu, ju, w = iu[order], ju[order], w[order]

    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    size = avail.astype(int).tolist()       # available vertices per component
    deg = [0] * n
    n_deg1 = n_deg2 = 0
    maxcomp = 1 if avail.any() else 0
    need_deg2 = max(0, k - 2)
    edge_pos = 0
    for idx in range(len(levels) - 1, -1, -1):
        thr = levels[idx]
        while edge_pos < len(w) and w[edge_pos] >= thr:
            a, b = int(iu[edge_pos]), int(ju[edge_pos])
            edge_pos += 1
            for v in (a, b):
                deg[v] += 1
                if deg[v] == 1:
                    n_deg1 += 1
                elif deg[v] == 2:
                    n_deg2 += 1
            ra, rb = find(a), find(b)
            if ra != rb:
                if size[ra] < size[rb]:
                    ra, rb = rb, ra
                parent[rb] = ra
                size[ra] += size[rb]
                maxcomp = max(maxcomp, size[ra])
        if n_deg1 < k or n_deg2 < need_deg2:
            continue
        if start is not None and end is not None:
            rs = find(start)
            ok = rs == find(end) and size[rs] >= k
        elif start is not None:
            ok = size[find(start)] >= k
        elif end is not None:
            ok = size[find(end)] >= k
        else:
            ok = maxcomp >= k
        if ok:
            return idx
    return -1


def subgraph_k_path(cluster: ClusterGraph, k: int,
                    start: int | None, end: int | None,
                    avail: np.ndarray, rng: np.random.Generator,
                    levels: np.ndarray | None = None,
                    adj_cache: dict | None = None,
                    prune: bool = True):
    """Algorithm 2 (SUBGRAPH-K-PATH): maximize the threshold t such that the
    induced subgraph {e : w(e) >= t} contains a k-path with the required
    endpoints; returns (path, threshold) or None.

    Incremental engineering on top of the paper's binary search (the probe
    sequence and rng stream are untouched, so results are bit-identical to
    ``prune=False``):
      * a union-find feasibility curve caps the level range that can hold a
        k-path; probes above the cap skip the color-coding DP and just
        replay its rng draws (on min-endpoint geometric clusters the
        thresholded graph is a clique on the fast nodes, making the bound
        exact — every failing probe is skipped);
      * thresholded adjacency matrices are memoized in ``adj_cache``, which
        kpath_matching shares across all subarray searches of one call;
      * cluster bandwidths steer the k > KMAX_COLOR greedy fallback
        (maximin extension) via find_k_path's ``weights``.
    """
    if levels is None:
        levels = _threshold_levels(cluster)
    cache: dict = {} if adj_cache is None else adj_cache

    def adj_at(idx: int) -> np.ndarray:
        a = cache.get(idx)
        if a is None:
            a = cache[idx] = cluster.bw >= levels[idx]
        return a

    if prune and k > 2:
        prune_max = _uf_prune_level(cluster, levels, k, start, end, avail)
    else:
        prune_max = len(levels) - 1     # k <= 2 probes are rng-free and cheap

    def probe(idx: int) -> list[int] | None:
        if idx > prune_max:
            replay_infeasible(cluster.n, k, start, end, avail, rng)
            return None
        return find_k_path(adj_at(idx), k, start, end, avail, rng,
                           weights=cluster.bw)

    # quick infeasibility check at the weakest threshold
    base = probe(0)
    if base is None:
        return None
    best = (base, float(levels[0]))
    lo, hi = 1, len(levels) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        path = probe(mid)
        if path is not None:
            best = (path, float(levels[mid]))
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def subgraph_k_path_reference(cluster: ClusterGraph, k: int,
                              start: int | None, end: int | None,
                              avail: np.ndarray, rng: np.random.Generator,
                              levels: np.ndarray | None = None,
                              adj_cache: dict | None = None):
    """The unpruned binary search (pre-optimization behavior): every probe
    runs the full color-coding budget and rebuilds its thresholded adjacency
    (``adj_cache`` is accepted for signature compatibility but deliberately
    unused).  Kept as the equivalence oracle for
    tests/test_threshold_search.py and the planner benchmark's baseline."""
    return _subgraph_k_path_impl(cluster, k, start, end, avail, rng, levels,
                                 adj_cache=None, prune=False)


# early binding so the reference stays correct even when benchmarks swap the
# module-level ``subgraph_k_path`` for the reference itself
_subgraph_k_path_impl = subgraph_k_path


def _class_subarrays(classes: np.ndarray, x: int) -> list[tuple[int, int]]:
    """FIND-SUBARRAYS: maximal [a, b) index runs with classes[a:b] == x."""
    runs = []
    i = 0
    m = len(classes)
    while i < m:
        if classes[i] == x:
            j = i
            while j < m and classes[j] == x:
                j += 1
            runs.append((i, j))
            i = j
        else:
            i += 1
    return runs


def kpath_matching(sizes, cluster: ClusterGraph, n_classes: int,
                   rng: np.random.Generator | int = 0,
                   basis=None) -> PlacementResult:
    """Algorithm 3 (K-PATH-MATCHING).

    sizes -- boundary transfer bytes, dispatcher edge first (len m);
             requires m+1 distinct cluster nodes.
    basis -- distribution used for class binning (the model's candidate
             transfer sizes, §5.2.1); default: ``sizes`` itself.
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    sizes = np.asarray(sizes, dtype=float)
    m = len(sizes)
    if m + 1 > cluster.n:
        raise PlacementInfeasible(
            f"need {m + 1} nodes for {m} boundaries, cluster has {cluster.n}")

    classes = classify(sizes, n_classes, basis)
    n = cluster.n
    N: list[int | None] = [None] * (m + 1)
    assigned = np.zeros(n, dtype=bool)
    levels = _threshold_levels(cluster)
    adj_cache: dict = {}        # thresholded adjacency, shared across searches
    thresholds: list[float] = []

    for x in sorted(set(classes.tolist()), reverse=True):
        runs = _class_subarrays(classes, x)
        runs.sort(key=lambda ab: ab[1] - ab[0], reverse=True)
        for (a, b) in runs:
            # S[a:b] spans node slots a..b inclusive
            start, endv = N[a], N[b]
            k = b - a + 1
            avail = ~assigned
            if start is not None:
                avail[start] = True
            if endv is not None:
                avail[endv] = True
            res = subgraph_k_path(cluster, k, start, endv, avail, rng, levels,
                                  adj_cache)
            if res is None:
                raise PlacementInfeasible(
                    f"no {k}-path for class-{x} subarray S[{a}:{b}] "
                    f"({int((~assigned).sum())} nodes free)")
            path, thr = res
            thresholds.append(thr)
            for off, v in enumerate(path):
                slot = a + off
                if N[slot] is not None and N[slot] != v:
                    raise PlacementInfeasible("endpoint mismatch")
                N[slot] = v
                assigned[v] = True

    nodes = [int(v) for v in N]       # type: ignore[arg-type]
    return PlacementResult(nodes=nodes,
                           evaluation=evaluate(sizes, nodes, cluster),
                           n_classes=n_classes, thresholds=thresholds)


def place_with_retry(sizes, cluster: ClusterGraph, n_classes: int,
                     rng: np.random.Generator | int = 0,
                     basis=None) -> PlacementResult:
    """Paper §3.2.2: 'in this case, we can re-run the algorithm with fewer
    bandwidth classes' — halve until 1 class, then give up."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    nc = n_classes
    last_err: Exception | None = None
    while nc >= 1:
        try:
            return kpath_matching(sizes, cluster, nc, rng, basis)
        except PlacementInfeasible as e:      # pragma: no cover - rare path
            last_err = e
            if nc == 1:
                break
            nc = max(1, nc // 2)
    raise PlacementInfeasible(str(last_err))


def replicate_bottlenecks(plan, cluster: ClusterGraph, *,
                          budget: int | None = None, max_replicas: int = 2,
                          keep_spares: int = 0,
                          node_flops: float = 20e9):
    """Spend unused cluster nodes on warm replicas of the slowest stages.

    Post-placement pass over a :class:`~repro.core.stageplan
    .StageExecutionPlan`: repeatedly pick the stage with the highest
    *effective* service time (transfer-in + compute, replicas combined in
    parallel — the bottleneck ``SeiferPlan.describe()`` marks) and assign
    it a replica from the spare pool, until ``budget`` replicas are
    placed, every spare is spent (minus ``keep_spares`` held back for
    restore), or every stage already holds ``max_replicas`` copies.

    Deterministic: the bottleneck stage is the first maximum (lowest
    stage index on ties) and the spare is chosen by the same
    bandwidth-to-neighbors score the emulator's reschedule uses (first
    maximum in pool order).  Returns a new plan; the input is unchanged.
    """
    import dataclasses

    from .replan import effective_stage_costs

    reps = [list(s.replicas) for s in plan.stages]
    spares = [n for n in plan.spare_nodes]
    left = len(spares) - keep_spares if budget is None else budget

    def neighbor_bw(k: int, n: int) -> float:
        s = float(cluster.bw[plan.nodes[k], n])       # feed from prev hop
        if k + 1 < plan.n_stages:
            s += float(cluster.bw[n, plan.stages[k + 1].node])
        return s

    while left > 0 and len(spares) > keep_spares:
        probe = dataclasses.replace(plan, stages=[
            dataclasses.replace(s, replicas=tuple(reps[k]))
            for k, s in enumerate(plan.stages)])
        costs = effective_stage_costs(probe, cluster, node_flops=node_flops)
        cand = [k for k in range(plan.n_stages)
                if 1 + len(reps[k]) < max_replicas and costs[k] > 0.0]
        if not cand:
            break
        k = max(cand, key=lambda i: (costs[i], -i))
        best = max(spares, key=lambda n: (neighbor_bw(k, n), -n))
        reps[k].append(best)
        spares.remove(best)
        left -= 1

    stages = [dataclasses.replace(s, replicas=tuple(reps[k]))
              for k, s in enumerate(plan.stages)]
    return dataclasses.replace(plan, stages=stages,
                               spare_nodes=tuple(spares))
