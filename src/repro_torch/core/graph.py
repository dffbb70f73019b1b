"""Layer-DAG representation and candidate partition points (paper §3.1).

The paper distills a model's computation DAG ``G_m`` into a linear chain of
*candidate partition points*: vertices v such that

  (1) LP(v) — the longest-path ("topological") depth from the source — is
      unique among all vertices, and
  (2) AP(p_prev, v) — every path leaving the previous candidate point passes
      through v (checked with a depth-bounded DFS).

Cutting the model at such a vertex yields two halves whose only dataflow is
v's output tensor, so the partition boundary transfer is exactly eta(v).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Layer:
    """One vertex of the model DAG.

    out_bytes    -- size of this layer's output tensor (uncompressed, bytes)
    param_bytes  -- parameter memory attributed to this layer (bytes)
    work_bytes   -- peak scratch/activation memory while executing (bytes)
    flops        -- forward FLOPs (used by the emulator's compute model)
    side_in_bytes -- bytes of *side inputs* this layer consumes from outside
                    the linear stream (e.g. encoder output for decoder
                    cross-attention, image embeddings for VLM cross-attention).
                    Charged to the boundary transfer of any cut that separates
                    the side-input producer from this layer.
    shared_group -- optional tag: layers in the same group share parameters
                    (zamba2-style shared blocks).  Cutting between two call
                    sites duplicates the shared weights into both partitions;
                    the partitioner's memory model accounts for this.
    """

    name: str
    out_bytes: float = 0.0
    param_bytes: float = 0.0
    work_bytes: float = 0.0
    flops: float = 0.0
    side_in_bytes: float = 0.0
    shared_group: str | None = None


class LayerGraph:
    """A DAG of :class:`Layer` vertices with a single source and sink."""

    def __init__(self) -> None:
        self.layers: dict[str, Layer] = {}
        self.succ: dict[str, list[str]] = {}
        self.pred: dict[str, list[str]] = {}
        self._acc_cache: dict[tuple[str, ...], "RunAccounting"] = {}
        self._struct_cache: dict[str, object] = {}

    # -- construction -----------------------------------------------------
    def add(self, layer: Layer, inputs: tuple[str, ...] | list[str] = ()) -> str:
        if layer.name in self.layers:
            raise ValueError(f"duplicate layer {layer.name!r}")
        # planner caches (pure functions of the DAG) are now stale.  Contract:
        # Layer attributes are not mutated once planning queries have begun
        # (construction-time fixups like vgg16's fc1 params are fine).
        self._acc_cache.clear()
        self._struct_cache.clear()
        self.layers[layer.name] = layer
        self.succ[layer.name] = []
        self.pred[layer.name] = list(inputs)
        for u in inputs:
            if u not in self.layers:
                raise ValueError(f"unknown input {u!r} for {layer.name!r}")
            self.succ[u].append(layer.name)
        return layer.name

    def add_simple(self, name: str, inputs=(), out_bytes=0.0, param_bytes=0.0,
                   work_bytes=0.0, flops=0.0, **kw) -> str:
        return self.add(
            Layer(name, out_bytes=out_bytes, param_bytes=param_bytes,
                  work_bytes=work_bytes, flops=flops, **kw), inputs)

    # -- basic structure ---------------------------------------------------
    def source(self) -> str:
        srcs = [v for v in self.layers if not self.pred[v]]
        if len(srcs) != 1:
            raise ValueError(f"graph must have exactly one source, got {srcs}")
        return srcs[0]

    def sink(self) -> str:
        snks = [v for v in self.layers if not self.succ[v]]
        if len(snks) != 1:
            raise ValueError(f"graph must have exactly one sink, got {snks}")
        return snks[0]

    def topo_order(self) -> list[str]:
        cached = self._struct_cache.get("topo")
        if cached is not None:
            return list(cached)         # copy: callers may mutate
        indeg = {v: len(self.pred[v]) for v in self.layers}
        stack = [v for v in self.layers if indeg[v] == 0]
        order: list[str] = []
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    stack.append(w)
        if len(order) != len(self.layers):
            raise ValueError("graph has a cycle")
        self._struct_cache["topo"] = order
        return list(order)

    # -- paper §3.1 ---------------------------------------------------------
    def longest_path_depths(self) -> dict[str, int]:
        """LP(v): length of the longest path from the source to v.

        Topologically sort, then relax every out-edge (paper §3.1).
        Cached per graph (callers treat the returned dict as read-only).
        """
        cached = self._struct_cache.get("lp")
        if cached is not None:
            return cached               # type: ignore[return-value]
        lp = {v: 0 for v in self.layers}
        for v in self.topo_order():
            for w in self.succ[v]:
                lp[w] = max(lp[w], lp[v] + 1)
        self._struct_cache["lp"] = lp
        return lp

    def all_paths_through(self, v_prev: str, v: str,
                          lp: dict[str, int] | None = None) -> bool:
        """AP(v_prev, v): do all paths from ``v_prev`` pass through ``v``?

        Paper's modified DFS: recurse on out-edges; encountering a vertex
        deeper than v ==> some path bypassed v ==> False.  Reaching v ends
        that branch successfully.  Memoized, so polynomial.
        """
        lp = lp or self.longest_path_depths()
        target_depth = lp[v]
        ok: dict[str, bool] = {}

        def dfs(u: str) -> bool:
            if u == v:
                return True
            if lp[u] >= target_depth:   # bypassed v (deeper or parallel at depth)
                return False
            if u in ok:
                return ok[u]
            if not self.succ[u]:        # dead-ends before v
                ok[u] = False
                return False
            res = all(dfs(w) for w in self.succ[u])
            ok[u] = res
            return res

        return dfs(v_prev)

    def candidate_partition_points(self) -> list[str]:
        """All candidate partition points, in topological-depth order.

        p_0 is the source; p_k is the next vertex u (by depth) with a unique
        LP value and AP(p_{k-1}, u) = true.  Models whose DAG admits no such
        vertex beyond the source (NASNet-style dense cross-links) yield only
        [source, ...maybe sink] — callers treat < 2 interior points as
        "not partitionable".
        """
        cached = self._struct_cache.get("candidates")
        if cached is not None:
            return list(cached)         # copy: plans keep the list around
        lp = self.longest_path_depths()
        # Count how many vertices sit at each depth: uniqueness of LP(u).
        depth_count: dict[int, int] = {}
        for d in lp.values():
            depth_count[d] = depth_count.get(d, 0) + 1
        ordered = sorted(self.layers, key=lambda v: (lp[v], v))
        src = self.source()
        points = [src]
        for u in ordered:
            if u == src or depth_count[lp[u]] != 1:
                continue
            if self.all_paths_through(points[-1], u, lp):
                points.append(u)
        self._struct_cache["candidates"] = points
        return list(points)

    # -- memory / transfer helpers ------------------------------------------
    def segment_layers(self, points: list[str]) -> list[list[str]]:
        """Partition all vertices into segments between consecutive candidate
        points.  Segment k (k >= 1) holds layers with LP in
        (LP(p_{k-1}), LP(p_k)]; segment 0 holds layers with LP <= LP(p_0)
        (normally just the source).  Every layer belongs to exactly one
        segment because candidate points have unique depth and dominate all
        paths.
        """
        lp = self.longest_path_depths()
        bounds = np.asarray([lp[p] for p in points])
        segs: list[list[str]] = [[] for _ in points]
        if len(bounds) > 1 and not (np.diff(bounds) > 0).all():
            # non-canonical point list: fall back to the first-fit scan
            for v in self.layers:
                d = lp[v]
                idx = next((k for k, b in enumerate(bounds) if d <= b),
                           len(points) - 1)
                segs[idx].append(v)
            return segs
        # canonical (strictly deeper) points: segment of v is the first bound
        # >= LP(v), found for all layers at once; layers deeper than the last
        # candidate point (sink not a candidate) attach to the final segment.
        names = list(self.layers)
        depths = np.asarray([lp[v] for v in names])
        idxs = np.searchsorted(bounds, depths, side="left")
        np.minimum(idxs, len(points) - 1, out=idxs)
        for v, idx in zip(names, idxs):
            segs[idx].append(v)
        return segs

    def run_memory_bytes(self, points: list[str], segs: list[list[str]],
                         i: int, j: int) -> float:
        """omega([p_i..p_j]): memory footprint of the partition owning
        segments i..j — sum of param bytes (shared groups counted once per
        partition) plus the peak working-set bytes of any owned layer.

        This is the naive O(layers-in-run) *reference* implementation; the
        planner hot path uses :class:`RunAccounting` (``self.accounting(...)``)
        which answers the same query in O(1) after O(L) setup.  Equivalence is
        enforced by tests/test_accounting.py.
        """
        params = 0.0
        peak_work = 0.0
        seen_groups: set[str] = set()
        for k in range(i, j + 1):
            for name in segs[k]:
                ly = self.layers[name]
                if ly.shared_group is not None:
                    if ly.shared_group in seen_groups:
                        pass        # shared weights already counted here
                    else:
                        seen_groups.add(ly.shared_group)
                        params += ly.param_bytes
                else:
                    params += ly.param_bytes
                peak_work = max(peak_work, ly.work_bytes + ly.out_bytes)
        return params + peak_work

    def boundary_side_bytes(self, segs: list[list[str]], j: int) -> float:
        """Side-input bytes that must additionally cross a cut placed after
        segment j: any layer in a segment > j with side inputs needs those
        tensors forwarded through the cut (enc-dec / VLM cross-attn).

        Naive reference; :class:`RunAccounting` answers this in O(1) via a
        suffix-max array."""
        extra = 0.0
        for k in range(j + 1, len(segs)):
            for name in segs[k]:
                extra = max(extra, self.layers[name].side_in_bytes)
        return extra

    def accounting(self, points: list[str],
                   segs: list[list[str]] | None = None) -> "RunAccounting":
        """Cached O(1)-query accounting index for ``points`` (built once per
        distinct point list; invalidated when the graph gains layers).  A
        caller-supplied ``segs`` that differs from the canonical
        ``segment_layers(points)`` gets a one-off uncached index instead of
        poisoning (or silently ignoring) the cache."""
        key = tuple(points)
        acc = self._acc_cache.get(key)
        if acc is not None:
            if segs is None or segs == acc.segs:
                return acc
            return RunAccounting(self, points, segs)
        canonical = self.segment_layers(points)
        if segs is not None and segs != canonical:
            return RunAccounting(self, points, segs)    # one-off, uncached
        acc = self._acc_cache[key] = RunAccounting(self, points, canonical)
        return acc

    def total_param_bytes(self) -> float:
        seen: set[str] = set()
        total = 0.0
        for ly in self.layers.values():
            if ly.shared_group is not None:
                if ly.shared_group in seen:
                    continue
                seen.add(ly.shared_group)
            total += ly.param_bytes
        return total

    def total_flops(self) -> float:
        return sum(ly.flops for ly in self.layers.values())

    def __len__(self) -> int:
        return len(self.layers)


class RunAccounting:
    """Precomputed accounting index over a fixed candidate-point list.

    Answers the partitioner's per-DP-cell queries in O(1) (plus O(#shared
    groups), which is 0 or 1 for every model here) after a single O(L) pass:

      * ``nonshared_prefix`` — prefix sums of non-shared param bytes per
        segment, so a run's base params are one subtraction;
      * per shared group, the sorted occurrence segments and a
        ``searchsorted`` first-occurrence-at-or-after table, so "counted once
        per run" is one lookup (first occurrence >= i must be <= j);
      * ``seg_peak`` + a sparse table, so the peak working set of segments
        i..j is an O(1) range-max;
      * ``side_suffix`` — suffix max of side-input bytes, so the extra bytes
        a cut after segment j must carry is one load.

    All byte quantities in the models are integer-valued and far below 2**53,
    so prefix-sum reassociation is exact and queries are bit-identical to the
    naive :meth:`LayerGraph.run_memory_bytes` reference (enforced by
    tests/test_accounting.py and the planner-equivalence fixture).
    """

    def __init__(self, graph: LayerGraph, points: list[str],
                 segs: list[list[str]] | None = None) -> None:
        self.graph = graph
        self.points = list(points)
        self.segs = graph.segment_layers(self.points) if segs is None else segs
        k = len(self.points)
        self.K = k
        self._mem_matrix: np.ndarray | None = None
        lens = np.fromiter((len(s) for s in self.segs), dtype=int, count=k)
        group_occ: dict[str, list[tuple[int, float]]] = {}
        if k and lens.min() > 0:
            # canonical point lists have no empty segments, so per-segment
            # sums/maxes are contiguous reduceat slices (one pass, no python
            # inner loop); shared layers contribute 0.0 to the non-shared sum
            nl = int(lens.sum())
            params = np.empty(nl)
            peaks = np.empty(nl)
            sides = np.empty(nl)
            pos = 0
            for s, names in enumerate(self.segs):
                seen_here: set[str] = set()
                for nm in names:
                    ly = graph.layers[nm]
                    if ly.shared_group is None:
                        params[pos] = ly.param_bytes
                    else:
                        params[pos] = 0.0
                        if ly.shared_group not in seen_here:
                            # the run query charges the first call site of a
                            # group it meets; within a segment that is this one
                            seen_here.add(ly.shared_group)
                            group_occ.setdefault(ly.shared_group, []).append(
                                (s, ly.param_bytes))
                    peaks[pos] = ly.work_bytes + ly.out_bytes
                    sides[pos] = ly.side_in_bytes
                    pos += 1
            starts = np.zeros(k, dtype=int)
            np.cumsum(lens[:-1], out=starts[1:])
            nonshared = np.add.reduceat(params, starts)
            peak = np.maximum.reduceat(peaks, starts)
            side = np.maximum.reduceat(sides, starts)
        else:                           # degenerate custom point lists
            nonshared = np.zeros(k)
            peak = np.zeros(k)
            side = np.zeros(k)
            for s, names in enumerate(self.segs):
                seen_here = set()
                for nm in names:
                    ly = graph.layers[nm]
                    if ly.shared_group is None:
                        nonshared[s] += ly.param_bytes
                    elif ly.shared_group not in seen_here:
                        seen_here.add(ly.shared_group)
                        group_occ.setdefault(ly.shared_group, []).append(
                            (s, ly.param_bytes))
                    peak[s] = max(peak[s], ly.work_bytes + ly.out_bytes)
                    side[s] = max(side[s], ly.side_in_bytes)
        self.nonshared_prefix = np.concatenate(([0.0], np.cumsum(nonshared)))
        self.seg_peak = peak
        suf = np.zeros(k + 1)
        for s in range(k - 1, -1, -1):
            suf[s] = max(side[s], suf[s + 1])
        self.side_suffix = suf
        # sparse table: _peak_table[l][i] = max(seg_peak[i : i + 2**l])
        table = [peak]
        span = 1
        while span * 2 <= k:
            prev = table[-1]
            table.append(np.maximum(prev[:k - 2 * span + 1],
                                    prev[span:k - span + 1]))
            span *= 2
        self._peak_table = table
        # name-sorted groups give a deterministic accumulation order shared
        # by the point query and the vectorized curve
        self._groups = []
        for gname in sorted(group_occ):
            occ = group_occ[gname]
            occ_segs = np.asarray([s for s, _ in occ])
            occ_bytes = np.asarray([b for _, b in occ])
            first_at_or_after = np.searchsorted(occ_segs, np.arange(k + 1),
                                                side="left")
            self._groups.append((occ_segs, occ_bytes, first_at_or_after))

    # -- O(1) point queries -------------------------------------------------
    def _range_peak(self, i: int, j: int) -> float:
        lvl = (j - i + 1).bit_length() - 1
        t = self._peak_table[lvl]
        return max(t[i], t[j - (1 << lvl) + 1])

    def run_memory_bytes(self, i: int, j: int) -> float:
        """omega of the run owning segments i..j (== the naive reference)."""
        params = self.nonshared_prefix[j + 1] - self.nonshared_prefix[i]
        for occ_segs, occ_bytes, nxt in self._groups:
            t = nxt[i]
            if t < len(occ_segs) and occ_segs[t] <= j:
                params = params + occ_bytes[t]
        return float(params + self._range_peak(i, j))

    def boundary_side_bytes(self, j: int) -> float:
        """Side-input bytes crossing a cut placed after segment j."""
        return float(self.side_suffix[j + 1])

    # -- O(K^2) all-runs view ----------------------------------------------
    def memory_matrix(self) -> np.ndarray:
        """(K, K) matrix with run_memory_bytes(i, j) at [i, j] for j >= i
        (lower triangle is -inf), built in a handful of vector ops and
        cached.  Element-wise identical to the point query, so the DP's
        decisions do not depend on which view it reads.  Rows are
        non-decreasing over j >= i (params only accumulate, shared groups
        are counted once, the peak is a running max) — which is what makes
        fit_stops' first-breach argmax a valid early-break."""
        if self._mem_matrix is None:
            k = self.K
            p = self.nonshared_prefix
            params = p[None, 1:] - p[:k, None]
            cols = np.arange(k)[None, :]
            for occ_segs, occ_bytes, nxt in self._groups:
                t = np.minimum(nxt[:k], len(occ_segs) - 1)
                valid = nxt[:k] < len(occ_segs)
                start = np.where(valid, occ_segs[t], k)
                b = np.where(valid, occ_bytes[t], 0.0)
                params = params + np.where(cols >= start[:, None],
                                           b[:, None], 0.0)
            peak = np.where(cols >= np.arange(k)[:, None],
                            self.seg_peak[None, :], -np.inf)
            np.maximum.accumulate(peak, axis=1, out=peak)
            self._mem_matrix = params + peak
        return self._mem_matrix

    def fit_stops(self, capacity_bytes: float) -> np.ndarray:
        """stops[i] = first j >= i whose run memory breaches the capacity
        (K when every run starting at i fits) — the DP's per-row
        early-break, computed for all rows at once."""
        ge = self.memory_matrix() >= capacity_bytes
        return np.where(ge.any(axis=1), ge.argmax(axis=1), self.K)

    def transfer_sizes(self, lam: float) -> list[float]:
        """t_k for every candidate point (Eq. 4) in O(K)."""
        return [(self.graph.layers[p].out_bytes + self.side_suffix[k + 1]) / lam
                for k, p in enumerate(self.points)]


def linear_chain(n: int, out_bytes=1.0, param_bytes=1.0) -> LayerGraph:
    """Convenience: a purely sequential n-layer chain (every vertex is a
    candidate partition point)."""
    g = LayerGraph()
    prev: tuple[str, ...] = ()
    for i in range(n):
        nm = f"l{i}"
        g.add(Layer(nm, out_bytes=out_bytes, param_bytes=param_bytes), prev)
        prev = (nm,)
    return g
