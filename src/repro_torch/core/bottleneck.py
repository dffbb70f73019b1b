"""Bottleneck-latency model (paper Eqs. 1-3) and the Theorem-1 bound."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cluster import ClusterGraph

# Paper Eq. 4: lambda = average ZFP ratio (1.44) x average LZ4 ratio (2.1).
DEFAULT_COMPRESSION = 1.44 * 2.1


def transfer_latencies(sizes: list[float], nodes: list[int],
                       cluster: ClusterGraph) -> np.ndarray:
    """gamma_k = T_k / B_k for consecutive node pairs (Eq. 3).

    ``sizes[k]`` is the (already compressed) bytes crossing the boundary
    between ``nodes[k]`` and ``nodes[k+1]``; ``len(nodes) == len(sizes)+1``.
    """
    if len(nodes) != len(sizes) + 1:
        raise ValueError(f"need len(sizes)+1 nodes, got {len(nodes)} for {len(sizes)}")
    if not len(sizes):
        return np.empty(0)
    # called per placement evaluation and per fault-tolerance replan, so one
    # fancy-indexed gather instead of a python loop; zero-bandwidth edges
    # (partitioned clusters, failed links) stay +inf
    t = np.asarray(sizes, dtype=float)
    nd = np.asarray(nodes)
    bw = cluster.bw[nd[:-1], nd[1:]]
    ok = bw > 0
    return np.where(ok, t / np.where(ok, bw, 1.0), np.inf)


def bottleneck_latency(sizes, nodes, cluster: ClusterGraph,
                       compute_times=None) -> float:
    """beta (Eq. 2), optionally including per-stage compute times (Eq. 1).

    The paper argues comm >> compute on edge clusters and drops c_k (Eq. 2);
    we keep the general form available for the emulator and TPU analyses.
    """
    gam = transfer_latencies(sizes, nodes, cluster)
    beta = float(gam.max()) if len(gam) else 0.0
    if compute_times is not None:
        beta = max(beta, float(np.max(compute_times)))
    return beta


def theorem1_bound(sizes, cluster: ClusterGraph) -> float:
    """min(beta) = max(S) / max(E_c)  (Theorem 1)."""
    if not len(sizes):
        return 0.0
    return float(np.max(sizes)) / cluster.max_bandwidth()


@dataclass
class PlanEvaluation:
    bottleneck_s: float
    latencies_s: np.ndarray
    theorem1_s: float

    @property
    def throughput_hz(self) -> float:
        return 1.0 / self.bottleneck_s if self.bottleneck_s > 0 else float("inf")

    @property
    def approx_ratio(self) -> float:
        return self.bottleneck_s / self.theorem1_s if self.theorem1_s > 0 else 1.0


def evaluate(sizes, nodes, cluster: ClusterGraph) -> PlanEvaluation:
    gam = transfer_latencies(sizes, nodes, cluster)
    return PlanEvaluation(
        bottleneck_s=float(gam.max()) if len(gam) else 0.0,
        latencies_s=gam,
        theorem1_s=theorem1_bound(sizes, cluster),
    )
