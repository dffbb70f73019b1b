"""Communication graphs (paper §5.3, §6.2) plus the TPU-cluster analogue.

Everything internal is **bytes** and **bytes/second**.  The paper works in
Mbits/s and Mbytes; helpers convert at the boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

MBPS = 1e6 / 8.0            # 1 Mbit/s in bytes/s
GBPS = 1e9                  # 1 GB/s in bytes/s (decimal, matches TPU datasheets)

# Paper constants (§5.3.1)
WIFI_RANGE_M = 150.0        # B: WiFi router range in meters
SHANNON_A = 283230.0        # a: fitted so D(80 m) = 5.5 Mbps


def shannon_bandwidth_mbps(dist_m: float | np.ndarray, a: float = SHANNON_A):
    """Eq. 12/13: D(d) = log2(1 + a / d^2)  [Mbps]."""
    return np.log2(1.0 + a / np.maximum(dist_m, 1e-9) ** 2)


@dataclass
class ClusterGraph:
    """Complete weighted graph over compute nodes.

    bw[i, j] -- link bandwidth in bytes/s (symmetric, 0 on the diagonal).
    pos      -- optional (n, 2) positions (meters) for geometric clusters.
    compute_scale -- relative per-node compute speed (1.0 = nominal); used by
                the emulator and by straggler-mitigation experiments.
    """

    bw: np.ndarray
    pos: np.ndarray | None = None
    labels: list[str] | None = None
    compute_scale: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.bw = np.asarray(self.bw, dtype=np.float64)
        n = self.bw.shape[0]
        assert self.bw.shape == (n, n)
        np.fill_diagonal(self.bw, 0.0)
        if self.compute_scale is None:
            self.compute_scale = np.ones(n)

    @property
    def n(self) -> int:
        return self.bw.shape[0]

    def edges(self):
        """Yield (i, j, bw) for i < j with bw > 0."""
        n = self.n
        for i in range(n):
            for j in range(i + 1, n):
                if self.bw[i, j] > 0:
                    yield i, j, self.bw[i, j]

    def edge_weights(self) -> np.ndarray:
        iu = np.triu_indices(self.n, k=1)
        w = self.bw[iu]
        return w[w > 0]

    def max_bandwidth(self) -> float:
        return float(self.bw.max())

    def subgraph_at_least(self, threshold: float) -> np.ndarray:
        """Boolean adjacency of the induced subgraph with bw >= threshold
        (the tau-classified class-X subgraph of Algorithm 2)."""
        return self.bw >= threshold

    def without_nodes(self, removed: set[int]) -> np.ndarray:
        keep = np.ones(self.n, dtype=bool)
        for r in removed:
            keep[r] = False
        return keep


# ---------------------------------------------------------------------------
# Random geometric cluster (paper §5.3 / §6.1)
# ---------------------------------------------------------------------------

def _sample_positions(n: int, rng: np.random.Generator,
                      b: float = WIFI_RANGE_M) -> np.ndarray:
    """Uniform on (-B,-1) u (1,B) per coordinate (Eq. 14 domain)."""
    mag = rng.uniform(1.0, b, size=(n, 2))
    sign = rng.choice([-1.0, 1.0], size=(n, 2))
    return mag * sign


def random_geometric_cluster(n: int, rng: np.random.Generator | int = 0,
                             b: float = WIFI_RANGE_M, a: float = SHANNON_A,
                             edge_model: str = "min") -> ClusterGraph:
    """Paper §6.1: nodes uniform in the annulus-square; per-node rate from
    Eq. 13 (distance to the router at the origin); link rate between nodes:

      edge_model="min"      -- min of the endpoints' router rates (traffic
                               relays through the AP; weaker leg limits).
      edge_model="endpoint" -- the paper's literal single-position statistic
                               (reproduces E[r] = 4.766 Mbps, Eq. 18).
      edge_model="distance" -- Eq. 13 applied to the inter-node distance
                               (used for the emulator topologies, §6.2).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    pos = _sample_positions(n, rng, b)
    r_node = shannon_bandwidth_mbps(np.linalg.norm(pos, axis=1), a)  # Mbps
    if edge_model == "min":
        bw = np.minimum(r_node[:, None], r_node[None, :]) * MBPS
    elif edge_model == "endpoint":
        # Literal §5.3 statistic: one endpoint's router rate governs the edge
        # (use the smaller-index endpoint so the matrix is symmetric and the
        # marginal of a random edge equals the distribution of r, Eq. 18).
        idx = np.minimum(np.arange(n)[:, None], np.arange(n)[None, :])
        bw = r_node[idx] * MBPS
    elif edge_model == "distance":
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        bw = shannon_bandwidth_mbps(d, a) * MBPS
    else:
        raise ValueError(edge_model)
    np.fill_diagonal(bw, 0.0)
    return ClusterGraph(bw=bw, pos=pos)


# ---------------------------------------------------------------------------
# Emulator topologies (paper §6.2.1: ring / grid / cluster shapes)
# ---------------------------------------------------------------------------

def _positions_to_cluster(pos: np.ndarray, a: float = SHANNON_A) -> ClusterGraph:
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    np.fill_diagonal(d, 1.0)
    bw = shannon_bandwidth_mbps(d, a) * MBPS
    np.fill_diagonal(bw, 0.0)
    return ClusterGraph(bw=bw, pos=pos)


def ring_cluster(n: int, radius_m: float = 60.0) -> ClusterGraph:
    th = 2 * np.pi * np.arange(n) / n
    pos = radius_m * np.stack([np.cos(th), np.sin(th)], axis=1)
    return _positions_to_cluster(pos)


def grid_cluster(rows: int, cols: int, spacing_m: float = 20.0) -> ClusterGraph:
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pos = spacing_m * np.stack([xs.ravel(), ys.ravel()], axis=1).astype(float)
    pos -= pos.mean(axis=0)
    return _positions_to_cluster(pos)


def blob_cluster(n: int, n_blobs: int = 3, blob_radius_m: float = 10.0,
                 blob_spread_m: float = 80.0,
                 rng: np.random.Generator | int = 0) -> ClusterGraph:
    """'Cluster' shape of §6.2.1: tight blobs spread apart."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    centers = _sample_positions(n_blobs, rng, blob_spread_m)
    pos = np.concatenate([
        centers[i % n_blobs] + rng.normal(scale=blob_radius_m, size=(1, 2))
        for i in range(n)
    ])
    return _positions_to_cluster(pos)


# ---------------------------------------------------------------------------
# TPU cluster analogue (DESIGN.md §2): pods of stage-slots, ICI within a pod,
# DCN across pods.  Used to place pipeline stages of the assigned LM archs.
# ---------------------------------------------------------------------------

def tpu_cluster(n_pods: int = 2, slots_per_pod: int = 8,
                ici_bytes_per_s: float = 100 * GBPS,
                dcn_bytes_per_s: float = 6.25 * GBPS,
                ici_near_bonus: float = 1.5,
                jitter: float = 0.0,
                rng: np.random.Generator | int = 0) -> ClusterGraph:
    """Stage-slot communication graph for a multi-pod TPU system.

    Each slot is a group of chips that will host one pipeline stage.  Slots
    in the same pod talk over ICI (torus neighbours slightly faster ==>
    'ici-near' class); slots in different pods talk over DCN.  ``jitter``
    adds lognormal variation, standing in for the paper's heterogeneous WiFi
    measurements (and for real-world DCN congestion).
    """
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    n = n_pods * slots_per_pod
    bw = np.full((n, n), dcn_bytes_per_s)
    for p in range(n_pods):
        lo, hi = p * slots_per_pod, (p + 1) * slots_per_pod
        bw[lo:hi, lo:hi] = ici_bytes_per_s
        for s in range(slots_per_pod):
            nxt = lo + (s + 1) % slots_per_pod
            bw[lo + s, nxt] = bw[nxt, lo + s] = ici_bytes_per_s * ici_near_bonus
    if jitter > 0:
        noise = np.exp(rng.normal(scale=jitter, size=(n, n)))
        noise = np.sqrt(noise * noise.T)        # keep symmetric
        bw = bw * noise
    np.fill_diagonal(bw, 0.0)
    labels = [f"pod{p}/slot{s}" for p in range(n_pods) for s in range(slots_per_pod)]
    return ClusterGraph(bw=bw, labels=labels)
