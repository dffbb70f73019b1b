"""Top-level SEIFER pipeline: partition a model, place it on a cluster."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bottleneck import DEFAULT_COMPRESSION, PlanEvaluation
from .cluster import ClusterGraph
from .graph import LayerGraph
from .partitioner import PartitionPlan, optimal_partitions
from .placement import PlacementResult, place_with_retry


@dataclass
class SeiferPlan:
    partition: PartitionPlan
    placement: PlacementResult

    @property
    def bottleneck_s(self) -> float:
        return self.placement.bottleneck_s

    @property
    def throughput_hz(self) -> float:
        return self.placement.evaluation.throughput_hz

    @property
    def evaluation(self) -> PlanEvaluation:
        return self.placement.evaluation

    def stage_of_node(self) -> dict[int, int]:
        """node id -> stage index (0 = dispatcher, 1.. = compute partitions)."""
        return {v: i for i, v in enumerate(self.placement.nodes)}

    def execution_plan(self, cluster: ClusterGraph | None = None, *,
                       wire_bits: int = 0, arch: str | None = None):
        """Emit the stage-execution IR (``repro.core.stageplan``) — the one
        plan object the emulator and the serving runtime both accept.
        ``cluster`` (optional) contributes the spare-node pool used for
        fault-tolerant stage replacement."""
        from .stageplan import from_seifer
        return from_seifer(self, cluster, wire_bits=wire_bits, arch=arch)

    def describe(self, node_flops: float = 20e9) -> str:
        """Human-readable plan with per-stage latency contributions.

        Transfer latency comes from the placement evaluation (gamma_k, the
        quantity the bottleneck is the max of); compute is the emulator's
        nominal model (``flops / node_flops``), so plans are debuggable
        without running the emulator."""
        lines = [f"SEIFER plan: {self.partition.n_partitions} partitions on "
                 f"{len(self.placement.nodes)} nodes, "
                 f"beta={self.bottleneck_s * 1e3:.2f} ms, "
                 f"throughput={self.throughput_hz:.3f} Hz "
                 f"(Theorem-1 bound {self.evaluation.theorem1_s * 1e3:.2f} ms, "
                 f"ratio {self.evaluation.approx_ratio:.3f})"]
        nodes = self.placement.nodes
        gammas = self.evaluation.latencies_s

        def fmt(seconds):
            return (f"{seconds * 1e3:.2f}ms" if seconds < 1.0
                    else f"{seconds:.3g}s")

        lines.append(f"  dispatcher -> node {nodes[0]}")
        for r, (i, j) in enumerate(self.partition.runs):
            pts = self.partition.points
            gam = float(gammas[r]) if r < len(gammas) else 0.0
            comp = self.partition.compute_flops[r] / node_flops
            star = " <- bottleneck" if (len(gammas)
                                        and gam == self.bottleneck_s) else ""
            lines.append(
                f"  stage {r}: points[{i}..{j}] ({pts[i]}..{pts[j]}) "
                f"mem={self.partition.memory_bytes[r]/1e6:.1f}MB -> node {nodes[r+1]}"
                f" (in-transfer {self.partition.boundary_sizes[r]/1e6:.2f}MB, "
                f"transfer {fmt(gam)} + compute {fmt(comp)}{star})")
        return "\n".join(lines)


def partition_and_place(graph: LayerGraph, cluster: ClusterGraph,
                        capacity_bytes: float, n_classes: int = 3,
                        rng: np.random.Generator | int = 0,
                        lam: float = DEFAULT_COMPRESSION) -> SeiferPlan:
    """The paper's full algorithm: Algorithm 1 then Algorithm 3."""
    plan = optimal_partitions(graph, capacity_bytes, lam)
    placement = place_with_retry(plan.boundary_sizes, cluster, n_classes, rng,
                                 basis=plan.candidate_sizes)
    return SeiferPlan(partition=plan, placement=placement)

