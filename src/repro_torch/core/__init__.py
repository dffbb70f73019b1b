"""SEIFER planner: partition a DNN into stages that minimise bottleneck
latency and place them on an edge cluster (numpy; a copy of the reference
planner, so plans are bit-identical to it)."""

from .api import SeiferPlan, partition_and_place
from .bottleneck import (DEFAULT_COMPRESSION, PlanEvaluation,
                         bottleneck_latency, evaluate, theorem1_bound,
                         transfer_latencies)
from .cluster import (ClusterGraph, blob_cluster, grid_cluster,
                      random_geometric_cluster, ring_cluster,
                      shannon_bandwidth_mbps, tpu_cluster, GBPS, MBPS)
from .graph import Layer, LayerGraph, RunAccounting, linear_chain
from .kpath import find_k_path, replay_infeasible
from .partitioner import (NotPartitionable, PartitionInfeasible,
                          PartitionPlan, build_partition_graph,
                          min_cost_path_reference, optimal_partitions,
                          transfer_sizes)
from .pipeline import lm_block_graph
from .placement import (PlacementInfeasible, PlacementResult, classify,
                        kpath_matching, place_with_retry,
                        replicate_bottlenecks, subgraph_k_path,
                        subgraph_k_path_reference)
from .replan import (ReplanResult, ReplicaAdd, StageMove,
                     effective_stage_costs, incremental_replan, stage_costs)
from .stageplan import (BoundarySpec, StageExecutionPlan, StageSpec,
                        from_block_cuts, from_seifer)

__all__ = [
    "SeiferPlan", "partition_and_place",
    "DEFAULT_COMPRESSION", "PlanEvaluation", "bottleneck_latency", "evaluate",
    "theorem1_bound", "transfer_latencies",
    "ClusterGraph", "blob_cluster", "grid_cluster",
    "random_geometric_cluster", "ring_cluster", "shannon_bandwidth_mbps",
    "tpu_cluster", "GBPS", "MBPS",
    "Layer", "LayerGraph", "RunAccounting", "linear_chain",
    "find_k_path", "replay_infeasible",
    "NotPartitionable", "PartitionInfeasible", "PartitionPlan",
    "build_partition_graph", "min_cost_path_reference", "optimal_partitions",
    "transfer_sizes", "lm_block_graph",
    "PlacementInfeasible", "PlacementResult", "classify", "kpath_matching",
    "place_with_retry", "replicate_bottlenecks", "subgraph_k_path",
    "subgraph_k_path_reference",
    "ReplanResult", "ReplicaAdd", "StageMove", "effective_stage_costs",
    "incremental_replan", "stage_costs",
    "BoundarySpec", "StageExecutionPlan", "StageSpec", "from_block_cuts",
    "from_seifer",
]
