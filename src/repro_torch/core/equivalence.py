"""Planner-equivalence harness: the scenarios whose plans are pinned.

A copy of the reference planner's scenario grid and capture function, so
that the port replays the committed fixture
(``tests/data/planner_equivalence.json``) and gets the same plans: for
fixed seeds, (runs, nodes, bottleneck_s, total cost, thresholds, boundary
sizes) bit-identical.

Floats are compared as ``float.hex()``, so a plan that moves by one ULP
fails.  The port never re-pins: the fixture is the reference's.
"""

from __future__ import annotations

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.paper_cnns import PAPER_MODELS
from repro_torch.models.config import SHAPES

from .api import partition_and_place
from .cluster import random_geometric_cluster, tpu_cluster
from .partitioner import NotPartitionable, PartitionInfeasible
from .pipeline import plan_stages
from .placement import PlacementInfeasible

# Paper §6.1 grid restricted to a deterministic subset that still exercises
# every planner code path: multi-run partitions, deep threshold binary
# searches (50 nodes ~ 1225 candidate levels), and the infeasible cases (too
# few nodes for the boundary count; capacity below the largest segment).
# Capacities are tuned per model so the plans span 1..9 runs while every
# k-path stays on the color-coding DP (k <= KMAX_COLOR: the k > 12 greedy
# fallback is a heuristic whose quality is allowed to improve across PRs and
# is pinned by its own tests, not by this fixture).
GRID_CASES = [
    # (model, cap_mb) at the paper's 64 MB cell
    ("ResNet50", 64), ("MobileNetV2", 64), ("DenseNet121", 64),
    ("VGG16", 64), ("BERT-Base", 64),           # infeasible at 64 MB
    # scale-tuned cells forcing many runs / many threshold searches
    ("ResNet50", 30), ("InceptionResNetV2", 30), ("MobileNetV2", 11),
    ("DenseNet121", 14), ("VGG16", 420), ("BERT-Base", 100),
    ("BERT-Large", 200),
]
GRID_NODES = [5, 10, 20, 50]

# Stage-planner scenarios: per-stage budget = max(frac * total params,
# 1.35 * largest single segment) keeps every arch feasible while forcing
# multi-stage plans; jitter=0.3 gives a dense (120-level) threshold ladder.
STAGE_CASES = [(a, "decode_32k", 0.25, 1.35) for a in ARCH_IDS] + [
    # 405B prefill needs the higher floor: at 1.35x the plan is 12 runs and
    # the single class-subarray would be a 13-path (greedy fallback, which
    # this fixture deliberately does not pin).
    ("llama3-405b", "prefill_32k", 0.25, 1.6),
    ("llama4-maverick-400b-a17b", "prefill_32k", 0.25, 1.35),
    ("deepseek-v3-671b", "prefill_32k", 0.25, 1.35),
]


def scenarios() -> list[dict]:
    out = []
    for m, cap in GRID_CASES:
        for n in GRID_NODES:
            out.append({"id": f"grid/{m}/cap{cap}/n{n}", "kind": "grid",
                        "model": m, "nodes": n, "cap_mb": cap, "n_classes": 3,
                        "cluster_seed": n, "rng": 0})
    # class sweep at 50 nodes: many classes => many short subarrays => many
    # independent threshold searches sharing one rng stream.
    for nc in (2, 11):
        out.append({"id": f"grid/ResNet50/cap30/n50/c{nc}", "kind": "grid",
                    "model": "ResNet50", "nodes": 50, "cap_mb": 30,
                    "n_classes": nc, "cluster_seed": 50, "rng": 0})
    for arch, shape, frac, floor in STAGE_CASES:
        out.append({"id": f"cfg/{arch}/{shape}", "kind": "stageplan",
                    "arch": arch, "shape": shape, "frac": frac,
                    "floor": floor, "rng": 0})
    return out


def stage_budget_bytes(cfg, shape, frac: float, floor: float = 1.35) -> float:
    """Deterministic per-arch stage budget: a fraction of total parameter
    bytes floored at ``floor`` x the largest single segment (prefill working
    sets dwarf params on small models, so a pure fraction is infeasible)."""
    from .pipeline import lm_block_graph
    g = lm_block_graph(cfg, shape)
    pts = g.candidate_partition_points()
    segs = g.segment_layers(pts)
    maxseg = max(g.run_memory_bytes(pts, segs, i, i) for i in range(len(pts)))
    return max(frac * g.total_param_bytes(), floor * maxseg)


def run_scenario(sc: dict) -> dict:
    """Execute one scenario; return the pinned observables (hex floats)."""
    try:
        if sc["kind"] == "grid":
            graph = PAPER_MODELS[sc["model"]]()
            cluster = random_geometric_cluster(sc["nodes"],
                                               rng=sc["cluster_seed"])
            plan = partition_and_place(graph, cluster, sc["cap_mb"] * 1e6,
                                       n_classes=sc["n_classes"],
                                       rng=sc["rng"])
        else:
            cfg = get_config(sc["arch"], "full")
            shape = SHAPES[sc["shape"]]
            budget = stage_budget_bytes(cfg, shape, sc["frac"], sc["floor"])
            sp = plan_stages(cfg, shape,
                             cluster=tpu_cluster(n_pods=2, slots_per_pod=8,
                                                 jitter=0.3, rng=17),
                             hbm_per_stage_bytes=budget, rng=sc["rng"])
            plan = sp.plan
    except (PartitionInfeasible, NotPartitionable, PlacementInfeasible) as e:
        return {"error": type(e).__name__}
    return {
        "runs": [list(r) for r in plan.partition.runs],
        "nodes": list(plan.placement.nodes),
        "bottleneck_hex": float(plan.bottleneck_s).hex(),
        "total_cost_hex": float(plan.partition.total_cost).hex(),
        "thresholds_hex": [float(t).hex()
                           for t in plan.placement.thresholds],
        "boundary_hex": [float(b).hex()
                         for b in plan.partition.boundary_sizes],
    }


def capture() -> dict:
    return {sc["id"]: run_scenario(sc) for sc in scenarios()}

