from .core import Event, Simulator
from .pipeline import (EmulatorConfig, PipelineEmulator, emulate_plan,
                       metrics_identical, plan_replicas, plan_stage_args,
                       summarize)
from .faults import (CompositeFaultModel, DriftingCluster, EffectLedger,
                     FaultInjector, LinkDegrade, LinkFault, NodeFault,
                     NodeSlowdown, RandomLinkFaults, RandomNodeFaults,
                     WireLoss, compose_faults, effective_cluster)
from .engine import FlatEventEngine, lindley_scan, poisson_arrivals, simulate
from .sweep import aggregate, compare_replan, evaluate_cells, sweep_plan

__all__ = ["Event", "Simulator", "PipelineEmulator", "EmulatorConfig",
           "emulate_plan", "plan_stage_args", "plan_replicas", "summarize",
           "metrics_identical",
           "FaultInjector", "LinkFault", "NodeFault", "LinkDegrade",
           "NodeSlowdown", "DriftingCluster", "CompositeFaultModel",
           "EffectLedger", "WireLoss", "compose_faults", "effective_cluster",
           "RandomNodeFaults", "RandomLinkFaults",
           "FlatEventEngine", "lindley_scan", "poisson_arrivals", "simulate",
           "aggregate", "compare_replan", "evaluate_cells", "sweep_plan"]
