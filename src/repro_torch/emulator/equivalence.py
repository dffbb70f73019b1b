"""Emulator-equivalence harness: the fast engines must reproduce the
reference engine bit-exactly.

A copy of the reference emulator's scenario grid: fault-free cells for the
calendar engine, single- and multi-fault cells (kill, kill+revive, link
drop, no-spare stall, straggler migration) for the flat event engine, and
``replicated/`` cells exercising warm-spare replicated stages (JSQ routing,
zero-restore replica kills, last-copy fallback to checkpoint reschedule).
``run_scenario`` pins the ``PipelineEmulator`` observables (completed
count, throughput, mean/p95 E2E, the full event log) as ``float.hex()``
strings, so the port replays the committed fixture
(``tests/data/emulator_equivalence.json``) through both of its engines
and must match it exactly.  The port never re-pins: the fixture is the
reference's.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.paper_cnns import PAPER_MODELS
from repro_torch.core import partition_and_place
from repro_torch.core.cluster import (ClusterGraph, blob_cluster, grid_cluster,
                                random_geometric_cluster, ring_cluster)

from .engine import simulate
from .faults import LinkDegrade, LinkFault, NodeFault, WireLoss
from .pipeline import EmulatorConfig


def scenarios() -> list[dict]:
    """The pinned grid.  Fault times/stages reference *stage indices*; the
    concrete node ids are resolved after planning (plans themselves are
    pinned by the planner-equivalence fixture, so the resolution is
    deterministic)."""
    out = []

    def ff(sid, model, cap, cluster, n_batches, rate=None, dur=1e6, cfg=None):
        out.append({"id": f"ff/{sid}", "model": model, "cap_mb": cap,
                    "cluster": cluster, "n_batches": n_batches, "rate": rate,
                    "duration_s": dur, "cfg": cfg or {}, "faults": []})

    def flt(sid, faults, model="ResNet50", cap=30,
            cluster=("geo", 12, 3), n_batches=60, rate=None, dur=1e6,
            cfg=None, **kw):
        out.append({"id": f"fault/{sid}", "model": model, "cap_mb": cap,
                    "cluster": cluster, "n_batches": n_batches, "rate": rate,
                    "duration_s": dur, "cfg": cfg or {}, "faults": faults,
                    **kw})

    # -- fault-free: calendar engine over shapes, sizes, arrival regimes --
    ff("ring5/ResNet50/cap64", "ResNet50", 64, ("ring", 5, 0), 200)
    ff("grid9/ResNet50/cap64/poisson2", "ResNet50", 64, ("grid", 9, 0), 200,
       rate=2.0)
    ff("blob9/MobileNetV2/cap64", "MobileNetV2", 64, ("blob", 9, 0), 150)
    ff("geo12/ResNet50/cap30", "ResNet50", 30, ("geo", 12, 3), 200)
    ff("geo12/ResNet50/cap30/poisson0.25", "ResNet50", 30, ("geo", 12, 3),
       150, rate=0.25)
    ff("geo20/InceptionResNetV2/cap30", "InceptionResNetV2", 30,
       ("geo", 20, 7), 120)
    ff("geo12/compute-bound", "ResNet50", 30, ("geo", 12, 3), 100,
       cfg={"node_flops": 1e6})
    ff("geo12/truncated", "ResNet50", 30, ("geo", 12, 3), 200, dur=40.0)

    # -- faulted: flat event engine --------------------------------------
    flt("kill-stage1", [{"node_stage": 1, "t": 20.0}])
    flt("kill-revive", [{"node_stage": 2, "t": 15.0, "recover": 30.0}])
    flt("link-drop", [{"link_stages": [0, 1], "t": 10.0, "duration": 15.0}])
    flt("no-spares-stall", [{"node_stage": 1, "t": 10.0}], n_batches=30,
        dur=150.0, no_spares=True)
    flt("kill-two", [{"node_stage": 1, "t": 15.0},
                     {"node_stage": 2, "t": 35.0}])
    flt("revive-before-resched", [{"node_stage": 1, "t": 20.0,
                                   "recover": 3.0}])
    flt("poisson-kill", [{"node_stage": 1, "t": 25.0}], n_batches=80,
        rate=1.0)
    flt("straggler-migration", [], n_batches=60, slow_stage=1,
        slow_scale=0.05,
        cfg={"enable_straggler_migration": True, "straggler_check_s": 5.0})

    # -- replicated stages: warm-spare failover, JSQ routing --------------
    # ``replicas`` maps a stage index to the number of warm replica copies
    # (resolved onto the first spare nodes after planning, so the node ids
    # are deterministic).  Kills of one copy are absorbed with zero
    # restore ("replica ... LOST, no restore" in the pinned event log);
    # only the last copy's death engages checkpoint reschedule.
    def rep(sid, faults, replicas, **kw):
        flt(sid, faults, replicas=replicas, **kw)
        out[-1]["id"] = f"replicated/{sid}"

    rep("jsq", [], {1: 1})
    rep("kill-replica", [{"replica_stage": 1, "t": 20.0}], {1: 1})
    rep("kill-primary", [{"node_stage": 2, "t": 20.0}], {1: 1})
    rep("kill-both", [{"replica_stage": 1, "t": 15.0},
                      {"node_stage": 2, "t": 35.0}], {1: 1})
    rep("poisson-two-replicas", [{"node_stage": 2, "t": 25.0}], {1: 2},
        n_batches=80, rate=1.0)

    # -- unreliable wire: Bernoulli frame loss on a boundary link ---------
    # a lost frame pays the full transfer duration, then the reconnect
    # loop retransmits after retry_s ("wire ... frame LOST" in the pinned
    # event log); the loss stream is seeded per link so both engines draw
    # identically.  Composition cells overlap loss with drift / kills.
    def wire(sid, faults, **kw):
        flt(sid, faults, **kw)
        out[-1]["id"] = f"wire/{sid}"

    wire("loss-hop1", [{"wire_stages": [1, 2], "t": 5.0, "loss": 0.3,
                        "seed": 5}])
    wire("loss-windowed", [{"wire_stages": [0, 1], "t": 5.0, "loss": 0.4,
                            "duration": 40.0, "seed": 7}], n_batches=80,
         rate=1.0)
    wire("loss-plus-degrade", [{"wire_stages": [1, 2], "t": 5.0,
                                "loss": 0.3, "seed": 5},
                               {"link_stages": [1, 2], "t": 10.0,
                                "duration": 20.0, "degrade": 0.5}])
    wire("loss-plus-kill", [{"wire_stages": [0, 1], "t": 5.0, "loss": 0.2,
                             "seed": 9},
                            {"node_stage": 2, "t": 20.0}])
    return out


def _make_cluster(spec):
    kind, n, seed = spec
    if kind == "ring":
        return ring_cluster(n)
    if kind == "grid":
        rows = int(np.sqrt(n))
        return grid_cluster(rows, n // rows)
    if kind == "blob":
        return blob_cluster(n, n_blobs=max(2, n // 4), rng=seed)
    return random_geometric_cluster(n, rng=seed)


def build_scenario(sc: dict):
    """Resolve one scenario to concrete emulator inputs."""
    graph = PAPER_MODELS[sc["model"]]()
    cluster = _make_cluster(sc["cluster"])
    plan = partition_and_place(graph, cluster, sc["cap_mb"] * 1e6,
                               n_classes=3, rng=0)
    nodes = list(plan.placement.nodes)
    if sc.get("no_spares"):
        # restrict the cluster to exactly the plan's nodes (remapped ids)
        cluster = ClusterGraph(bw=cluster.bw[np.ix_(nodes, nodes)],
                               compute_scale=cluster.compute_scale[nodes])
        nodes = list(range(len(nodes)))
    if sc.get("slow_stage") is not None:
        cluster.compute_scale[nodes[sc["slow_stage"]]] = sc["slow_scale"]
    replicas = [[] for _ in range(plan.partition.n_partitions)]
    if sc.get("replicas"):
        # warm replica copies live on the first spare nodes, in order —
        # deterministic given the pinned plan
        pool = [n for n in range(cluster.n) if n not in nodes]
        for k in sorted(sc["replicas"]):
            for _ in range(sc["replicas"][k]):
                replicas[k].append(pool.pop(0))
    faults = []
    for f in sc["faults"]:
        if "replica_stage" in f:
            faults.append(NodeFault(f["t"], replicas[f["replica_stage"]][0],
                                    f.get("recover")))
        elif "node_stage" in f:
            faults.append(NodeFault(f["t"], nodes[f["node_stage"]],
                                    f.get("recover")))
        elif "wire_stages" in f:
            a, b = f["wire_stages"]
            faults.append(WireLoss(f["t"], nodes[a], nodes[b], f["loss"],
                                   f.get("duration"), f.get("seed", 0)))
        elif "degrade" in f:
            a, b = f["link_stages"]
            faults.append(LinkDegrade(f["t"], nodes[a], nodes[b],
                                      f["degrade"], f.get("duration")))
        else:
            a, b = f["link_stages"]
            faults.append(LinkFault(f["t"], nodes[a], nodes[b],
                                    f["duration"]))
    return (cluster, nodes, plan.partition.boundary_sizes,
            plan.partition.compute_flops, faults,
            EmulatorConfig(**sc["cfg"]), replicas)


def pin(metrics: dict) -> dict:
    """Hex-exact observable record of one emulator run."""
    return {
        "completed": metrics["completed"],
        "throughput_hex": float(metrics["throughput_hz"]).hex(),
        "mean_e2e_hex": float(metrics["mean_e2e_s"]).hex(),
        "p95_e2e_hex": float(metrics["p95_e2e_s"]).hex(),
        "events": [[float(t).hex(), msg] for t, msg in metrics["events"]],
    }


def run_scenario(sc: dict, engine: str = "reference") -> dict:
    cluster, nodes, boundary, flops, faults, cfg, reps = build_scenario(sc)
    m = simulate(cluster, nodes, boundary, flops, cfg,
                 n_batches=sc["n_batches"], duration_s=sc["duration_s"],
                 arrival_rate_hz=sc["rate"], faults=faults, rng=0,
                 engine=engine, replicas=reps)
    return pin(m)


def capture() -> dict:
    return {sc["id"]: run_scenario(sc) for sc in scenarios()}

