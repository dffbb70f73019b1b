"""The port's cluster emulator held to the reference emulator on the CPU.

* every cell of the committed ``tests/data/emulator_equivalence.json``
  through both of the port's engines (``"reference"``: the closure-based
  ``PipelineEmulator``; ``"auto"``: the calendar or the flat event
  engine), equal to the fixture, and the fixture's shape checks;
* the SeiferPlan -> stage-execution IR -> emulator round trip of the
  reference's ``tests/test_pipeline_serve.py`` on the port's IR, and the
  deprecated raw-tuple path of ``emulate_plan`` with its warning;
* ``simulate``, ``evaluate_cells``, ``sweep_plan``, ``compare_replan`` and
  the fault models equal to the reference's — every float by
  ``float.hex``, every event message — on the inputs of the reference's
  ``tests/test_emulator_engine.py``, ``test_emulator_faults.py``,
  ``test_emulator_sweep.py`` and ``test_replan.py``, one parametrised case
  each, in each engine.
"""

import json
import types
import warnings
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import partition_and_place
from repro_torch.core.stageplan import StageExecutionPlan, StageSpec
from repro_torch.emulator import (emulate_plan, metrics_identical,
                                  plan_stage_args, simulate)
from repro_torch.emulator import equivalence as emu_eq
from test_torch_planner import hexed, rows_record, wall_time  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIX = json.loads((ROOT / "tests" / "data" /
                  "emulator_equivalence.json").read_text())
SCN = {sc["id"]: sc for sc in emu_eq.scenarios()}


def package(name):
    """The modules of one package (``repro`` or ``repro_torch``) that the
    cases below call."""
    return types.SimpleNamespace(
        name=name, emu=import_module(f"{name}.emulator"),
        core=import_module(f"{name}.core"),
        api=import_module(f"{name}.core.api"),
        cluster=import_module(f"{name}.core.cluster"),
        stageplan=import_module(f"{name}.core.stageplan"),
        configs=import_module(f"{name}.configs"),
        shapes=import_module(f"{name}.models.config").SHAPES,
        cnns=import_module(f"{name}.configs.paper_cnns"))


REF, PORT = package("repro"), package("repro_torch")


# ---------------------------------------------------------------------------
# the emulator-equivalence fixture
# ---------------------------------------------------------------------------

def test_fixture_matches_scenario_grid():
    assert set(SCN) == set(FIX)
    ref = import_module("repro.emulator.equivalence")
    assert set(SCN) == {sc["id"] for sc in ref.scenarios()}


def test_fixture_exercises_both_engines():
    ff = [k for k in FIX if k.startswith("ff/")]
    faulted = [k for k in FIX if not k.startswith("ff/")]
    assert len(ff) >= 6, "fixture must cover the calendar engine"
    assert len(faulted) >= 6, "fixture must cover the flat event engine"
    assert any(v["completed"] < SCN[k]["n_batches"]
               for k, v in FIX.items()), \
        "fixture must include a truncated/stalled cell"
    assert any("straggler" in msg for v in FIX.values()
               for _, msg in v["events"]), \
        "fixture must include a straggler migration"


@pytest.mark.parametrize("engine", ["reference", "auto"])
@pytest.mark.parametrize("sid", sorted(SCN))
def test_engine_matches_fixture(sid, engine):
    assert emu_eq.run_scenario(SCN[sid], engine) == FIX[sid]


@pytest.mark.parametrize("sid", ["ff/ring5/ResNet50/cap64",
                                 "fault/kill-stage1",
                                 "fault/kill-revive"])
def test_ir_roundtrip_preserves_emulator_fixture(sid):
    sc = SCN[sid]
    (cluster, nodes, boundary, flops, faults, cfg,
     _reps) = emu_eq.build_scenario(sc)
    graph = emu_eq.PAPER_MODELS[sc["model"]]()
    plan = partition_and_place(graph, emu_eq._make_cluster(sc["cluster"]),
                               sc["cap_mb"] * 1e6, n_classes=3, rng=0)
    ir = plan.execution_plan(cluster)
    # the IR carries the emulator triple verbatim
    assert ir.emulator_args() == (list(nodes), list(boundary), list(flops))
    assert plan_stage_args(plan) == ir.emulator_args()
    assert set(ir.spare_nodes) == set(range(cluster.n)) - set(nodes)
    # and replaying the fixture scenario through the IR pins byte-exact
    m = simulate(cluster, *ir.emulator_args(), cfg,
                 n_batches=sc["n_batches"], duration_s=sc["duration_s"],
                 arrival_rate_hz=sc["rate"], faults=faults, rng=0,
                 engine="auto")
    assert emu_eq.pin(m) == FIX[sid]


def test_raw_tuple_emulator_path_deprecated_but_working():
    sc = SCN["ff/ring5/ResNet50/cap64"]
    cluster, nodes, boundary, flops, _, cfg, _reps = emu_eq.build_scenario(sc)
    ir = StageExecutionPlan(
        stages=[StageSpec(k, (), nodes[k + 1], in_bytes=boundary[k],
                          compute_flops=flops[k])
                for k in range(len(boundary))],
        dispatcher_node=nodes[0])
    via_ir = emulate_plan(ir, cluster, cfg, n_batches=20)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        via_tuple = emulate_plan((nodes, boundary, flops), cluster, cfg,
                                 n_batches=20)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert via_ir == via_tuple


# ---------------------------------------------------------------------------
# simulate: the reference's test inputs, in both packages
# ---------------------------------------------------------------------------
#
# A case is numpy data and fault specs ``(class name, args, kwargs)``; each
# package builds its own cluster, faults and config from them.

BW = 1e6          # test_emulator_faults.py's uniform bandwidth
OUT = 1e4         # and boundary bytes


def random_pipeline(rng, n_extra=3):
    """``tests/test_emulator_engine.py``'s random pipeline, as data."""
    n_parts = int(rng.integers(1, 5))
    n_nodes = n_parts + 1 + int(rng.integers(0, n_extra + 1))
    bw = rng.uniform(1e4, 1e6, (n_nodes, n_nodes))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, 0.0)
    scale = rng.uniform(0.5, 2.0, n_nodes)
    nodes = [int(v) for v in rng.permutation(n_nodes)[:n_parts + 1]]
    boundary = [float(v) for v in rng.uniform(1e3, 1e5, n_parts)]
    flops = [float(v) for v in rng.uniform(1e8, 2e10, n_parts)]
    return dict(bw=bw, scale=scale, nodes=nodes, boundary=boundary,
                flops=flops)


def uniform(n_nodes, compute_s, scale=None, node_flops=20e9, bw=BW):
    """``test_emulator_faults.py``'s ``make_emu`` inputs: dispatcher on
    node 0, stage k on node k."""
    b = np.full((n_nodes, n_nodes), bw)
    np.fill_diagonal(b, 0.0)
    return dict(bw=b, scale=scale, nodes=list(range(len(compute_s) + 1)),
                boundary=[OUT] * len(compute_s),
                flops=[s * node_flops for s in compute_s])


def engine_cases():
    cases = {}
    rng = np.random.default_rng(11)
    for trial in range(25):
        pipe = random_pipeline(rng)
        cases[f"engine/fault-free/{trial}"] = dict(
            pipe, kw=dict(n_batches=int(rng.integers(1, 60)),
                          duration_s=[1e9, 40.0][trial % 2],
                          arrival_rate_hz=[None, 5.0, 0.2][trial % 3],
                          rng=trial))
    rng = np.random.default_rng(12)
    for trial in range(25):
        pipe = random_pipeline(rng)
        kind, nodes = trial % 3, pipe["nodes"]
        if kind == 0:
            faults = [("NodeFault", (float(rng.uniform(1, 30)), nodes[1]),
                       {})]
        elif kind == 1:
            faults = [("NodeFault", (float(rng.uniform(1, 30)), nodes[1]),
                       {"recover_after_s": float(rng.uniform(1, 20))})]
        else:
            faults = [("LinkFault", (float(rng.uniform(1, 20)), nodes[0],
                                     nodes[1], float(rng.uniform(1, 15))),
                       {})]
        cases[f"engine/faulted/{trial}"] = dict(
            pipe, faults=faults,
            kw=dict(n_batches=int(rng.integers(1, 50)),
                    duration_s=[1e9, 60.0][trial % 2],
                    arrival_rate_hz=[None, 2.0][trial % 2], rng=trial))
    rng = np.random.default_rng(13)
    for trial in range(6):
        pipe = random_pipeline(rng)
        pipe["scale"][pipe["nodes"][1]] = 0.05
        cases[f"engine/straggler/{trial}"] = dict(
            pipe, cfg=dict(enable_straggler_migration=True,
                           straggler_check_s=5.0),
            kw=dict(n_batches=25, duration_s=1e9,
                    arrival_rate_hz=[None, 1.0][trial % 2], rng=trial))
    dead = uniform(3, (0.05, 0.05))
    dead["bw"][1, 2] = dead["bw"][2, 1] = 0.0
    cases["engine/dead-link"] = dict(dead, kw=dict(n_batches=5,
                                                   duration_s=30.0))
    return cases


def faults_cases():
    """``test_emulator_faults.py``'s and ``test_emulator.py``'s runs."""
    nf, lf = "NodeFault", "LinkFault"
    c = {
        "race/killed-mid-compute": (uniform(5, (30.0, 1.0)),
                                    [(nf, (5.0, 1), {})], 1, 1e6),
        "race/transient": (uniform(5, (30.0, 1.0)),
                           [(nf, (5.0, 1), {"recover_after_s": 2.0})],
                           1, 1e6),
        "spares/revived-rejoins": (uniform(5, (30.0, 1.0)),
                                   [(nf, (5.0, 1),
                                     {"recover_after_s": 35.0})], 1, 1e6),
        "spares/long-trace": (uniform(4, (0.2, 0.05)), [
            (nf, (20.0, 1), {"recover_after_s": 25.0}),
            (nf, (55.0, 3), {"recover_after_s": 25.0}),
            (nf, (90.0, 1), {"recover_after_s": 25.0})], 400, 1e6),
        "spares/dead-spare": (uniform(5, (0.2, 0.05)),
                              [(nf, (1.0, 3), {}), (nf, (5.0, 1), {})],
                              50, 1e6),
        "spares/no-spare-stall": (uniform(3, (0.2, 0.05)),
                                  [(nf, (5.0, 1), {})], 50, 100.0),
        "spares/recovers-first": (uniform(5, (0.5, 0.05)),
                                  [(nf, (5.0, 1),
                                    {"recover_after_s": 3.0})], 30, 1e6),
        "link/outage": (uniform(4, (0.5, 0.05)),
                        [(lf, (0.05, 0, 1, 10.0), {})], 20, 1e6),
        "link/overlapping": (uniform(5, (0.2, 0.05)),
                             [(lf, (1.0, 1, 2, 5.0), {}),
                              (lf, (2.0, 1, 2, 1.0), {})], 50, 1e6),
        "chaos/degrade": (uniform(5, (0.2, 0.05)),
                          [("LinkDegrade", (1.0, 0, 1, 0.25, 5.0), {})],
                          50, 1e6),
        "chaos/slowdown": (uniform(5, (0.5, 0.05)),
                           [("NodeSlowdown", (1.0, 1, 0.5, 20.0), {})],
                           10, 1e6),
        "chaos/degrade-and-slowdown": (uniform(5, (0.2, 0.05)), [
            ("LinkDegrade", (1.0, 1, 2, 0.5, None), {}),
            ("LinkDegrade", (3.0, 1, 2, 0.5, 4.0), {}),
            ("NodeSlowdown", (2.0, 2, 0.5, 6.0), {})], 50, 1e6),
        "wire/loss": (uniform(5, (0.2, 0.05)),
                      [("WireLoss", (1.0, 1, 2, 0.4), {"seed": 3})], 50, 1e6),
        "wire/windowed": (uniform(5, (0.2, 0.05)),
                          [("WireLoss", (1.0, 1, 2, 0.9),
                            {"duration_s": 5.0, "seed": 3})], 50, 1e6),
        "wire/composed": (uniform(5, (0.2, 0.05)), [
            ("WireLoss", (1.0, 1, 2, 0.3), {"duration_s": 30.0, "seed": 5}),
            ("LinkDegrade", (3.0, 1, 2, 0.5, 10.0), {}),
            ("NodeSlowdown", (2.0, 2, 0.5, 6.0), {})], 50, 1e6),
        "wire/always": (uniform(5, (0.2, 0.05)),
                        [("WireLoss", (0.0, 1, 2, 0.5), {"seed": 1})],
                        50, 1e6),
    }
    scale = np.ones(8)
    scale[1] = 0.05
    for migrate in (False, True):
        c[f"straggler/migrate={migrate}"] = (
            uniform(8, (0.5, 0.1, 0.1), scale=scale), [], 20, 1e6,
            dict(enable_straggler_migration=migrate, straggler_check_s=5.0))
    out = {}
    for name, (pipe, faults, n, dur, *cfg) in c.items():
        out[f"faults/{name}"] = dict(pipe, faults=faults,
                                     cfg=cfg[0] if cfg else {},
                                     kw=dict(n_batches=n, duration_s=dur))
    for seed in (0, 1, 2):
        out[f"faults/drifting/{seed}"] = dict(
            uniform(5, (0.2, 0.05)), drift=seed, kw=dict(n_batches=50,
                                                         duration_s=1e6))
    return out


SIM_CASES = {**engine_cases(), **faults_cases()}
DRIFT = dict(decay_hops=2, decay_factor=0.6, decay_steps=3,
             decay_every_s=4.0, jitter=0.2, slow_nodes=1,
             slowdown_factor=0.5, flap_hops=1, flap_count=2)


def build_faults(pkg, case):
    if "drift" in case:
        return pkg.emu.DriftingCluster(**DRIFT).draw(case["drift"],
                                                     case["nodes"])
    return [getattr(pkg.emu, name)(*args, **kw)
            for name, args, kw in case.get("faults", [])]


def run_sim(pkg, case, engine):
    """One case's metrics through ``pkg``'s ``simulate`` in ``engine``,
    or, for ``"injector"``, its ``PipelineEmulator`` with the faults
    scheduled by a ``FaultInjector``."""
    scale = case["scale"]
    cluster = pkg.cluster.ClusterGraph(
        bw=case["bw"].copy(), compute_scale=None if scale is None
        else np.array(scale, copy=True))
    cfg = pkg.emu.EmulatorConfig(**case.get("cfg", {}))
    faults = build_faults(pkg, case)
    kw = dict(case["kw"])
    if engine == "injector":
        emu = pkg.emu.PipelineEmulator(cluster, case["nodes"],
                                       case["boundary"], case["flops"], cfg)
        if faults:
            pkg.emu.FaultInjector(emu).schedule(faults)
        m = emu.run(kw["n_batches"], kw["duration_s"])
        m["stage_nodes"] = [st.node for st in emu.stages]
        m["spares"] = list(emu.spares)
        m["bw_after"] = cluster.bw
        return m
    return pkg.emu.simulate(cluster, case["nodes"], case["boundary"],
                            case["flops"], cfg, faults=faults,
                            engine=engine, **kw)


# the injector runs batches back to back: only the cases without seeded
# arrivals (test_emulator_faults.py's) go through it
SIM_RUNS = [(name, engine) for name in sorted(SIM_CASES)
            for engine in ("reference", "auto", "injector")
            if engine != "injector" or name.startswith("faults/")]


@pytest.mark.parametrize("name,engine", SIM_RUNS)
def test_simulate_equals_the_reference_s(name, engine):
    case = SIM_CASES[name]
    got = run_sim(PORT, case, engine)
    want = run_sim(REF, case, engine)
    assert hexed(got) == hexed(want)
    if engine == "auto":
        assert metrics_identical(got, run_sim(PORT, case, "reference"))


# ---------------------------------------------------------------------------
# the sweep API, the fault models and the effective cluster
# ---------------------------------------------------------------------------

def sweep_setup(pkg):
    """``tests/test_emulator_sweep.py``'s plan."""
    g = pkg.cnns.resnet50()
    cluster = pkg.core.random_geometric_cluster(14, rng=11)
    plan = pkg.core.partition_and_place(g, cluster, 30e6, n_classes=3,
                                        rng=2)
    return cluster, plan


def plan_args(plan):
    return (plan.placement.nodes, plan.partition.boundary_sizes,
            plan.partition.compute_flops)


def crippled(pkg, cluster, plan):
    """``test_faulty_plan_ranks_last``'s spare-less copy of the plan."""
    import copy
    nodes = plan.placement.nodes
    small = pkg.cluster.ClusterGraph(
        bw=cluster.bw[np.ix_(nodes, nodes)].copy(),
        compute_scale=cluster.compute_scale[nodes])
    out = copy.copy(plan)
    out.placement = copy.copy(plan.placement)
    out.placement.nodes = list(range(len(nodes)))
    return small, out


def replan_plan(pkg, spares):
    """``tests/test_replan.py``'s 2-stage granite plan."""
    cfg = pkg.configs.get_config("granite-3-2b", "smoke").replace(n_layers=4)
    return pkg.stageplan.from_block_cuts(
        cfg, [2], nodes=(0, 1, 2), spare_nodes=spares,
        shape=pkg.shapes["decode_32k"])


def uniform_cluster(pkg, n):
    bw = np.full((n, n), BW)
    np.fill_diagonal(bw, 0.0)
    return pkg.cluster.ClusterGraph(bw=bw, compute_scale=np.ones(n))


SWEEPS = {
    "cells/grid": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(0, 1, 2), arrival_rates=(None, 1.0),
        n_batches=40),
    "cells/deterministic": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(0, 1, 2, 3), n_batches=40),
    "cells/poisson": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(0, 1), arrival_rates=(0.8,),
        n_batches=40),
    "cells/node-faults": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(3,), n_batches=40,
        fault_model=pkg.emu.RandomNodeFaults(
            n_faults=1, window_s=(5.0, 20.0), recover_after_s=30.0)),
    "cells/aggregate": lambda pkg, cl, plan: pkg.emu.aggregate(
        pkg.emu.evaluate_cells(
            cl, *plan_args(plan), seeds=range(6), n_batches=30,
            fault_model=pkg.emu.RandomNodeFaults(n_faults=1,
                                                 window_s=(5.0, 30.0))), 30),
    "cells/link-faults": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(0, 1), arrival_rates=(None, 2.0),
        n_batches=30, fault_model=pkg.emu.RandomLinkFaults(
            n_faults=2, duration_s=4.0)),
    "cells/drift": lambda pkg, cl, plan: pkg.emu.evaluate_cells(
        cl, *plan_args(plan), seeds=(0, 1), n_batches=30,
        fault_model=pkg.emu.CompositeFaultModel((
            pkg.emu.DriftingCluster(decay_hops=1, stream=2),
            pkg.emu.DriftingCluster(slow_nodes=1, flap_hops=1,
                                    stream=3)))),
    "plans/ranked": lambda pkg, cl, plan: rows_record(
        pkg.api.evaluate_plans(
            [pkg.core.partition_and_place(pkg.cnns.resnet50(), cl, cap,
                                          n_classes=3, rng=2)
             for cap in (30e6, 64e6)], cl, seeds=(0, 1),
            arrival_rates=(None,), n_batches=30)),
    "plans/faulty": lambda pkg, cl, plan: rows_record(
        pkg.api.evaluate_plans(
            [crippled(pkg, cl, plan)[1]], crippled(pkg, cl, plan)[0],
            seeds=(0, 1), n_batches=20, duration_s=200.0,
            fault_model=pkg.emu.RandomNodeFaults(n_faults=1,
                                                 window_s=(2.0, 10.0)))),
    "sweep/replication": lambda pkg, cl, plan: pkg.emu.sweep_plan(
        pkg.stageplan.from_seifer(plan, cl), cl, replication_factors=(1, 2),
        seeds=(0, 1), arrival_rates=(1.0,), n_batches=30),
    "sweep/replicated-plan": lambda pkg, cl, plan: pkg.emu.sweep_plan(
        pkg.core.replicate_bottlenecks(pkg.stageplan.from_seifer(plan, cl),
                                       cl, budget=1, max_replicas=2),
        cl, seeds=(0,), arrival_rates=(1.0,), n_batches=30),
    "replan/drift": lambda pkg, cl, plan: pkg.emu.compare_replan(
        replan_plan(pkg, (3, 4)), uniform_cluster(pkg, 5),
        drift=pkg.emu.DriftingCluster(decay_hops=2, decay_factor=0.4,
                                      decay_steps=3, decay_every_s=10.0,
                                      start_s=2.0),
        period_s=10.0, horizon_s=60.0, arrival_rate_hz=3.0, seeds=(0, 1)),
    "replan/no-spares": lambda pkg, cl, plan: pkg.emu.compare_replan(
        replan_plan(pkg, ()), uniform_cluster(pkg, 3),
        drift=pkg.emu.DriftingCluster(decay_hops=1, decay_factor=0.4,
                                      decay_steps=3, decay_every_s=10.0,
                                      start_s=2.0),
        period_s=10.0, horizon_s=40.0, arrival_rate_hz=2.0, seeds=(0,)),
}


@pytest.fixture(scope="module")
def setups():
    return {pkg.name: sweep_setup(pkg) for pkg in (REF, PORT)}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_equals_the_reference_s(name, setups):
    got = SWEEPS[name](PORT, *setups[PORT.name])
    want = SWEEPS[name](REF, *setups[REF.name])
    assert hexed(got) == hexed(want)
    assert got


FAULT_DRAWS = {
    "node-faults": lambda emu: emu.RandomNodeFaults(
        n_faults=2, window_s=(5.0, 50.0), recover_after_s=20.0),
    "link-faults": lambda emu: emu.RandomLinkFaults(n_faults=2,
                                                    duration_s=4.0),
    "drifting": lambda emu: emu.DriftingCluster(
        decay_hops=2, decay_steps=3, slow_nodes=2, flap_hops=1, jitter=0.3),
    "composite": lambda emu: emu.CompositeFaultModel((
        emu.DriftingCluster(decay_hops=1, stream=2),
        emu.DriftingCluster(decay_hops=1, stream=3))),
}


@pytest.mark.parametrize("name", sorted(FAULT_DRAWS))
def test_fault_model_draws_equal_the_reference_s(name):
    nodes = [7, 3, 9, 5]
    for seed in (0, 4, 5, 7):
        got = FAULT_DRAWS[name](PORT.emu).draw(seed, nodes)
        want = FAULT_DRAWS[name](REF.emu).draw(seed, nodes)
        assert hexed(got) == hexed(want)


def test_effective_cluster_equals_the_reference_s():
    def sched(emu):
        return [emu.LinkDegrade(5.0, 0, 1, 0.5, None),
                emu.LinkDegrade(8.0, 0, 1, 0.5, 4.0),
                emu.NodeSlowdown(6.0, 2, 0.25, None),
                emu.LinkFault(9.0, 1, 2, 2.0),
                emu.WireLoss(1.0, 2, 3, 0.25, duration_s=10.0, seed=0),
                emu.NodeFault(12.0, 3)]
    for t in (0.0, 2.0, 6.0, 7.0, 9.0, 13.0, 20.0):
        got = PORT.emu.effective_cluster(uniform_cluster(PORT, 4),
                                         sched(PORT.emu), t)
        want = REF.emu.effective_cluster(uniform_cluster(REF, 4),
                                         sched(REF.emu), t)
        assert hexed([got.bw, got.compute_scale]) == \
            hexed([want.bw, want.compute_scale]), t


def test_vectorized_primitives_equal_the_reference_s():
    rng = np.random.default_rng(3)
    for n, c in ((0, 1.0), (1, 0.25), (300, 0.0), (400, 0.7)):
        a = np.add.accumulate(rng.exponential(0.5, n))
        assert np.array_equal(PORT.emu.lindley_scan(a, c),
                              REF.emu.lindley_scan(a, c))
    for seed, rate in ((0, 1.7), (1, None), (2, 0.2)):
        assert np.array_equal(
            PORT.emu.poisson_arrivals(200, rate,
                                      np.random.default_rng(seed)),
            REF.emu.poisson_arrivals(200, rate, np.random.default_rng(seed)))


def test_emulator_exports_the_reference_s():
    assert PORT.emu.__all__ == REF.emu.__all__
