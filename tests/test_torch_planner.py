"""The port's planner copies held to the reference planner on the CPU.

* ``repro_torch.core.equivalence`` replays every cell of the committed
  ``tests/data/planner_equivalence.json`` and must match it exactly (floats
  as ``float.hex``), with the reference's scenario ids and the fixture's
  shape checks;
* ``core.baselines`` (the paper's §6.1 random and joint-greedy algorithms
  and the exact optimum) equal to the reference's by ``runs``, ``nodes``
  and the hex of every float, on the random chains of
  ``tests/test_baselines.py`` and on paper CNNs, then the copies of that
  file's tests;
* ``plan_stages`` for the ten archs equal to the reference's in every
  ``StagePlan`` field (the SEIFER plan through ``describe()`` and its
  stage-execution IR), and the launcher's ``--plan`` printing the
  reference's ``describe()``;
* ``evaluate_plans`` rows equal to the reference's, floats by hex.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.configs import get_config as ref_get_config
from repro.configs.paper_cnns import PAPER_MODELS as REF_MODELS
from repro.core import equivalence as ref_equivalence
from repro.core.api import evaluate_plans as ref_evaluate_plans
from repro.core.pipeline import plan_stages as ref_plan_stages
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.paper_cnns import PAPER_MODELS
from repro_torch.core import (evaluate, exact_optimal_bottleneck,
                              joint_greedy, partition_and_place,
                              random_algorithm,
                              random_geometric_cluster, theorem1_bound,
                              tpu_cluster)
from repro_torch.core import equivalence
from repro_torch.core.api import evaluate_plans
from repro_torch.core.pipeline import plan_stages
from repro_torch.models.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "planner_equivalence.json"
FIX = json.loads(FIXTURE.read_text())
SCN = {sc["id"]: sc for sc in equivalence.scenarios()}


@pytest.fixture(autouse=True)
def wall_time(request):
    t0 = time.perf_counter()
    yield
    print(f"{request.node.name}: {time.perf_counter() - t0:.3f}s")


def hexed(x):
    """``x`` with every float as ``float.hex`` (numpy scalars and arrays,
    dicts, sequences and dataclasses walked), for exact comparison."""
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x).hex()
    if isinstance(x, np.ndarray):
        return hexed(x.tolist())
    if isinstance(x, dict):
        return {k: hexed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [hexed(v) for v in x]
    if dataclasses.is_dataclass(x):
        return [type(x).__name__, hexed(dataclasses.asdict(x))]
    return x


# ---------------------------------------------------------------------------
# the planner-equivalence fixture
# ---------------------------------------------------------------------------

def test_scenario_ids_are_the_reference_s():
    assert set(SCN) == {sc["id"] for sc in ref_equivalence.scenarios()}
    assert set(SCN) == set(FIX)


def test_fixture_exercises_the_planner():
    multi = [v for v in FIX.values() if "runs" in v and len(v["runs"]) >= 5]
    infeasible = [v for v in FIX.values() if "error" in v]
    assert len(multi) >= 10, "fixture must contain many-run plans"
    assert len(infeasible) >= 5, "fixture must cover infeasible paths"


@pytest.mark.parametrize("sid", sorted(SCN))
def test_plan_bit_identical(sid):
    assert equivalence.run_scenario(SCN[sid]) == FIX[sid]


def test_stage_budget_equals_the_reference_s():
    for arch in ARCH_IDS:
        for shape in ("decode_32k", "prefill_32k"):
            got = equivalence.stage_budget_bytes(get_config(arch),
                                                 SHAPES[shape], 0.25, 1.35)
            want = ref_equivalence.stage_budget_bytes(
                ref_get_config(arch), REF_SHAPES[shape], 0.25, 1.35)
            assert got.hex() == want.hex(), (arch, shape)


# ---------------------------------------------------------------------------
# baselines against the reference's
# ---------------------------------------------------------------------------

def make_chain(core, rng, n=10, out_hi=30, params=20e6):
    """``tests/test_baselines.py``'s random chain, built from ``core``."""
    g = core.LayerGraph()
    prev = ()
    for i in range(n):
        g.add(core.Layer(f"l{i}",
                         out_bytes=float(rng.integers(1, out_hi)) * 1e6,
                         param_bytes=params), prev)
        prev = (f"l{i}",)
    return g


def result_record(res):
    return {"runs": [list(r) for r in res.runs], "nodes": list(res.nodes),
            "sizes": hexed(res.sizes),
            "bottleneck": float(res.bottleneck_s).hex(),
            "evaluation": hexed(res.evaluation)}


# (graph, cluster seed and size, capacity): test_baselines.py's chains
# (graph seed, nodes, cluster seed, capacity) and three paper models
CHAINS = [(0, 10, 12, 1, 70e6), (3, 10, 12, 4, 70e6), (5, 10, 10, 6, 90e6),
          (7, 8, 10, 8, 70e6)]
MODELS = [("ResNet50", 10, 7, 64e6), ("ResNet50-12", 12, 7, 30e6),
          ("MobileNetV2", 12, 3, 11e6), ("InceptionResNetV2", 12, 5, 200e6),
          ("VGG16", 12, 5, 420e6)]
BASELINE_CASES = ([f"chain/{c[0]}" for c in CHAINS]
                  + [f"model/{m[0]}" for m in MODELS])


def baseline_instance(core, models, case):
    kind, name = case.split("/")
    if kind == "chain":
        seed, n, nodes, cseed, cap = next(c for c in CHAINS
                                          if str(c[0]) == name)
        g = make_chain(core, np.random.default_rng(seed), n=n)
    else:
        _, nodes, cseed, cap = next(m for m in MODELS if m[0] == name)
        g = models[name.split("-")[0]]()
    return g, core.random_geometric_cluster(nodes, rng=cseed), cap


@pytest.mark.parametrize("case", BASELINE_CASES)
def test_baselines_equal_the_reference_s(case):
    got, want = ({}, {})
    for out, core, models in ((got, port_core, PAPER_MODELS),
                              (want, ref_core, REF_MODELS)):
        g, cluster, cap = baseline_instance(core, models, case)
        out["random"] = [result_record(core.random_algorithm(
            g, cluster, cap, rng=s)) for s in range(5)]
        joint = core.joint_greedy(g, cluster, cap)
        out["joint"] = result_record(joint)
        plan = core.partition_and_place(g, cluster, cap, n_classes=3, rng=9)
        out["plan"] = [plan.describe(), float(plan.bottleneck_s).hex()]
        out["optimum"] = float(core.exact_optimal_bottleneck(
            plan.partition.boundary_sizes, cluster)).hex()
        out["optimum_joint"] = float(core.exact_optimal_bottleneck(
            joint.sizes, cluster)).hex()
    assert got == want
    # what holds by construction: the optimum is no worse than either plan
    assert float.fromhex(got["optimum"]) <= float.fromhex(got["plan"][1])
    assert (float.fromhex(got["optimum_joint"])
            <= float.fromhex(got["joint"]["bottleneck"]))


def test_baselines_exported_as_the_reference_exports_them():
    names = {"BaselineResult", "exact_optimal_bottleneck", "joint_greedy",
             "random_algorithm", "StagePlan", "plan_stages"}
    assert names <= set(port_core.__all__)
    assert set(ref_core.__all__) <= set(port_core.__all__)


class TestRandomAlgorithm:
    def test_feasible_plan(self):
        rng = np.random.default_rng(0)
        g = make_chain(port_core, rng)
        cluster = random_geometric_cluster(12, rng=1)
        res = random_algorithm(g, cluster, 70e6, rng=2)
        assert len(set(res.nodes)) == len(res.nodes)
        assert len(res.nodes) == len(res.sizes) + 1
        assert res.bottleneck_s > 0

    def test_random_varies_with_seed(self):
        rng = np.random.default_rng(0)
        g = make_chain(port_core, rng)
        cluster = random_geometric_cluster(12, rng=1)
        betas = {round(random_algorithm(g, cluster, 70e6,
                                        rng=s).bottleneck_s, 6)
                 for s in range(8)}
        assert len(betas) > 1


class TestJointGreedy:
    def test_feasible_and_beats_average_random(self):
        rng = np.random.default_rng(3)
        g = make_chain(port_core, rng)
        cluster = random_geometric_cluster(12, rng=4)
        jg = joint_greedy(g, cluster, 70e6)
        rand = np.mean([random_algorithm(g, cluster, 70e6,
                                         rng=s).bottleneck_s
                        for s in range(10)])
        assert jg.bottleneck_s <= rand

    def test_nodes_distinct(self):
        rng = np.random.default_rng(5)
        g = make_chain(port_core, rng)
        cluster = random_geometric_cluster(10, rng=6)
        jg = joint_greedy(g, cluster, 90e6)
        assert len(set(jg.nodes)) == len(jg.nodes)


class TestExactOptimal:
    def test_single_boundary_equals_theorem1(self):
        cluster = random_geometric_cluster(8, rng=0)
        sizes = [5e6]
        assert exact_optimal_bottleneck(sizes, cluster) == pytest.approx(
            theorem1_bound(sizes, cluster))

    def test_lower_bounds_hold(self):
        rng = np.random.default_rng(7)
        g = make_chain(port_core, rng, n=8)
        cluster = random_geometric_cluster(10, rng=8)
        plan = partition_and_place(g, cluster, 70e6, n_classes=3, rng=9)
        opt = exact_optimal_bottleneck(plan.partition.boundary_sizes,
                                       cluster)
        thm = theorem1_bound(plan.partition.boundary_sizes, cluster)
        assert thm <= opt * (1 + 1e-9)
        assert opt <= plan.bottleneck_s * (1 + 1e-9)

    def test_exact_is_truly_optimal_small(self):
        """Brute-force all node orderings on a tiny instance."""
        rng = np.random.default_rng(11)
        cluster = random_geometric_cluster(6, rng=rng)
        sizes = [3e6, 9e6, 1e6]
        opt = exact_optimal_bottleneck(sizes, cluster)
        best = min(
            evaluate(sizes, list(perm), cluster).bottleneck_s
            for perm in itertools.permutations(range(6), 4))
        assert opt == pytest.approx(best)


# ---------------------------------------------------------------------------
# plan_stages, the launcher's --plan, evaluate_plans
# ---------------------------------------------------------------------------

def stage_plan_record(sp):
    """Every StagePlan field: the SEIFER plan by ``describe()``, its
    bottleneck and IR, the cluster by its arrays."""
    return {"describe": sp.describe(),
            "bottleneck": float(sp.plan.bottleneck_s).hex(),
            "n_stages": sp.n_stages,
            "stage_of_block": dict(sp.stage_of_block),
            "boundary_bytes": hexed(sp.boundary_bytes),
            "cut_after": list(sp.cut_after),
            "cfg": dataclasses.asdict(sp.cfg),
            "cluster": hexed([sp.cluster.bw, sp.cluster.compute_scale]),
            "ir": hexed(dataclasses.asdict(sp.execution_plan())),
            "ir8": hexed(dataclasses.asdict(sp.execution_plan(
                wire_bits=8)))}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape,budget", [("prefill_32k", 16e9 * 32),
                                          ("decode_32k", None)])
def test_plan_stages_equal_the_reference_s(arch, shape, budget):
    """The launcher's plan (the 2-pod production cluster, a 512 GB stage
    budget) and the fixture's (the jittered cluster, its stage budget)."""
    if budget is None:
        budget = equivalence.stage_budget_bytes(get_config(arch),
                                                SHAPES[shape], 0.25, 1.35)
        kw = dict(jitter=0.3, rng=17)
    else:
        kw = {}
    got = plan_stages(get_config(arch), SHAPES[shape],
                      cluster=tpu_cluster(n_pods=2, slots_per_pod=8, **kw),
                      hbm_per_stage_bytes=budget)
    want = ref_plan_stages(ref_get_config(arch), REF_SHAPES[shape],
                           cluster=ref_core.tpu_cluster(n_pods=2,
                                                        slots_per_pod=8,
                                                        **kw),
                           hbm_per_stage_bytes=budget)
    assert stage_plan_record(got) == stage_plan_record(want)
    assert got.n_stages == len(set(got.stage_of_block.values()))


def test_launcher_plan_prints_the_reference_describe():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-2b", "--plan"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = ref_plan_stages(ref_get_config("granite-3-2b"),
                           REF_SHAPES["prefill_32k"],
                           cluster=ref_core.tpu_cluster(n_pods=2,
                                                        slots_per_pod=8),
                           hbm_per_stage_bytes=16e9 * 32).describe()
    assert out.stdout == want + "\n"


def granite_plans(core, shapes, get):
    """The SEIFER plans of full-width granite-3-2b on the 10-node edge
    cluster at ``rng`` 0-2 (the capacity ``chip_smoke.py`` plans with)."""
    pipeline = import_module(core.__name__ + ".pipeline")
    graph = pipeline.lm_block_graph(get("granite-3-2b"),
                                    type(shapes["prefill_32k"])(
                                        "serve", 512, 4, "prefill"))
    cluster = core.random_geometric_cluster(10, rng=7)
    pts = graph.candidate_partition_points()
    segs = graph.segment_layers(pts)
    min_cap = max(graph.run_memory_bytes(pts, segs, i, i)
                  for i in range(len(pts)))
    cap = max(graph.total_param_bytes() / 3.5, min_cap * 1.2)
    return [core.partition_and_place(graph, cluster, cap, n_classes=3,
                                     rng=r) for r in range(3)], cluster


def rows_record(rows):
    return [dict(hexed({k: v for k, v in r.items() if k != "plan"}),
                 plan=r["plan"].describe()) for r in rows]


def ranked_rows(core, shapes, get, evaluate, fault_model):
    """``evaluate_plans`` of granite's plans in one package, as records."""
    plans, cluster = granite_plans(core, shapes, get)
    model = None
    if fault_model:
        emu = import_module(core.__name__.replace(".core", ".emulator"))
        model = emu.RandomNodeFaults(n_faults=1, window_s=(2.0, 10.0))
    return rows_record(evaluate(plans, cluster, seeds=(0, 1, 2, 3),
                                n_batches=60, fault_model=model))


@pytest.mark.parametrize("fault_model", [None, "nodes"])
def test_evaluate_plans_equal_the_reference_s(fault_model):
    got = ranked_rows(port_core, SHAPES, get_config, evaluate_plans,
                      fault_model)
    want = ranked_rows(ref_core, REF_SHAPES, ref_get_config,
                       ref_evaluate_plans, fault_model)
    assert got == want
    assert len(got) == 3


def test_core_does_not_import_the_emulator_at_load():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.core, repro_torch.core.pipeline\n"
            "sys.exit(any(m.startswith('repro_torch.emulator') "
            "for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
