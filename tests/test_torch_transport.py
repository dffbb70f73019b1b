"""The port's copies of the fault surface's host-side modules, and its
boundary transport, held against the reference.

* ``serve/retry.py``: the same delays, jitter streams, validation and
  attempt histories;
* ``serve/transport.py``: the same seeded and parsed fault schedules, the
  same heartbeat grades, and a ported ``BoundaryTransport`` that, fed the
  bytes the reference's is fed (bf16 raw payloads (2, 12, D) and int8
  ``(q, scale)`` payloads, D = 64 and 2048) under the same schedules,
  gives the same CRC32s, per-hop stats, events and exactly-once verdict,
  and delivers each payload bit for bit;
* ``serve/telemetry.py``: the same ring buffers, folds and materialised
  clusters, bit for bit;
* ``core/replan.py`` and ``placement.replicate_bottlenecks``: the same
  results on the replan cells' plans and on the planner's granite plan
  over ``random_geometric_cluster(10, rng=7)``.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import cluster as jax_cluster
from repro.core import placement as jax_placement
from repro.core import replan as jax_replan
from repro.core import from_block_cuts as jax_from_block_cuts
from repro.configs import get_config as jax_get_config
from repro.models.config import SHAPES as JAX_SHAPES
from repro.serve import retry as jax_retry
from repro.serve import telemetry as jax_telemetry
from repro.serve import transport as jax_transport
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.core import placement, replan
from repro_torch.kernels.quantize.ops import rowwise_quantize
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.serve import retry, telemetry, transport

N_STEPS = 8
WIRE_CELL = [["drop", 0, 1], ["corrupt", 1, 2, 3], ["dup", 0, 3],
             ["reorder", 1, 4], ["stall", 0, 5, 3.0]]


def faults_record(faults):
    return [(type(f).__name__, dataclasses.astuple(f)) for f in faults]


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

POLICIES = [{}, {"attempts": 5, "base_delay_s": 0.05},
            {"attempts": 6, "base_delay_s": 0.01, "backoff": 3.0,
             "max_delay_s": 0.2},
            {"attempts": 4, "jitter": 0.5, "jitter_seed": 7},
            {"attempts": 4, "jitter": 1.0}]


@pytest.mark.parametrize("kw", POLICIES)
def test_retry_policy_delays_and_jitter(kw):
    mine, ref = retry.RetryPolicy(**kw), jax_retry.RetryPolicy(**kw)
    assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    for salt in ("wire hop 0 frame 3", "stage 1: checkpoint restore"):
        a, b = mine.jitter_stream(salt), ref.jitter_stream(salt)
        us = [next(a) for _ in range(6)]
        assert us == [next(b) for _ in range(6)]
        assert [mine.delay_s(i, u).hex() if u is not None else
                mine.delay_s(i, u) for i, u in enumerate(us)] == \
            [ref.delay_s(i, u).hex() if u is not None else ref.delay_s(i, u)
             for i, u in enumerate(us)]


@pytest.mark.parametrize("kw", [{"attempts": 0}, {"base_delay_s": -1.0},
                                {"max_delay_s": -1.0}, {"backoff": 0.5},
                                {"jitter": 1.5}])
def test_retry_policy_refuses_the_same(kw):
    with pytest.raises(ValueError) as mine:
        retry.RetryPolicy(**kw)
    with pytest.raises(ValueError) as ref:
        jax_retry.RetryPolicy(**kw)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw", POLICIES)
@pytest.mark.parametrize("fails", [0, 2, 10])
def test_retry_call_histories(kw, fails):
    def run(mod):
        left, slept = [fails], []

        def fn():
            if left[0]:
                left[0] -= 1
                raise OSError(f"blip {left[0]}")
            return "ok"

        try:
            out = mod.retry_call(fn, what="stage 1: restore",
                                 policy=mod.RetryPolicy(**kw),
                                 retry_on=(OSError,), sleep=slept.append)
        except mod.RetryExhausted as e:
            out = (str(e), e.what, [dataclasses.astuple(a)
                                    for a in e.attempts])
        return out, slept

    assert run(retry) == run(jax_retry)


def test_retry_call_lets_other_errors_through():
    for mod in (retry, jax_retry):
        with pytest.raises(KeyError):
            mod.retry_call(lambda: {}["x"], what="w", retry_on=(OSError,),
                           sleep=lambda s: None)


# ---------------------------------------------------------------------------
# fault schedules and the heartbeat monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("n_hops,n_xfers,rate", [(3, 32, 0.2), (1, 32, 0.2),
                                                 (2, 50, 0.5)])
def test_seeded_wire_faults_same_schedules(seed, n_hops, n_xfers, rate):
    mine = transport.seeded_wire_faults(seed, n_hops, n_xfers, rate,
                                        stall_s=2.5)
    assert faults_record(mine) == faults_record(
        jax_transport.seeded_wire_faults(seed, n_hops, n_xfers, rate,
                                         stall_s=2.5))


def test_parse_wire_faults_same():
    specs = WIRE_CELL + [["corrupt", 0, 7], ["stall", 1, 9]]
    assert faults_record(transport.parse_wire_faults(specs)) == \
        faults_record(jax_transport.parse_wire_faults(specs))


def test_heartbeat_monitor_grades_the_same():
    out = []
    for mod in (transport, jax_transport):
        clk = mod.FakeWireClock()
        mon = mod.HeartbeatMonitor(3, suspect_after_s=1.5, dead_after_s=4.0,
                                   poll_s=0.25, clock=clk, sleep=clk.sleep)
        rec = []
        for t in range(40):
            if t % 3:
                mon.beat(t % 3)
            mon.wait()
            rec.append((clk.now(), mon.report(),
                        [mon.silence_s(k) for k in range(3)],
                        [mon.last_beat(k) for k in range(3)]))
        out.append(rec)
        for bad in ({"suspect_after_s": 5.0, "dead_after_s": 4.0},
                    {"poll_s": 0.0}):
            with pytest.raises(ValueError):
                mod.HeartbeatMonitor(3, **bad)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the transport: the same bytes under the same schedules
# ---------------------------------------------------------------------------

def payloads(d, int8):
    """N_STEPS payloads per hop: (2, 12, d) then (2, 1, d) bf16 rows — as
    the port's tensors and the reference's arrays of the same bytes —
    int8-quantised by the port's wire when ``int8``."""
    rng = np.random.default_rng(d)
    out = []
    for i in range(N_STEPS):
        s = 12 if i == 0 else 1
        x = rng.standard_normal((2, s, d), dtype=np.float32).astype(
            ml_dtypes.bfloat16)
        x[0, 0, :3] = 0
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        if int8:
            q, sc = rowwise_quantize(t)
            out.append(((q, sc), (jnp.asarray(q.numpy()),
                                  jnp.asarray(sc.numpy()))))
        else:
            out.append((t, jnp.asarray(x)))
    return out


def leaves_bytes(payload):
    leaves = payload if isinstance(payload, tuple) else (payload,)
    return [np.asarray(a).tobytes() if not isinstance(a, torch.Tensor)
            else a.contiguous().view(torch.uint8).numpy().tobytes()
            for a in leaves]


SCHEDULES = {"cell": transport.parse_wire_faults(WIRE_CELL),
             "seeded": transport.seeded_wire_faults(0, 2, N_STEPS, rate=0.5),
             "none": []}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 2048])
def test_transport_matches_reference(schedule, int8, d):
    faults = SCHEDULES[schedule]
    jfaults = jax_transport.parse_wire_faults(
        [[{"Drop": "drop", "CorruptPayload": "corrupt", "Duplicate": "dup",
           "Reorder": "reorder", "Stall": "stall"}[type(f).__name__],
          *dataclasses.astuple(f)] for f in faults])
    runs = []
    for mod, side in ((transport, 0), (jax_transport, 1)):
        clk = mod.FakeWireClock()
        mon = mod.HeartbeatMonitor(3, clock=clk, sleep=clk.sleep)
        tr = mod.BoundaryTransport(
            2, faults=faults if side == 0 else jfaults,
            policy=mod.RetryPolicy(attempts=6, base_delay_s=0.05),
            monitor=mon, clock=clk, sleep=clk.sleep)
        crcs, got = [], []
        for step, pair in enumerate(payloads(d, int8)):
            for hop in range(2):
                sent = pair[side]
                frame, _ = tr._to_frame(0, sent)
                crcs.append(frame.crc)
                out = tr.send(hop, sent)
                assert leaves_bytes(out) == leaves_bytes(sent)
                if side == 0:
                    leaves = out if int8 else (out,)
                    assert [t.dtype for t in leaves] == (
                        [torch.int8, torch.float32] if int8
                        else [torch.bfloat16])
                mon.beat(hop + 1)
                got.append(leaves_bytes(out))
        runs.append((crcs, [dataclasses.asdict(s) for s in tr.stats],
                     list(tr.events), tr.exactly_once(), got))
    assert runs[0] == runs[1]
    assert runs[0][3]                          # exactly once


def test_transport_crc_rejects_every_flipped_bit():
    """A corrupt frame is refused wherever the flipped bit falls, in any
    leaf of the int8 payload."""
    x = torch.randn(2, 3, 64).to(torch.bfloat16)
    payload = rowwise_quantize(x)
    tr = transport.BoundaryTransport(1)
    frame, _ = tr._to_frame(0, payload)
    total = 8 * sum(a.nbytes for a in frame.leaves)
    for bit in range(0, total, 37):
        bad = tr._corrupted(frame, bit)
        assert transport._crc_leaves(bad.leaves) != frame.crc


def test_transport_reads_views_and_delivers_to_the_device_asked():
    x = torch.randn(4, 6, 32).to(torch.bfloat16)
    view = x[:, ::2]                           # not contiguous
    tr = transport.BoundaryTransport(1)
    out = tr.send(0, view, device="cpu")
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.equal(out.view(torch.int16), view.contiguous().view(
        torch.int16))
    assert tr.stats[0].bytes == view.numel() * 2


def test_transport_exhausts_with_history():
    for mod in (transport, jax_transport):
        tr = mod.BoundaryTransport(
            1, faults=[mod.Drop(0, 0)] * 3,
            policy=mod.RetryPolicy(attempts=3, base_delay_s=0.0),
            sleep=lambda s: None)
        x = (torch.zeros(1, 1, 8) if mod is transport
             else jnp.zeros((1, 1, 8)))
        with pytest.raises(mod.WireExhausted) as ei:
            tr.send(0, x)
        assert len(ei.value.attempts) == 3
        assert not tr.exactly_once()
        with pytest.raises(ValueError, match="targets hop"):
            mod.BoundaryTransport(1, faults=[mod.Drop(1, 0)])


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def uniform_cluster(mod, n, bw_val=200e6):
    bw = np.full((n, n), bw_val)
    np.fill_diagonal(bw, 0.0)
    return mod.ClusterGraph(bw=bw, pos=np.zeros((n, 2)),
                            labels=[f"n{i}" for i in range(n)],
                            compute_scale=np.ones(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_and_cluster_state_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    samples = [(int(rng.integers(-2, 5)), float(rng.uniform(0, 1e7)),
                float(rng.uniform(-0.1, 2.0))) for _ in range(300)]
    compute = [(int(rng.integers(0, 6)), float(rng.uniform(0, 3)),
                float(rng.uniform(0, 2))) for _ in range(40)]
    reports = [{k: str(rng.choice(["up", "suspected", "dead"]))
                for k in range(3)} for _ in range(5)]
    out = []
    for tmod, cmod in ((telemetry, core), (jax_telemetry, jax_cluster)):
        tel = tmod.TelemetryStream(4, capacity=64)
        for st, nb, s in samples:
            tel.record_transfer(st, nb, s)
            if 0 <= st < 4:
                tel.record_decode(st, s)
            tel.record_queue_depth(abs(st))
        snap = tel.snapshot()
        state = tmod.ClusterState(uniform_cluster(cmod, 6), alpha=0.25)
        folded = state.fold(tel, [1, 2, 3], dispatcher_node=0)
        for node, s, nominal in compute:
            state.observe_compute(node, s, nominal)
        rec = [snap, tel.dropped, folded, state.dropped]
        for rep in reports:
            rec.append(state.fold_health(rep, [1, 4, 5]))
            est = state.as_cluster()
            rec += [est.bw.tobytes(), est.compute_scale.tobytes(),
                    sorted(state.suspected)]
        rec += [state.bw.tobytes(), state.compute_scale.tobytes(),
                tel.decode_s[0].mean(), len(tel.drain_transfers())]
        out.append(rec)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# replan and replicate_bottlenecks
# ---------------------------------------------------------------------------

def replan_record(res):
    return ([(type(m).__name__, dataclasses.astuple(m)) for m in res.moves],
            res.bottleneck_before_s.hex(), res.bottleneck_after_s.hex(),
            dataclasses.asdict(res.plan), res.changed, res.migrated_stages)


def replan_cell_plans(arch):
    """The replan cells' plan (cut 2 of the 4-layer smoke model, priced
    at decode_32k, one spare) in both packages, and a drifted estimate:
    the hops that carried traffic slowed as the cells' telemetry slows
    them."""
    out = []
    for cmod, gcfg, cuts, shapes, tmod in (
            (core, get_config, core.from_block_cuts, SHAPES, telemetry),
            (jax_cluster, jax_get_config, jax_from_block_cuts, JAX_SHAPES,
             jax_telemetry)):
        cfg = gcfg(arch, "smoke").replace(n_layers=4)
        plan = cuts(cfg, [2], nodes=(0, 1, 2), spare_nodes=(3,),
                    shape=shapes["decode_32k"])
        state = tmod.ClusterState(uniform_cluster(cmod, 4))
        for _ in range(3):
            state.observe_bandwidth(0, 1, 4096.0, 1.0)
            state.observe_bandwidth(1, 2, 4096.0, 1.0)
        out.append((plan, state.as_cluster()))
    return out


def planned_granite():
    """The planner's 4-stage granite-3-2b plan over
    ``random_geometric_cluster(10, rng=7)``, as ``chip_smoke.py`` plans
    it, in both packages."""
    from repro import core as jax_core
    from repro.core.pipeline import lm_block_graph as jax_lm_block_graph
    from repro.models.config import ShapeConfig as JaxShapeConfig
    out = []
    for pkg, lbg, shape_cls, gcfg in (
            (core, core.lm_block_graph, ShapeConfig, get_config),
            (jax_core, jax_lm_block_graph, JaxShapeConfig, jax_get_config)):
        cfg = gcfg("granite-3-2b", "full")
        graph = lbg(cfg, shape_cls("serve", 512, 4, "prefill"))
        cluster = pkg.random_geometric_cluster(10, rng=7)
        pts = graph.candidate_partition_points()
        segs = graph.segment_layers(pts)
        min_cap = max(graph.run_memory_bytes(pts, segs, i, i)
                      for i in range(len(pts)))
        cap = max(graph.total_param_bytes() / 3.5, min_cap * 1.2)
        plan = pkg.partition_and_place(graph, cluster, cap, n_classes=3,
                                       rng=8)
        out.append((plan.execution_plan(cluster, wire_bits=0,
                                        arch=cfg.name), cluster))
    return out


def planned_and_drifted():
    """The planned granite plan, and the same cluster with the links of
    the planned hops slowed to a tenth."""
    (ep, cl), (jep, jcl) = planned_granite()
    assert dataclasses.asdict(ep) == dataclasses.asdict(jep)
    bw = cl.bw.copy()
    nodes = ep.nodes
    for a, b in zip(nodes[:-1], nodes[1:]):
        bw[a, b] = bw[b, a] = bw[a, b] / 10
    return [(ep, dataclasses.replace(cl, bw=bw)),
            (jep, dataclasses.replace(jcl, bw=bw.copy()))]


CASES = {"granite-replan-cell": lambda: replan_cell_plans("granite-3-2b"),
         "mamba2-replan-cell": lambda: replan_cell_plans("mamba2-1.3b"),
         "granite-planned": planned_granite,
         "granite-planned-drifted": planned_and_drifted}


@pytest.fixture(scope="module")
def plans():
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = CASES[name]()
        return memo[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("allow_replicas", [False, True])
@pytest.mark.parametrize("max_moves,min_gain_s", [(1, 0.0), (3, 0.0),
                                                  (2, 1e-3)])
def test_incremental_replan_matches_reference(plans, name, allow_replicas,
                                              max_moves, min_gain_s):
    (plan, cl), (jplan, jcl) = plans(name)
    kw = dict(max_moves=max_moves, min_gain_s=min_gain_s,
              allow_replicas=allow_replicas)
    mine = replan.incremental_replan(plan, cl, **kw)
    ref = jax_replan.incremental_replan(jplan, jcl, **kw)
    assert replan_record(mine) == replan_record(ref)
    for fn in ("stage_costs", "effective_stage_costs"):
        assert [c.hex() for c in getattr(replan, fn)(mine.plan, cl)] == \
            [c.hex() for c in getattr(jax_replan, fn)(ref.plan, jcl)]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kw", [{"budget": 1, "keep_spares": 1}, {},
                                {"budget": 3, "max_replicas": 3},
                                {"keep_spares": 2}])
def test_replicate_bottlenecks_matches_reference(plans, name, kw):
    (plan, cl), (jplan, jcl) = plans(name)
    mine = placement.replicate_bottlenecks(plan, cl, **kw)
    ref = jax_placement.replicate_bottlenecks(jplan, jcl, **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    # and a replan of the replicated plan, which may promote a replica
    res = replan.incremental_replan(mine, cl, max_moves=2,
                                    allow_replicas=True)
    jres = jax_replan.incremental_replan(ref, jcl, max_moves=2,
                                         allow_replicas=True)
    assert replan_record(res) == replan_record(jres)
