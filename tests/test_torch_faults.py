"""The pipeline's fault surface in the port, held against the reference.

The ten committed gate cells of ``tests/data/serve_equivalence.json``
(framed wire under injected faults, a heartbeat-detected silent kill, a
telemetry-driven live migration, warm replicas and their kills) are served
by the port's ``PipelineServeEngine``, built as
``repro.serve.equivalence.build_pipeline_engine`` builds the reference's
(``port_pipeline`` below).  Each cell:

1. the port's tokens bit-identical to its own undisturbed raw-wire
   pipeline over the same cuts: faults, routing and migration reorder
   execution, never math;
2. held to the cell's pin under the gap contract of
   ``tests/test_torch_pins.py`` (its checks, reused; the reference's
   logits computed once per model);
3. the fault bookkeeping equal to the reference engine's run of the same
   cell: nodes, replicas, spares, routing counts, incidents, detections on
   the fake clock, the transport's per-hop stats and events, the telemetry,
   the replan result (its estimates by ``float.hex``) and the event
   messages without their wall-clock times.  The reference's bookkeeping
   does not depend on the weights, so it is run on the pins' weights.

Then the engine's API, mirroring the reference's
``tests/test_pipeline_serve.py``: restores under retry, the wire and
silent failures, migration, replanning and replicas, on the granite smoke
model with the port's own weights.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.serve import PipelineServeEngine as JaxPipelineServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.equivalence import _replan_arg as jax_replan_arg
from repro.serve.equivalence import _StepClock
from repro.serve.equivalence import build_pipeline_engine
from repro_torch.checkpoint import CheckpointCorrupt
from repro_torch.configs import get_config
from repro_torch.core import ClusterGraph, from_block_cuts
from repro_torch.models import init_params
from repro_torch.models.config import SHAPES
from repro_torch.serve import pipeline as pl
from repro_torch.serve.engine import make_batch
from repro_torch.serve.pipeline import (PipelineServeEngine, ReplicaLost,
                                        RestoreExhausted, StageDegraded,
                                        StageDown)
from repro_torch.serve.retry import RetryPolicy
from repro_torch.serve.telemetry import ClusterState, TelemetryStream
from repro_torch.serve.transport import (BoundaryTransport, FakeWireClock,
                                         HeartbeatMonitor, parse_wire_faults)
from test_torch_pins import (PINS, SCENARIOS, cell, hold_to_pin,
                             pin_evidence)
from test_torch_transport import replan_record

torch.set_num_threads(2)

GATES = ["pipeline/granite-3-2b/cut1-3-wire",
         "pipeline/granite-3-2b/cut2-wire-silentkill",
         "pipeline/granite-3-2b/cut2-replan",
         "pipeline/granite-3-2b/cut2-replica",
         "pipeline/granite-3-2b/cut2-replica-kill",
         "pipeline/granite-3-2b/cut2-replica-lastkill",
         "pipeline/mamba2-1.3b/cut1-3-wire",
         "pipeline/mamba2-1.3b/cut2-replan",
         "pipeline/mamba2-1.3b/cut2-replica-kill",
         "pipeline/whisper-large-v3/cut2-wire"]


# ---------------------------------------------------------------------------
# the gate cells
# ---------------------------------------------------------------------------

def port_pipeline(sc, cfg, params):
    """The port's engine for a pipeline scenario, as the reference's
    ``build_pipeline_engine`` builds its own: replan cells on a
    shape-priced plan over a uniform 200e6 cluster with one spare and a
    TelemetryStream on a step clock; wire and silent-kill cells with a
    transport (the cell's faults, 6 attempts) and a heartbeat monitor on
    one fake clock; ``-overlap`` cells with the overlapped executor and
    the cell's micro-batches."""
    ov = sc.get("overlap") or {}
    executor = {"overlap": bool(ov), "micro_batches": ov.get("micro_batches")}
    if sc.get("replan"):
        n_st = len(sc["cuts"]) + 1
        n = n_st + 2                     # dispatcher + stages + one spare
        bw = np.full((n, n), 200e6)
        np.fill_diagonal(bw, 0.0)
        cluster = ClusterGraph(bw=bw, pos=np.zeros((n, 2)),
                               labels=[f"n{i}" for i in range(n)],
                               compute_scale=np.ones(n))
        plan = from_block_cuts(cfg, sc["cuts"], nodes=tuple(range(n_st + 1)),
                               spare_nodes=(n_st + 1,),
                               shape=SHAPES["decode_32k"])
        return PipelineServeEngine(
            cfg, params, plan, max_len=sc["max_len"], kv_block=sc["kv_block"],
            cluster=cluster, telemetry=TelemetryStream(n_st,
                                                       clock=_StepClock()),
            **executor)
    plan = from_block_cuts(cfg, sc["cuts"], spare_nodes=(900, 901),
                           replicas=sc.get("replicas"))
    transport = monitor = None
    kills = sc.get("kill") or []
    kills = [kills] if isinstance(kills, dict) else list(kills)
    if sc.get("wire") is not None or any(k.get("silent") for k in kills):
        n_st = len(sc["cuts"]) + 1
        clk = FakeWireClock()
        monitor = HeartbeatMonitor(n_st, clock=clk, sleep=clk.sleep)
        if sc.get("wire") is not None:
            transport = BoundaryTransport(
                n_st - 1, faults=parse_wire_faults(sc["wire"]),
                policy=RetryPolicy(attempts=6, base_delay_s=0.05),
                monitor=monitor, clock=clk, sleep=clk.sleep)
    return PipelineServeEngine(cfg, params, plan, max_len=sc["max_len"],
                               kv_block=sc["kv_block"], transport=transport,
                               monitor=monitor, **executor)


def replan_arg(sc, peng):
    spec = sc.get("replan")
    if spec is None:
        return None
    return {"after_step": spec["after_step"],
            "cluster": ClusterState(peng.cluster),
            "max_moves": spec.get("max_moves", 1)}


def capture_replans(eng):
    """Record every ReplanResult the engine's ``replan_live`` returns."""
    got, live = [], eng.replan_live

    def wrapped(*a, **kw):
        got.append(live(*a, **kw))
        return got[-1]

    eng.replan_live = wrapped
    return got


def bookkeeping(eng, replans):
    tr = eng.transport
    tel = eng.telemetry
    return {
        "node_of_stage": list(eng.node_of_stage),
        "replica_nodes": [list(r) for r in eng.replica_nodes],
        "spares": list(eng.spares),
        "served": [dict(s) for s in eng._served],
        "down": sorted(eng.down),
        "incidents": [dataclasses.astuple(i) for i in eng.incidents],
        "detections": list(eng.detections),
        "events": [m for _, m in eng.events],
        "hops": None if tr is None else [dataclasses.asdict(s)
                                         for s in tr.stats],
        "wire_events": None if tr is None else list(tr.events),
        "exactly_once": None if tr is None else tr.exactly_once(),
        "telemetry": None if tel is None else tel.snapshot(),
        "replans": [replan_record(r) for r in replans],
    }


@pytest.fixture(scope="module")
def models():
    """(arch -> the pins' model, batch and pin evidence), each computed
    once: the ten cells share batch 2, prompt 12, 8 tokens and seed 0
    with the plain ``pipeline/`` cells of their model, so their pins are
    those cells' monolithic reference tokens."""
    memo = {}

    def get(cid):
        arch = cid.split("/")[1]
        if arch not in memo:
            sc, jcfg, jp, cfg, params, batch = cell(cid)
            pin = np.asarray(PINS[cid]["tokens"])
            memo[arch] = (jcfg, jp, cfg, params, batch, pin_evidence(
                jcfg, jp, cfg, params, sc, batch, pin))
        return memo[arch]

    return get


@pytest.mark.parametrize("cid", GATES)
def test_gate_cell(cid, models):
    sc = SCENARIOS[cid]
    jcfg, jp, cfg, params, batch, evidence = models(cid)
    peng = port_pipeline(sc, cfg, params)
    port_replans = capture_replans(peng)
    got = peng.generate(batch, sc["gen_len"], kill=sc.get("kill"),
                        replan=replan_arg(sc, peng))

    # 1. faults, routing and migration change no token
    calm = PipelineServeEngine(cfg, params, from_block_cuts(
        cfg, sc["cuts"], spare_nodes=(900, 901)), max_len=sc["max_len"],
        kv_block=sc["kv_block"]).generate(batch, sc["gen_len"])
    np.testing.assert_array_equal(got, calm)

    # 2. the pin, under the gap contract
    hold_to_pin(cid, jcfg, jp, cfg, params, sc, batch, got, evidence)

    # 3. the reference engine's bookkeeping of the same cell
    jeng = build_pipeline_engine(sc, JaxServeEngine(
        jcfg, jp, max_len=sc["max_len"], kv_block=sc["kv_block"]))
    jax_replans = capture_replans(jeng)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    jeng.generate(jbatch, sc["gen_len"], kill=sc.get("kill"),
                  replan=jax_replan_arg(sc, jeng))
    want, have = bookkeeping(jeng, jax_replans), bookkeeping(peng,
                                                             port_replans)
    for key in want:
        assert have[key] == want[key], key
    # what the cell exercises really happened
    msgs = have["events"]
    if sc.get("wire"):
        assert have["exactly_once"] and any(
            h["retransmits"] for h in have["hops"])
        assert not any("rescheduled" in m for m in msgs)
    if "silentkill" in cid:
        assert len(have["detections"]) == 1
        assert any("CONFIRMED DEAD" in m for m in msgs)
    if sc.get("replan"):
        assert have["replans"] and have["replans"][0][0]
        assert any("MIGRATED" in m for m in msgs)
    if sc.get("replicas"):
        assert (have["incidents"] if sc.get("kill")
                else set(have["served"][1]) == {2, 10})


# ---------------------------------------------------------------------------
# the engine's API (the reference's tests/test_pipeline_serve.py)
# ---------------------------------------------------------------------------

FAST_RETRY = RetryPolicy(attempts=3, base_delay_s=0.0)


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device="cpu")


@pytest.fixture(scope="module")
def clean(granite):
    """The undisturbed tokens of the engines below (batch 1, prompt 8)."""
    cfg, params = granite
    batch = make_batch(cfg, 1, 8, 3)
    plan = from_block_cuts(cfg, [2], spare_nodes=(90,))
    eng = PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16)
    return batch, eng.generate(batch, 6)


def dense_engine(granite, tmp_path, spares=(90,), **kw):
    cfg, params = granite
    plan = from_block_cuts(cfg, [2], spare_nodes=spares)
    return PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16,
                               ckpt_dir=tmp_path / "ckpt", **kw)


def replicated_engine(granite, tmp_path, replicas={1: (10,)},
                      spares=(90, 91)):
    cfg, params = granite
    plan = from_block_cuts(cfg, [2], spare_nodes=spares, replicas=replicas)
    return PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16,
                               ckpt_dir=tmp_path / "ckpt")


def msgs(eng):
    return [m for _, m in eng.events]


def test_kill_restore_replay_events(granite, clean, tmp_path):
    batch, want = clean
    eng = dense_engine(granite, tmp_path)
    toks = eng.generate(batch, 6, kill={"after_step": 2, "stage": 1})
    np.testing.assert_array_equal(toks, want)
    m = msgs(eng)
    assert any("FAILED" in x for x in m)
    assert any("rescheduled" in x and "restored from checkpoint" in x
               for x in m)
    assert any("replayed" in x for x in m)
    assert eng.node_of_stage[1] == 90
    assert (tmp_path / "ckpt" / "stage_1" / "step_00000000").exists()


def test_no_spare_stalls(granite, clean, tmp_path):
    eng = dense_engine(granite, tmp_path, spares=(), retry=FAST_RETRY)
    with pytest.raises(StageDown):
        eng.generate(clean[0], 6, kill={"after_step": 1, "stage": 0})
    assert any("NO SPARE NODE" in x for x in msgs(eng))


def test_dead_stage_refuses_work(granite, clean, tmp_path):
    eng = dense_engine(granite, tmp_path)
    eng.kill_stage(0)
    with pytest.raises(StageDown):
        eng.kill_stage(0)
    eng.restore_stage(0)
    assert eng.generate(clean[0], 4).shape == (1, 4)


@pytest.mark.parametrize("when", ["after_prefill", "before_prefill"])
def test_stage0_kill_is_restored(granite, clean, tmp_path, when):
    batch, want = clean
    eng = dense_engine(granite, tmp_path)
    if when == "after_prefill":
        toks = eng.generate(batch, 6, kill={"after_step": 0, "stage": 0})
    else:
        eng.kill_stage(0)                  # dies between generate calls
        toks = eng.generate(batch, 6)      # restored before prefill
    np.testing.assert_array_equal(toks, want)
    assert not eng.down
    assert any("rescheduled" in x for x in msgs(eng))


def test_double_kill_before_restore_raises_stage_down(granite, clean,
                                                      tmp_path):
    eng = dense_engine(granite, tmp_path, spares=(90, 91))
    eng.kill_stage(0)
    with pytest.raises(StageDown):
        eng.kill_stage(0)
    eng.kill_stage(1)                      # a second stage can still die
    assert eng.down == {0, 1}
    toks = eng.generate(clean[0], 4)       # both restored before prefill
    assert toks.shape == (1, 4) and not eng.down


def test_empty_spare_pool_exhausts_with_history(granite, tmp_path):
    eng = dense_engine(granite, tmp_path, spares=(), retry=FAST_RETRY)
    eng.kill_stage(1)
    with pytest.raises(RestoreExhausted) as ei:
        eng.restore_stage(1)
    assert isinstance(ei.value, StageDown)
    assert len(ei.value.attempts) == 3
    assert all("no spare node" in a.error for a in ei.value.attempts)
    assert any("NO SPARE NODE" in x for x in msgs(eng))
    assert 1 in eng.down


def test_checkpoint_read_retries_then_exhausts(granite, tmp_path,
                                               monkeypatch):
    eng = dense_engine(granite, tmp_path, retry=FAST_RETRY)
    eng.kill_stage(1)
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        raise OSError("nfs: stale file handle")

    monkeypatch.setattr(pl, "restore_checkpoint", flaky)
    with pytest.raises(RestoreExhausted) as ei:
        eng.restore_stage(1)
    assert len(calls) == 3 and len(ei.value.attempts) == 3
    assert "stale file handle" in ei.value.attempts[-1].error
    assert 1 in eng.down and eng.spares == [90]     # nothing consumed
    monkeypatch.undo()
    eng.restore_stage(1)                            # retryable: now succeeds
    assert not eng.down and eng.node_of_stage[1] == 90


@pytest.mark.parametrize("error", [OSError("nfs timeout"),
                                   CheckpointCorrupt("torn page")])
def test_checkpoint_blip_recovers_within_retry_budget(granite, clean,
                                                      tmp_path, monkeypatch,
                                                      error):
    eng = dense_engine(granite, tmp_path, retry=FAST_RETRY)
    eng.kill_stage(1)
    real, fails = pl.restore_checkpoint, [2]

    def blips(*a, **kw):
        if fails[0] > 0:
            fails[0] -= 1
            raise error
        return real(*a, **kw)

    monkeypatch.setattr(pl, "restore_checkpoint", blips)
    eng.restore_stage(1)                            # 2 blips < 3 attempts
    assert not eng.down and fails == [0]
    np.testing.assert_array_equal(eng.generate(clean[0], 6), clean[1])


def test_engine_restore_rejects_corrupt_then_recovers(granite, tmp_path):
    eng = dense_engine(granite, tmp_path, retry=FAST_RETRY)
    eng.kill_stage(1)
    step_dir = tmp_path / "ckpt" / "stage_1" / "step_00000000"
    shutil.copytree(step_dir, step_dir.with_suffix(".bak"))
    leaf = step_dir / "leaf_0.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0x40                                 # last payload byte
    leaf.write_bytes(bytes(raw))
    with pytest.raises(RestoreExhausted) as ei:
        eng.restore_stage(1)
    assert "CheckpointCorrupt" in ei.value.attempts[-1].error
    assert 1 in eng.down and eng.spares == [90]     # pool untouched
    shutil.rmtree(step_dir)                         # repair the copy
    step_dir.with_suffix(".bak").rename(step_dir)
    eng.restore_stage(1)                            # retryable: recovers
    assert not eng.down


def wire(eng, faults=()):
    clk = FakeWireClock()
    mon = HeartbeatMonitor(eng.n_stages, clock=clk, sleep=clk.sleep)
    tr = BoundaryTransport(eng.n_stages - 1, faults=parse_wire_faults(faults),
                           policy=RetryPolicy(attempts=6, base_delay_s=0.0),
                           monitor=mon, clock=clk, sleep=clk.sleep)
    eng.attach_wire(tr, mon)
    return tr, mon


@pytest.mark.parametrize("wire_bits", [0, 8])
def test_tokens_identical_under_all_fault_kinds(granite, clean, tmp_path,
                                                wire_bits):
    cfg, params = granite
    batch, want = clean
    eng = PipelineServeEngine(cfg, params, from_block_cuts(
        cfg, [2], spare_nodes=(90,), wire_bits=wire_bits), max_len=32,
        kv_block=16, ckpt_dir=tmp_path / "c")
    if wire_bits:
        want = eng.generate(batch, 6)
    tr, _ = wire(eng, [["drop", 0, 1], ["corrupt", 0, 2, 9], ["dup", 0, 3],
                       ["reorder", 0, 4], ["stall", 0, 5, 3.0]])
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    assert tr.exactly_once()
    assert tr.total("retransmits") == 3            # drop, corrupt, reorder
    assert tr.total("stale_dropped") == 1
    assert not any("rescheduled" in x for x in msgs(eng))


def test_stall_surfaces_as_suspicion_not_restore(granite, clean, tmp_path):
    eng = dense_engine(granite, tmp_path)
    tr, _ = wire(eng, [["stall", 0, 2, 3.0]])
    eng.generate(clean[0], 6)
    assert tr.total("stalls") == 1 and tr.total("suspected") == 1
    assert eng.detections == []                    # suspected != dead
    assert not any("rescheduled" in x for x in msgs(eng))


def test_silent_kill_detected_then_restored_token_identical(granite, clean,
                                                            tmp_path):
    batch, want = clean
    eng = dense_engine(granite, tmp_path)
    wire(eng)
    toks = eng.generate(batch, 6, kill={"after_step": 2, "stage": 1,
                                        "silent": True})
    np.testing.assert_array_equal(toks, want)
    assert len(eng.detections) == 1
    stage, latency = eng.detections[0]
    assert stage == 1
    assert eng.monitor.dead_after_s <= latency <= \
        eng.monitor.dead_after_s + eng.monitor.poll_s
    m = msgs(eng)
    i_sil = next(i for i, x in enumerate(m) if "went SILENT" in x)
    i_sus = next(i for i, x in enumerate(m) if "SUSPECTED" in x)
    i_dead = next(i for i, x in enumerate(m) if "CONFIRMED DEAD" in x)
    i_res = next(i for i, x in enumerate(m) if "rescheduled" in x)
    assert i_sil < i_sus < i_dead < i_res          # graded escalation
    assert eng.node_of_stage[1] == 90


def test_fail_silent_requires_monitor(granite, tmp_path):
    eng = dense_engine(granite, tmp_path)
    with pytest.raises(ValueError, match="no heartbeat monitor"):
        eng.fail_silent(1)


def test_attach_wire_validates_hop_count(granite, tmp_path):
    eng = dense_engine(granite, tmp_path)
    with pytest.raises(ValueError, match="hop"):
        eng.attach_wire(BoundaryTransport(5))


def test_migrate_stage_keeps_tokens_and_recycles_node(granite, clean,
                                                      tmp_path):
    batch, want = clean
    eng = dense_engine(granite, tmp_path)
    assert eng.migrate_stage(1) == 90 and eng.node_of_stage[1] == 90
    assert eng.spares == [2]                        # vacated node recycled
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    assert any("MIGRATED" in x for x in msgs(eng))


def test_failed_migration_degrades_not_kills(granite, clean, tmp_path,
                                             monkeypatch):
    batch, want = clean
    eng = dense_engine(granite, tmp_path, retry=FAST_RETRY)
    monkeypatch.setattr(pl, "restore_checkpoint",
                        lambda *a, **kw: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(StageDegraded) as ei:
        eng.migrate_stage(1)
    assert len(ei.value.attempts) == 3
    assert eng.node_of_stage[1] == 2 and eng.spares == [90]
    assert not eng.down                             # still serving, degraded
    monkeypatch.undo()
    np.testing.assert_array_equal(eng.generate(batch, 6), want)


def test_migration_with_no_spare_degrades(granite, tmp_path):
    eng = dense_engine(granite, tmp_path, spares=())
    with pytest.raises(StageDegraded):
        eng.migrate_stage(0)
    assert not eng.down


def test_replan_live_noop_without_pressure(granite, tmp_path):
    cfg, params = granite
    n = 4
    bw = np.full((n, n), 1e9)
    np.fill_diagonal(bw, 0.0)
    cluster = ClusterGraph(bw=bw, compute_scale=np.ones(n))
    plan = from_block_cuts(cfg, [2], nodes=(0, 1, 2), spare_nodes=(3,),
                           shape=SHAPES["decode_32k"])
    eng = PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16,
                              ckpt_dir=tmp_path / "c", cluster=cluster)
    res = eng.replan_live(ClusterState(cluster))
    assert not res.changed and eng.node_of_stage == [1, 2]


@pytest.mark.parametrize("kill,incident,nodes,replicas", [
    ({"after_step": 2, "stage": 1, "replica": 10},
     ReplicaLost(1, 10, (2,), promoted=False), [1, 2], []),
    ({"after_step": 2, "stage": 1},
     ReplicaLost(1, 2, (10,), promoted=True), [1, 10], [])])
def test_replica_kill_is_zero_restore(granite, clean, tmp_path, kill,
                                      incident, nodes, replicas):
    """A copy with a survivor dies (the replica, or the primary, whose
    replica is promoted): no restore, no replay, no spare spent."""
    batch, want = clean
    eng = replicated_engine(granite, tmp_path)
    np.testing.assert_array_equal(eng.generate(batch, 6, kill=kill), want)
    m = msgs(eng)
    assert any("LOST" in x and "no restore" in x for x in m)
    assert not any("rescheduled" in x or "replayed" in x or "FAILED" in x
                   for x in m)
    assert not eng.down
    assert eng.incidents == [incident]
    assert eng.spares == [90, 91]
    assert eng.node_of_stage == nodes and eng.replica_nodes[1] == replicas


def test_last_copy_kill_falls_back_to_restore(granite, clean, tmp_path):
    batch, want = clean
    eng = replicated_engine(granite, tmp_path)
    toks = eng.generate(batch, 6, kill=[
        {"after_step": 1, "stage": 1, "replica": 10},   # zero restore
        {"after_step": 3, "stage": 1}])                 # last copy dies
    np.testing.assert_array_equal(toks, want)
    m = msgs(eng)
    assert any("LOST" in x for x in m)
    assert any("FAILED" in x for x in m)
    assert any("rescheduled" in x for x in m)
    assert any("replayed" in x for x in m)
    assert eng.node_of_stage[1] == 90 and not eng.down


def test_jsq_routing_spreads_evenly_and_deterministically(granite, clean,
                                                          tmp_path):
    eng = replicated_engine(granite, tmp_path)
    eng.generate(clean[0], 8)
    served = eng._served[1]
    assert set(served) == {2, 10}
    assert abs(served[2] - served[10]) <= 1     # least-served round-robin
    again = replicated_engine(granite, tmp_path)
    again.generate(clean[0], 8)
    assert again._served[1] == served           # deterministic routing
    assert eng._served[0] == {}                 # single copy: no counters


def test_migrate_onto_own_replica_is_promotion(granite, clean, tmp_path):
    batch, want = clean
    eng = replicated_engine(granite, tmp_path)
    assert eng.migrate_stage(1, 10) == 10
    assert eng.node_of_stage == [1, 10]
    assert eng.replica_nodes[1] == [2]          # vacated primary demoted
    assert eng.spares == [90, 91]               # no spare consumed
    assert any("PROMOTED" in x and "no checkpoint read" in x
               for x in msgs(eng))
    np.testing.assert_array_equal(eng.generate(batch, 6), want)


def test_add_replica_spends_spare(granite, clean, tmp_path):
    batch, want = clean
    eng = replicated_engine(granite, tmp_path, replicas=None)
    assert eng.add_replica(1) == 90 and eng.spares == [91]
    assert eng.replica_nodes[1] == [90]
    assert any("replica ADDED" in x for x in msgs(eng))
    # the new copy makes the next kill a zero-restore event
    toks = eng.generate(batch, 6, kill={"after_step": 2, "stage": 1})
    np.testing.assert_array_equal(toks, want)
    assert eng.incidents and eng.incidents[0].promoted
    with pytest.raises(ValueError):             # not a spare: a bug
        eng.add_replica(0, node=12345)


def test_current_plan_and_replan_carry_replicas(granite, tmp_path):
    eng = replicated_engine(granite, tmp_path)
    assert eng.current_plan().stages[1].replicas == (10,)
    eng.kill_replica(1)
    assert eng.current_plan().stages[1].replicas == ()
    assert eng.incidents == [ReplicaLost(1, 10, (2,), promoted=False)]
    with pytest.raises(ValueError, match="no replicas"):
        eng.kill_replica(1)


@pytest.mark.parametrize("bad", [{1: (2,)},         # another stage's node
                                 {1: (90,)},        # a spare
                                 {0: (10,), 1: (10,)}])   # the same twice
def test_replica_node_collisions_rejected(granite, tmp_path, bad):
    cfg, params = granite
    plan = from_block_cuts(cfg, [2], spare_nodes=(90,), replicas=bad)
    with pytest.raises(ValueError, match="replica node"):
        PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16,
                            ckpt_dir=tmp_path / "ckpt")


def test_replicas_match_reference_engine(granite, clean, tmp_path):
    """A replicated engine's routing, incidents, promotion and migration
    bookkeeping, step by step beside the reference engine's."""
    cfg, params = granite
    from repro.configs import get_config as jax_get_config
    from repro.core import from_block_cuts as jax_from_block_cuts
    from repro.models import init_params as jax_init_params
    jc = jax_get_config("granite-3-2b", "smoke").replace(n_layers=4)
    jeng = JaxPipelineServeEngine(
        jc, jax_init_params(jc, jax.random.PRNGKey(0)),
        jax_from_block_cuts(jc, [1, 3], spare_nodes=(90, 91),
                            replicas={1: (10,), 2: (11,)}),
        max_len=32, kv_block=16, ckpt_dir=tmp_path / "j", retry=FAST_RETRY)
    eng = PipelineServeEngine(
        cfg, params, from_block_cuts(cfg, [1, 3], spare_nodes=(90, 91),
                                     replicas={1: (10,), 2: (11,)}),
        max_len=32, kv_block=16, ckpt_dir=tmp_path / "p", retry=FAST_RETRY)
    batch = clean[0]
    jbatch = {"tokens": jax.numpy.asarray(batch["tokens"])}
    kill = [{"after_step": 1, "stage": 2}, {"after_step": 2, "stage": 1,
                                            "replica": 10},
            {"after_step": 4, "stage": 1}]
    for e, b in ((eng, batch), (jeng, jbatch)):
        e.generate(b, 6, kill=kill)
        e.migrate_stage(0)
        e.add_replica(0)
        e.migrate_stage(0, e.replica_nodes[0][0])
        e.generate(b, 4)
    assert bookkeeping(eng, []) == bookkeeping(jeng, [])


@pytest.mark.parametrize("replace", ["migrate", "kill"])
def test_replaced_stage_params_are_freed_at_once(granite, clean, tmp_path,
                                                 replace):
    """A restored stage's tensors go when the stage is replaced again,
    with no garbage collection: an engine that restores or migrates many
    times holds one copy of each stage (on the card, a second copy of a
    large stage does not fit)."""
    import gc
    import weakref
    from repro_torch._tree import tree_leaves
    eng = dense_engine(granite, tmp_path, spares=(90, 91))
    eng.generate(clean[0], 6, kill={"after_step": 2, "stage": 1})
    old = weakref.ref(tree_leaves(eng.stage_params[1])[0])
    gc.disable()
    try:
        if replace == "migrate":
            eng.migrate_stage(1)
        else:
            eng.kill_stage(1)
            eng.restore_stage(1)
        assert old() is None
    finally:
        gc.enable()
