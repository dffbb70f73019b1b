"""Continuous batching across pipeline stages in the port, held against the
reference.

The eight ``pipeline-stream/`` cells of ``tests/data/serve_equivalence.json``
(granite ``cut2`` plain, with a stage kill, a live replan, a replica kill,
a faulty wire, a silent kill and the overlapped executor; mamba2 ``cut2``
with a stage kill) are served by the port's ``SlotScheduler`` over its
``PipelineServeEngine``, built as ``repro.serve.equivalence
.build_pipeline_engine`` builds the reference's
(``test_torch_faults.port_pipeline``).  Each cell:

1. every request's stream bit-identical to the port's own monolithic
   ``SlotScheduler`` stream of the same requests: stages, faults, replays
   and admission pacing reorder execution, never math;
2. held to the cell's pins (the reference's monolithic tokens of each
   request alone) under the gap contract of ``tests/test_torch_scheduler.py``:
   each request's teacher-forced logits within 3e-2 of the reference's,
   its tokens equal to the pin up to its first step whose reference
   top-1/top-2 gap is at most 2 x 3e-2, flips printed with their gap;
3. for a cell with a kill, a replan, a replica or a wire: the fault
   bookkeeping equal to the reference engine's run of the same cell
   (``test_torch_faults.bookkeeping``: nodes, spares, routing counts,
   incidents, detections, events, the transport's per-hop stats and
   events, the telemetry with its queue depths, the replan result).

Then the scheduler's API over a pipeline: a replica kill needs no
restore; whisper (its encoder on a block-free first stage) and the VLM
stream their side inputs through ``admit_slot``, token-identical to their
monolithic streams; an idle slot past ``max_len`` steps on in every
stage's bank, writing nowhere, as the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SlotScheduler as JaxSlotScheduler
from repro.serve.equivalence import _replan_arg as jax_replan_arg
from repro.serve.equivalence import _requests as jax_requests
from repro.serve.equivalence import build_pipeline_engine
from repro_torch.configs import get_config
from repro_torch.core import from_block_cuts
from repro_torch.models import init_params
from repro_torch.models.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler
from test_torch_encdec import ENCODER_STAGE, plan_of
from test_torch_faults import (bookkeeping, capture_replans, port_pipeline,
                               replan_arg)
from test_torch_pins import PINS, SCENARIOS
from test_torch_scheduler import jax_teacher_forced, port_teacher_forced

torch.set_num_threads(2)

TOL = 3e-2
GATES = ["pipeline-stream/granite-3-2b/cut2",
         "pipeline-stream/granite-3-2b/cut2-kill",
         "pipeline-stream/granite-3-2b/cut2-replan",
         "pipeline-stream/granite-3-2b/cut2-replica-kill",
         "pipeline-stream/granite-3-2b/cut2-wire",
         "pipeline-stream/granite-3-2b/cut2-wire-silentkill",
         "pipeline-stream/granite-3-2b/cut2-overlap",
         "pipeline-stream/mamba2-1.3b/cut2-kill"]


def faulted(sc) -> bool:
    return bool(sc.get("kill") or sc.get("replan") or sc.get("replicas")
                or sc.get("wire"))


@pytest.fixture(scope="module")
def models():
    """(arch -> the cells' model, requests, the port's monolithic streams
    and each request's pin evidence), each computed once: the cells of a
    model share its 4 layers, its weights and the requests (seed 1), so
    they share the pins."""
    memo = {}

    def get(cid):
        arch = cid.split("/")[1]
        if arch not in memo:
            sc = SCENARIOS[cid]
            jcfg = jax_get_config(arch, "smoke").replace(
                n_layers=sc["n_layers"])
            cfg = get_config(arch, "smoke").replace(n_layers=sc["n_layers"])
            with jax.threefry_partitionable(False):
                jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
                jreqs = jax_requests(jcfg, sc)
            params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
            reqs = [Request(r.rid, np.asarray(r.tokens), r.gen_len)
                    for r in jreqs]
            mono = ServeEngine(cfg, params, max_len=sc["max_len"],
                               kv_block=sc["kv_block"])
            streams, _ = SlotScheduler(mono, sc["slots"]).run(reqs)
            pins = PINS[cid]["tokens"]
            evidence = []
            for r, pin in zip(reqs, pins):
                pin = np.asarray(pin)
                batch = {"tokens": r.tokens}
                jl = jax_teacher_forced(jcfg, jp, batch, pin, sc["max_len"],
                                        jnp.bfloat16)
                evidence.append((jl, port_teacher_forced(mono, batch, pin)))
            memo[arch] = (jcfg, jp, cfg, params, jreqs, reqs, streams,
                          evidence, pins)
        # every stream cell of a model pins the same monolithic tokens
        assert PINS[cid]["tokens"] == memo[arch][-1]
        return memo[arch][:-1]

    return get


def hold_stream_to_pins(cid, cfg, reqs, streams, evidence):
    """The gap contract, request by request (both models' heads are
    tied)."""
    assert cfg.tie_embeddings
    for r, pin, got, (jl, tl) in zip(reqs, PINS[cid]["tokens"], streams,
                                     evidence):
        pin = np.asarray(pin)
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        for t in np.nonzero(tl.argmax(-1) != pin)[0]:
            print(f"{cid}: flip: request {r.rid} step {t} reference "
                  f"top-1/top-2 gap {gap[t]:.4g}")
            assert gap[t] <= 2 * TOL, (r.rid, t, gap[t])
        low = np.nonzero(gap <= 2 * TOL)[0]
        upto = low[0] if len(low) else r.gen_len
        np.testing.assert_array_equal(got[:upto], pin[:upto])


@pytest.mark.parametrize("cid", GATES)
def test_gate_cell(cid, models):
    sc = SCENARIOS[cid]
    jcfg, jp, cfg, params, jreqs, reqs, mono, evidence = models(cid)
    peng = port_pipeline(sc, cfg, params)
    port_replans = capture_replans(peng)
    streams, stats = SlotScheduler(peng, sc["slots"]).run(
        reqs, kill=sc.get("kill"), replan=replan_arg(sc, peng))
    assert stats["decode_steps"] > 0

    # 1. the monolithic stream, bit for bit
    for got, want in zip(streams, mono):
        np.testing.assert_array_equal(got, want)

    # 2. the pins, under the gap contract
    hold_stream_to_pins(cid, cfg, reqs, streams, evidence)

    msgs = [m for _, m in peng.events]
    if sc.get("overlap"):
        assert peng.admit_burst() == 2
    if not faulted(sc):
        assert not msgs
        return

    # 3. the reference engine's bookkeeping of the same cell
    jeng = build_pipeline_engine(sc, JaxServeEngine(
        jcfg, jp, max_len=sc["max_len"], kv_block=sc["kv_block"]))
    jax_replans = capture_replans(jeng)
    JaxSlotScheduler(jeng, sc["slots"]).run(
        jreqs, engine="fast", kill=sc.get("kill"),
        replan=jax_replan_arg(sc, jeng))
    want, have = bookkeeping(jeng, jax_replans), bookkeeping(peng,
                                                             port_replans)
    for key in want:
        assert have[key] == want[key], key
    # what the cell exercises really happened
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
        assert any("after migrating stage(s)" in m for m in msgs)
    if sc.get("replicas"):
        assert have["incidents"]
    elif sc.get("kill") and "silent" not in cid:
        assert any("after restoring stage(s) [1]" in m for m in msgs)


# ---------------------------------------------------------------------------
# the scheduler's API over a pipeline (the port's own weights)
# ---------------------------------------------------------------------------

def granite(n_layers=4):
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=n_layers)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device="cpu")


def requests(cfg, shapes, seed=0, **side):
    reqs = []
    for i, (plen, glen) in enumerate(shapes):
        one = make_batch(cfg, 1, plen, seed * 100 + i, **side)
        reqs.append(Request(i, one.pop("tokens"), glen, extras=one))
    return reqs


def test_scheduler_replica_kill_needs_no_restore(tmp_path):
    """A stream through a replicated stage whose replica dies mid-stream:
    the survivor absorbs it (no checkpoint read, no replay) and the
    streams are the undisturbed run's (the reference's
    ``test_scheduler_replica_kill_needs_no_restore``)."""
    cfg, params = granite()
    reqs = requests(cfg, [(8, 6), (8, 5), (8, 4)])

    def engine(sub):
        return PipelineServeEngine(
            cfg, params, from_block_cuts(cfg, [2], spare_nodes=(90, 91),
                                         replicas={1: (10,)}),
            max_len=32, kv_block=16, ckpt_dir=tmp_path / sub)
    clean, _ = SlotScheduler(engine("a"), 2).run(reqs)
    eng = engine("b")
    streams, _ = SlotScheduler(eng, 2).run(
        reqs, kill=[{"after_step": 2, "stage": 1, "replica": 10}])
    for a, b in zip(clean, streams):
        np.testing.assert_array_equal(a, b)
    msgs = [m for _, m in eng.events]
    assert any("LOST" in m for m in msgs)
    assert not any("rescheduled" in m or "replayed" in m for m in msgs)
    assert not eng.down


@pytest.mark.parametrize("arch,n_layers,cuts,kill", [
    ("whisper-large-v3", 4, ENCODER_STAGE, {"after_step": 2, "stage": 2}),
    ("whisper-large-v3", 4, [2], None),
    ("llama-3.2-vision-90b", 10, [5], {"after_step": 3, "stage": 1})])
def test_side_input_stream_through_the_stages(arch, n_layers, cuts, kill):
    """Each request's own frames or vision embeddings reach every stage
    through ``admit_slot`` (whisper's encoder on a block-free first stage
    ships its output to the later stages) and through a replay after a
    kill: the streams equal the monolithic stream's."""
    cfg = get_config(arch, "smoke").replace(n_layers=n_layers)
    params = init_params(cfg, device="cpu")
    shapes = ([(8, g) for g in (6, 4, 7, 5)] if cfg.family == "encdec"
              else [(8, 6), (8, 4), (12, 7), (8, 5)])
    reqs = requests(cfg, shapes, seed=3, frames_len=8)
    mono, _ = SlotScheduler(ServeEngine(cfg, params, max_len=32,
                                        kv_block=16), 2).run(reqs)
    eng = PipelineServeEngine(cfg, params, plan_of(cfg, cuts, 0),
                              max_len=32, kv_block=16)
    streams, _ = SlotScheduler(eng, 2).run(reqs, kill=kill)
    for a, b in zip(mono, streams):
        np.testing.assert_array_equal(a, b)
    if kill:
        assert any("after restoring stage(s)" in m for _, m in eng.events)


def test_idle_slot_past_max_len_steps_on_in_every_stage():
    """Slot 0 frees after one step and idles while slot 1 decodes 27
    more: its lengths grow to 36, past max_len 32, in every stage's bank,
    its writes past the cache land nowhere (its rows are what they were
    when its length reached 32), and the streams equal the monolithic
    ones."""
    cfg, params = granite()
    reqs = requests(cfg, [(8, 2), (4, 29)], seed=5)
    mono, _ = SlotScheduler(ServeEngine(cfg, params, max_len=32,
                                        kv_block=16), 2).run(reqs)
    eng = PipelineServeEngine(cfg, params, from_block_cuts(cfg, [1, 3]),
                              max_len=32, kv_block=16)
    seen, step = {}, eng.bank_step

    def recorded(slot_tokens, caches, bucket, inflight):
        out = step(slot_tokens, caches, bucket, inflight)
        seen["banks"] = caches
        if int(caches[0]["len"][0, 0]) == 32:
            seen["at_max"] = [c["k"][:, 0].clone() for c in caches]
        return out

    eng.bank_step = recorded
    streams, stats = SlotScheduler(eng, 2).run(reqs)
    assert stats["decode_steps"] == 28
    for a, b in zip(mono, streams):
        np.testing.assert_array_equal(a, b)
    for bank, rows in zip(seen["banks"], seen["at_max"]):
        assert (bank["len"][:, 0] == 36).all()
        assert torch.equal(bank["k"][:, 0], rows)