"""The port's chaos campaign held to the reference's on the CPU.

* the schedule generator (``generate_campaign``), ``ddmin`` and the
  emulator half are copies: the same cases for the same seeds, the same
  verdicts, and the copies of the reference's ``tests/test_chaos.py``
  tests of them;
* the serving half on the port's ``PipelineServeEngine``: a port harness
  built from the reference harness's own params (``init_params`` at
  ``PRNGKey(0)``, bridged by ``params_from_jax``) and batch, held against
  a ``repro.chaos.ChaosHarness`` in one module fixture — the same baseline
  tokens; for the ``--smoke`` campaign and one overlapped case the same
  verdicts, new event messages, detections, transport hop stats and wire
  events; the forced exhausting schedule shrunk to the same six drops;
  the silent-kill bound and the spare refill;
* ``python -m repro_torch.chaos --smoke --device cpu`` exits 0.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.chaos import ChaosHarness as JaxChaosHarness
from repro.chaos import campaign as ref_campaign
from repro.chaos import generate_campaign as ref_generate_campaign
from repro.chaos import shrink_case as ref_shrink_case
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve.equivalence import make_batch as jax_make_batch
from repro_torch.chaos import (ChaosCase, ChaosHarness, ddmin,
                               generate_campaign, shrink_case)
from repro_torch.chaos.campaign import (GEN_LEN, N_STAGES, atoms_of,
                                        case_fails, reduced,
                                        run_emulator_case)
from repro_torch.models.bridge import params_from_jax
from test_torch_planner import wall_time  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the schedule generator, ddmin and the emulator half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 8), (1, 5), (7, 5), (11, 20),
                                    (123, 3)])
def test_campaign_is_the_reference_s(seed, n):
    got = [dataclasses.asdict(c) for c in generate_campaign(seed, n)]
    want = [dataclasses.asdict(c) for c in ref_generate_campaign(seed, n)]
    assert got == want


@pytest.mark.parametrize("i", range(8))
def test_emulator_half_is_the_reference_s(i):
    case = generate_campaign(0, 8)[i]
    ref = ref_generate_campaign(0, 8)[i]
    assert run_emulator_case(case) == ref_campaign.run_emulator_case(ref)
    assert run_emulator_case(case) == []


class TestScheduleGeneration:
    def test_same_seed_same_campaign(self):
        assert generate_campaign(7, 5) == generate_campaign(7, 5)

    def test_different_seeds_differ(self):
        assert generate_campaign(1, 5) != generate_campaign(2, 5)

    def test_cases_are_independent_substreams(self):
        assert generate_campaign(3, 8)[:4] == generate_campaign(3, 4)

    def test_schedules_are_in_range(self):
        for case in generate_campaign(11, 20):
            for kind, hop, xfer, *rest in case.wire:
                assert kind in ("drop", "corrupt", "dup", "reorder", "stall")
                assert 0 <= hop < N_STAGES - 1
                assert 0 <= xfer < GEN_LEN
            if case.kill is not None:
                assert 0 <= case.kill["stage"] < N_STAGES
                assert 1 <= case.kill["after_step"] < GEN_LEN
            assert any(s["kind"] == "wire" for s in case.emu)


class TestDdmin:
    def test_reduces_to_single_culprit(self):
        assert ddmin(list(range(10)), lambda xs: 7 in xs) == [7]

    def test_keeps_interacting_pair(self):
        out = ddmin(list(range(8)), lambda xs: 2 in xs and 5 in xs)
        assert out == [2, 5]

    def test_schedule_independent_failure_reduces_to_empty(self):
        assert ddmin([1, 2, 3], lambda xs: True) == []

    def test_requires_failing_input(self):
        with pytest.raises(ValueError, match="failing input"):
            ddmin([1, 2], lambda xs: False)

    def test_atoms_round_trip_through_reduced(self):
        case = generate_campaign(5, 3)[0]
        assert reduced(case, atoms_of(case)) == case


class TestEmulatorHalf:
    def test_composed_schedule_holds_lockstep(self):
        case = generate_campaign(0, 1)[0]
        assert run_emulator_case(case) == []

    def test_kill_plus_wire_plus_degrade(self):
        case = ChaosCase(cid="manual", emu=(
            {"kind": "wire", "hop": 0, "t": 2.0, "loss": 0.3,
             "duration": None, "seed": 3},
            {"kind": "degrade", "hop": 0, "t": 5.0, "factor": 0.5,
             "duration": 20.0},
            {"kind": "kill", "stage": 1, "t": 10.0},
        ))
        assert run_emulator_case(case) == []


# ---------------------------------------------------------------------------
# the serving half against the reference's
# ---------------------------------------------------------------------------

def reference_inputs(seed=0):
    """The params and batch ``repro.chaos.ChaosHarness`` serves, built as
    it builds them, as numpy."""
    cfg = jax_get_config("granite-3-2b", "smoke").replace(n_layers=4)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    batch = jax_make_batch(cfg, 2, 12, seed)
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in batch.items()})


def harness_pair(overlap, tmp):
    params, batch = reference_inputs()
    jh = JaxChaosHarness(seed=0, overlap=overlap)
    ph = ChaosHarness(seed=0, overlap=overlap,
                      params=params_from_jax(params, "cpu"), batch=batch,
                      device="cpu", ckpt_dir=tmp)
    return jh, ph


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return harness_pair(False, tmp_path_factory.mktemp("chaos"))


@pytest.fixture(scope="module")
def overlapped(tmp_path_factory):
    return harness_pair(True, tmp_path_factory.mktemp("chaos-overlap"))


def to_reference(case):
    return ref_campaign.ChaosCase(**dataclasses.asdict(case))


def replay(h, case):
    """Run ``case`` on harness ``h``: its failures and the engine's and the
    transport's bookkeeping of it."""
    eng = h.eng
    ev0 = len(eng.events)
    fails = h.run_case(case)
    tr = eng.transport
    return {"failures": fails,
            "events": [m for _, m in eng.events[ev0:]],
            "detections": list(eng.detections),
            "hops": [dataclasses.asdict(s) for s in tr.stats],
            "wire_events": list(tr.events),
            "exactly_once": tr.exactly_once(),
            "nodes": list(eng.node_of_stage),
            "spares": list(eng.spares)}


def test_baseline_tokens_are_the_reference_s(pair):
    jh, ph = pair
    assert ph.baseline == jh.baseline
    assert np.asarray(ph.baseline).shape == (2, GEN_LEN)


@pytest.mark.parametrize("i", range(4))
def test_smoke_campaign_case_is_the_reference_s(pair, i):
    jh, ph = pair
    case = generate_campaign(0, 4)[i]
    want = replay(jh, to_reference(case))
    got = replay(ph, case)
    assert got == want
    assert got["failures"] == [] and got["exactly_once"]


def test_overlapped_case_is_the_reference_s(overlapped):
    jh, ph = overlapped
    assert ph.baseline == jh.baseline
    case = generate_campaign(0, 1)[0]
    want = replay(jh, to_reference(case))
    got = replay(ph, case)
    assert got == want
    assert got["failures"] == []
    # the case's wire observes the stages: the staged schedule served it
    assert ph.eng.micro_batches == 2 and not ph.eng._fused_ok()


def test_exhausting_schedule_shrinks_like_the_reference(pair):
    # 6 drops of one frame defeat the 6-attempt policy: the case fails
    # (WireExhausted), and ddmin strips the incidental faults
    jh, ph = pair
    bad = ChaosCase(cid="forced", wire=tuple([("drop", 0, 1)] * 6)
                    + (("dup", 1, 2), ("reorder", 0, 4)))
    fails = lambda c: case_fails(ph, c, emulator=False)  # noqa: E731
    assert fails(bad)
    assert ph.run_case(bad) == jh.run_case(to_reference(bad))
    small = shrink_case(bad, fails)
    assert small.kill is None and small.emu == ()
    assert list(small.wire) == [("drop", 0, 1)] * 6
    ref_small = ref_shrink_case(to_reference(bad), lambda c:
                                ref_campaign.case_fails(jh, c,
                                                        emulator=False))
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)


def test_silent_kill_detected_within_bound(pair):
    jh, ph = pair
    case = ChaosCase(cid="silent", kill={"after_step": 2, "stage": 1,
                                         "silent": True})
    got, want = replay(ph, case), replay(jh, to_reference(case))
    assert got == want
    assert got["failures"] == []
    stage, latency = ph.eng.detections[-1]
    assert stage == 1
    assert latency >= ph.eng.monitor.dead_after_s


def test_spare_pool_refills_between_cases(pair):
    jh, ph = pair
    before = len(ph.eng.spares)
    case = ChaosCase(cid="kill", kill={"after_step": 1, "stage": 0,
                                       "silent": False})
    got, want = replay(ph, case), replay(jh, to_reference(case))
    assert got == want
    assert got["failures"] == []
    assert len(ph.eng.spares) >= min(before, 4)


def test_harness_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChaosHarness()


def test_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.chaos", "--smoke", "--device",
         "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "chaos campaign seed=0: 4 case(s), 0 failing" in out.stdout
    assert "overlap chaos campaign seed=0: 1 case(s), 0 failing" in \
        out.stdout
