"""Deterministic chaos campaign runner: a copy of the reference's
schedule generator and emulator half, with the serving half on the port's
``PipelineServeEngine``.

A campaign is a seeded, randomized schedule of faults replayed against
BOTH halves of the stack-under-contract:

* **serving** — each case attaches a fresh
  :class:`~repro_torch.serve.transport.BoundaryTransport` (wire faults
  drawn by :func:`~repro_torch.serve.transport.seeded_wire_faults`) and
  :class:`~repro_torch.serve.transport.HeartbeatMonitor` to one shared
  :class:`~repro_torch.serve.pipeline.PipelineServeEngine` and generates
  under the schedule (optionally with a silent or loud mid-stream stage
  kill), then checks the invariants: the greedy token stream is
  **bit-identical** to the fault-free baseline, the transport delivered
  every frame **exactly once** (no lost, no double-delivered request),
  silent-kill **detection latency is bounded** by ``dead_after_s +
  poll_s``, and a case that killed nothing performed **no restore** (a
  stalled wire must surface as suspicion, never a checkpoint read);
* **emulator** — the same case carries a composed emulator fault schedule
  (Bernoulli :class:`~repro_torch.emulator.faults.WireLoss` frame loss
  overlapped with :class:`~repro_torch.emulator.faults.LinkDegrade` drift
  and :class:`~repro_torch.emulator.faults.NodeFault` kills, all composing
  through the ``EffectLedger``), run through the reference
  ``PipelineEmulator`` and the fast ``FlatEventEngine``, checking
  **metrics identity** and that every batch completed (reschedule recovers
  lost work).

Every draw comes from ``np.random.default_rng([seed, _CHAOS_STREAM, i])``
and every clock is a :class:`~repro_torch.serve.transport.FakeWireClock`,
so a campaign is a pure function of its seed: a failing case reproduces
from ``(seed, cid)`` alone, and :func:`repro_torch.chaos.shrink.shrink_case`
reduces its schedule to a minimal failing repro.  The serving half runs
on the card by default (``device``) and on the CPU when asked.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

# decorrelates chaos-schedule draws from every other seeded stream
_CHAOS_STREAM = 0xC4A05

# serving topology every campaign runs on: 3 stages (cuts [1, 3] of a
# 4-layer smoke config), so 2 boundary hops
CUTS = (1, 3)
N_STAGES = len(CUTS) + 1
GEN_LEN = 8


@dataclass(frozen=True)
class ChaosCase:
    """One replayable unit: a wire-fault schedule + optional stage kill
    for the serving engine, and a composed fault schedule for the
    emulator pair.  ``wire`` holds ``[kind, hop, xfer, extra]`` specs
    (:func:`repro_torch.serve.transport.parse_wire_faults` encoding); ``emu``
    holds dicts with a ``kind`` of ``wire`` / ``degrade`` / ``kill``."""
    cid: str
    wire: tuple = ()
    kill: dict | None = None
    emu: tuple = ()


@dataclass
class CaseResult:
    cid: str
    failures: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


@dataclass
class CampaignReport:
    seed: int
    results: list

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def failing(self) -> list:
        return [r for r in self.results if not r.ok]

    def summary(self) -> str:
        lines = [f"chaos campaign seed={self.seed}: "
                 f"{len(self.results)} case(s), "
                 f"{len(self.failing)} failing"]
        for r in self.results:
            mark = "ok  " if r.ok else "FAIL"
            lines.append(f"  [{mark}] {r.cid}")
            for msg in r.failures:
                lines.append(f"         - {msg}")
        return "\n".join(lines)


def _draw_wire(rng) -> list:
    """One case's wire schedule, via the transport's own seeded
    generator (at most one fault per (hop, xfer), kinds uniform)."""
    from repro_torch.serve.transport import seeded_wire_faults
    sub = int(rng.integers(1 << 30))
    rate = 0.1 + 0.25 * float(rng.random())
    faults = seeded_wire_faults(sub, N_STAGES - 1, GEN_LEN, rate)
    out = []
    for f in faults:
        kind = type(f).__name__
        if kind == "CorruptPayload":
            out.append(("corrupt", f.hop, f.xfer, f.bit))
        elif kind == "Stall":
            out.append(("stall", f.hop, f.xfer, f.stall_s))
        else:
            out.append(({"Drop": "drop", "Duplicate": "dup",
                         "Reorder": "reorder"}[kind], f.hop, f.xfer))
    return out


def _draw_emu(rng) -> list:
    """One case's emulator schedule: always some Bernoulli frame loss on
    a boundary link, sometimes overlapped with bandwidth drift and/or a
    node kill (the EffectLedger composition surface)."""
    hop = int(rng.integers(N_STAGES - 1))
    out = [{"kind": "wire", "hop": hop,
            "t": 1.0 + 4.0 * float(rng.random()),
            "loss": 0.1 + 0.3 * float(rng.random()),
            "duration": (30.0 + 30.0 * float(rng.random())
                         if rng.random() < 0.5 else None),
            "seed": int(rng.integers(1 << 16))}]
    if rng.random() < 0.5:
        out.append({"kind": "degrade", "hop": int(rng.integers(N_STAGES - 1)),
                    "t": 5.0 + 10.0 * float(rng.random()),
                    "factor": 0.3 + 0.5 * float(rng.random()),
                    "duration": 10.0 + 20.0 * float(rng.random())})
    if rng.random() < 0.4:
        out.append({"kind": "kill", "stage": int(rng.integers(N_STAGES)),
                    "t": 10.0 + 20.0 * float(rng.random())})
    return out


def generate_campaign(seed: int, n_cases: int) -> list[ChaosCase]:
    """The seeded schedule generator: ``n_cases`` independent cases, each
    drawn from its own decorrelated substream so shrinking or re-running
    one case never perturbs the others."""
    cases = []
    for i in range(int(n_cases)):
        rng = np.random.default_rng([int(seed), _CHAOS_STREAM, i])
        wire = tuple(tuple(s) for s in _draw_wire(rng))
        kill = None
        if rng.random() < 0.4:
            kill = {"after_step": int(rng.integers(1, GEN_LEN - 1)),
                    "stage": int(rng.integers(N_STAGES)),
                    "silent": bool(rng.random() < 0.5)}
        emu = tuple(dict(d) for d in _draw_emu(rng))
        cases.append(ChaosCase(cid=f"case-{seed}-{i}", wire=wire,
                               kill=kill, emu=emu))
    return cases


# ---------------------------------------------------------------------------
# serving half
# ---------------------------------------------------------------------------

class ChaosHarness:
    """One shared serving engine + fault-free baseline, replaying chaos
    cases.  Checkpointing the stages dominates set-up, so the engine is
    built once; each case gets a fresh transport/monitor via
    ``attach_wire`` and the spare pool is topped up after kills (node ids
    are arbitrary labels, so minting new spares keeps the engine
    reusable for arbitrarily many cases and shrink probes).

    The topology is the reference's: 4 layers of ``arch`` (``preset``
    "smoke" by default; "full" keeps every width and cuts the depth to 4),
    stages at CUTS, spares 900-905, a batch of 2 x 12 tokens from
    ``seed``.  ``params`` (default: ``init_params`` from a generator
    seeded 0 on ``device``) and ``batch`` (default: ``make_batch(cfg, 2,
    12, seed)``) may be given, e.g. the reference's own, bridged;
    ``device`` defaults to the card and raises without one; ``ckpt_dir``
    holds the stage checkpoints (default: the engine's temp dir)."""

    def __init__(self, arch: str = "granite-3-2b", *, seed: int = 0,
                 overlap: bool = False, preset: str = "smoke", params=None,
                 batch=None, device=None, ckpt_dir=None):
        import torch

        from repro_torch._device import resolve_device
        from repro_torch.configs import get_config
        from repro_torch.core.stageplan import from_block_cuts
        from repro_torch.models import init_params
        from repro_torch.serve.engine import as_batch, make_batch
        from repro_torch.serve.pipeline import PipelineServeEngine

        dev = resolve_device(device)
        cfg = get_config(arch, preset)
        if cfg.n_layers != 4:
            cfg = cfg.replace(n_layers=4)
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            params = init_params(cfg, gen, device=dev)
        plan = from_block_cuts(cfg, list(CUTS),
                               spare_nodes=tuple(range(900, 906)))
        # overlap=True replays cases through the overlapped executor: 2
        # micro-batches in flight per decode step, same invariants — chaos
        # must not care how dispatch is ordered
        self.eng = PipelineServeEngine(cfg, params, plan, max_len=32,
                                       kv_block=16, overlap=overlap,
                                       micro_batches=2 if overlap else None,
                                       ckpt_dir=ckpt_dir)
        self.batch = as_batch(make_batch(cfg, 2, 12, seed) if batch is None
                              else batch, dev)
        self._next_spare = 910
        self.baseline = self.eng.generate(self.batch, GEN_LEN).tolist()

    def _refill_spares(self) -> None:
        while len(self.eng.spares) < 4:
            self.eng.spares.append(self._next_spare)
            self._next_spare += 1

    def run_case(self, case: ChaosCase) -> list[str]:
        """Replay one case; returns invariant-violation messages."""
        from repro_torch.serve.retry import RetryPolicy
        from repro_torch.serve.transport import (BoundaryTransport,
                                                 FakeWireClock,
                                                 HeartbeatMonitor,
                                                 parse_wire_faults)
        eng = self.eng
        clk = FakeWireClock()
        mon = HeartbeatMonitor(eng.n_stages, clock=clk, sleep=clk.sleep)
        tr = BoundaryTransport(eng.n_stages - 1,
                               faults=parse_wire_faults(case.wire),
                               policy=RetryPolicy(attempts=6,
                                                  base_delay_s=0.05),
                               monitor=mon, clock=clk, sleep=clk.sleep)
        eng.attach_wire(tr, mon)
        ev0 = len(eng.events)
        fails = []
        try:
            toks = eng.generate(self.batch, GEN_LEN,
                                kill=dict(case.kill) if case.kill else None)
        except Exception as e:  # an invariant, not an abort: report it
            fails.append(f"generate raised {type(e).__name__}: {e}")
            self._refill_spares()
            return fails
        if toks.tolist() != self.baseline:
            fails.append("greedy tokens diverged from fault-free baseline")
        if not tr.exactly_once():
            fails.append("transport lost or double-delivered a frame")
        events = [msg for _, msg in eng.events[ev0:]]
        restored = any("rescheduled" in msg for msg in events)
        if case.kill is None and restored:
            fails.append("restore performed with no kill injected "
                         "(wire trouble must only raise suspicion)")
        if case.kill is not None and not restored:
            fails.append("killed stage was never restored")
        if case.kill and case.kill.get("silent"):
            if not eng.detections:
                fails.append("silent kill was never confirmed dead")
            else:
                stage, latency = eng.detections[-1]
                bound = mon.dead_after_s + mon.poll_s
                if stage != case.kill["stage"] or latency > bound:
                    fails.append(
                        f"detection (stage {stage}, {latency:.3g}s) "
                        f"violates bound (stage {case.kill['stage']}, "
                        f"<= {bound:.3g}s)")
        self._refill_spares()
        return fails


# ---------------------------------------------------------------------------
# emulator half
# ---------------------------------------------------------------------------

def _emu_faults(specs):
    from repro_torch.emulator import LinkDegrade, NodeFault, WireLoss
    out = []
    for s in specs:
        if s["kind"] == "wire":
            a = s["hop"] + 1        # node of stage k is k + 1 (see below)
            out.append(WireLoss(s["t"], a, a + 1, s["loss"],
                                s.get("duration"), s.get("seed", 0)))
        elif s["kind"] == "degrade":
            a = s["hop"] + 1
            out.append(LinkDegrade(s["t"], a, a + 1, s["factor"],
                                   s.get("duration")))
        else:
            out.append(NodeFault(s["t"], s["stage"] + 1))
    return out


def run_emulator_case(case: ChaosCase, *, n_batches: int = 40) -> list[str]:
    """Replay one case's composed fault schedule through both emulator
    engines: dispatcher on node 0, stage k on node k + 1, spares beyond.
    Invariants: reference/fast metrics identity, and no lost batch."""
    from repro_torch.core.cluster import ClusterGraph
    from repro_torch.emulator import metrics_identical, simulate

    n = N_STAGES + 4
    bw = np.full((n, n), 1e6)
    np.fill_diagonal(bw, 0.0)
    cluster = ClusterGraph(bw=bw)
    nodes = list(range(N_STAGES + 1))
    boundary = [1e4] * N_STAGES
    flops = [1e9] * N_STAGES
    fails = []
    kw = dict(n_batches=n_batches, duration_s=1e6,
              faults=_emu_faults(case.emu), rng=0)
    ref = simulate(cluster, nodes, boundary, flops, engine="reference", **kw)
    fast = simulate(cluster, nodes, boundary, flops, engine="auto", **kw)
    if not metrics_identical(ref, fast):
        fails.append("emulator reference and fast engines disagree "
                     "under the composed fault schedule")
    if ref["completed"] != n_batches:
        fails.append(f"emulator lost work: {ref['completed']}/{n_batches} "
                     "batches completed")
    return fails


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def run_campaign(seed: int = 0, n_cases: int = 6, *, arch="granite-3-2b",
                 serve: bool = True, emulator: bool = True,
                 overlap: bool = False, log=None, preset: str = "smoke",
                 params=None, batch=None, device=None, ckpt_dir=None,
                 harness: ChaosHarness | None = None) -> CampaignReport:
    """Generate and replay one campaign; every failing case is reported
    with its violated invariants (shrink separately via
    :func:`repro_torch.chaos.shrink.shrink_case`).  ``overlap`` replays the
    serving half through the overlapped executor (micro-batches in
    flight) — the invariants are identical by contract.  ``preset``,
    ``params``, ``batch``, ``device`` and ``ckpt_dir`` go to the
    :class:`ChaosHarness`; a ``harness`` the caller built (to read its
    engine between cases, through ``log``) is used instead of one."""
    cases = generate_campaign(seed, n_cases)
    if not serve:
        harness = None
    elif harness is None:
        harness = ChaosHarness(arch, seed=seed, overlap=overlap,
                               preset=preset, params=params, batch=batch,
                               device=device, ckpt_dir=ckpt_dir)
    results = []
    for case in cases:
        res = CaseResult(case.cid)
        if harness is not None:
            res.failures += harness.run_case(case)
        if emulator:
            res.failures += run_emulator_case(case)
        if log is not None:
            log(f"{case.cid}: {'ok' if res.ok else 'FAIL'} "
                f"(wire={len(case.wire)}, kill={case.kill is not None}, "
                f"emu={len(case.emu)})")
        results.append(res)
    return CampaignReport(seed=seed, results=results)


def case_fails(harness: ChaosHarness | None, case: ChaosCase,
               *, emulator: bool = True) -> bool:
    """Predicate for :func:`repro_torch.chaos.shrink.shrink_case`: does this
    (possibly reduced) case still violate an invariant?"""
    fails = [] if harness is None else harness.run_case(case)
    if emulator and not fails:
        fails = run_emulator_case(case)
    return bool(fails)


def reduced(case: ChaosCase, atoms) -> ChaosCase:
    """Rebuild a case from a subset of its schedule atoms (the shrink
    search space: each wire fault, each emulator fault, and the kill are
    independently removable)."""
    wire = tuple(a[1] for a in atoms if a[0] == "wire")
    emu = tuple(a[1] for a in atoms if a[0] == "emu")
    kill = next((a[1] for a in atoms if a[0] == "kill"), None)
    return replace(case, wire=wire, emu=emu, kill=kill)


def atoms_of(case: ChaosCase) -> list:
    out = [("wire", s) for s in case.wire]
    if case.kill is not None:
        out.append(("kill", case.kill))
    out += [("emu", s) for s in case.emu]
    return out
