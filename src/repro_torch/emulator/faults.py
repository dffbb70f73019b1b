"""Fault injection schedules (the ChaosMesh analogue).

Three layers:

* declarative fault records (:class:`NodeFault` / :class:`LinkFault` /
  :class:`LinkDegrade` / :class:`NodeSlowdown`) — consumed either by
  :class:`FaultInjector` (reference engine, imperative scheduling) or
  passed directly to ``engine.simulate(faults=...)`` (fast flat event
  engine, which replicates the injector's scheduling order);
* Monte-Carlo fault *models* (:class:`RandomNodeFaults` /
  :class:`RandomLinkFaults` / :class:`DriftingCluster`) — draw a
  deterministic fault schedule per sweep seed, for multi-seed
  fault-tolerance curves (``repro_torch.emulator.sweep``);
* schedule composition (:func:`compose_faults` /
  :class:`CompositeFaultModel`) — merge several schedules or models into
  one time-ordered schedule.

Overlapping effects on one link (or node) are multiplicative and tracked
by :class:`EffectLedger`: the pristine value is captured once, every
active effect contributes a factor, and the effective value is recomputed
as ``pristine * f1 * f2 * ...`` in application order on every change.
Both engines use the same ledger class so the float-multiplication order
— and therefore every derived metric — is identical (the emulator
metrics-identity contract).  This also fixes the latent overlap bug where
the second of two overlapping :class:`LinkFault` drops saved the
already-zeroed bandwidth and restored the link to 0.0 forever.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .pipeline import PipelineEmulator

# keeps each fault model's draw stream independent of the arrival stream,
# which seeds the generator with the bare cell seed
_FAULT_STREAM = 0xFA017


@dataclass
class NodeFault:
    time_s: float
    node: int
    recover_after_s: float | None = None     # None = permanent


@dataclass
class LinkFault:
    """Temporarily zero the bandwidth of one link (network fault)."""
    time_s: float
    a: int
    b: int
    duration_s: float


@dataclass
class LinkDegrade:
    """Multiply one link's bandwidth by ``factor`` (gradual drift).

    ``duration_s=None`` is permanent; overlapping degrades compose
    multiplicatively via :class:`EffectLedger`."""
    time_s: float
    a: int
    b: int
    factor: float
    duration_s: float | None = None


@dataclass
class NodeSlowdown:
    """Multiply one node's ``compute_scale`` by ``factor`` (thermal
    throttling, co-tenant pressure).  In-flight computes keep the service
    time they started with; work started after the change pays the new
    rate — in both engines."""
    time_s: float
    node: int
    factor: float
    duration_s: float | None = None


@dataclass
class WireLoss:
    """Unreliable wire on one link: while active, each boundary transfer
    attempted over ``(a, b)`` is independently lost with probability
    ``loss_rate`` (Bernoulli, per-link rng seeded by ``(seed, a, b)`` so
    both engines draw the identical sequence).  A lost frame still
    occupies the link for the full transfer duration, then the sender's
    reconnect loop retransmits after ``retry_s`` — the emulator-side
    price of the serving transport's ack/retransmit protocol.

    ``duration_s=None`` is permanent.  ``loss_rate`` must sit in
    ``[0, 1)``: a rate of 1 never delivers and livelocks the pipeline."""
    time_s: float
    a: int
    b: int
    loss_rate: float
    duration_s: float | None = None
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.loss_rate < 1.0:
            raise ValueError(
                f"WireLoss.loss_rate must be in [0, 1) (a rate of 1 never "
                f"delivers), got {self.loss_rate}")


class _WireRec:
    """Active wire-loss state on one link: the shared Bernoulli stream
    both engines consume in attempt order."""

    __slots__ = ("rng", "loss_rate")

    def __init__(self, fault: WireLoss):
        self.rng = np.random.default_rng(
            [int(fault.seed), _FAULT_STREAM, int(fault.a), int(fault.b)])
        self.loss_rate = float(fault.loss_rate)

    def lost(self) -> bool:
        return float(self.rng.random()) < self.loss_rate


class EffectLedger:
    """Pristine value + stack of active multiplicative effects per key.

    ``push``/``pop`` return the new effective value ``pristine * f1 * f2
    * ...``, multiplied in surviving-push order so the reference and fast
    engines execute the identical float-op sequence.  The pristine value
    is captured on the first push of a key and the key is forgotten after
    the last pop, so a fully-recovered link restores to its exact original
    bandwidth no matter how many effects overlapped (the per-link
    saved-value refcount that fixes the overlapping-LinkFault bug)."""

    def __init__(self):
        self._state: dict = {}    # key -> [pristine, [(eid, factor), ...]]

    def push(self, key, pristine, eid, factor) -> float:
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = [pristine, []]
        st[1].append((eid, factor))
        return self._effective(st)

    def pop(self, key, eid) -> float:
        st = self._state[key]
        st[1] = [e for e in st[1] if e[0] != eid]
        eff = self._effective(st)
        if not st[1]:
            del self._state[key]
        return eff

    @staticmethod
    def _effective(st) -> float:
        v = st[0]
        for _, f in st[1]:
            v = v * f
        return v


def link_key(a: int, b: int) -> tuple[int, int]:
    """Canonical (undirected) ledger key for a link."""
    return (a, b) if a <= b else (b, a)


@dataclass(frozen=True)
class RandomNodeFaults:
    """Kill ``n_faults`` distinct pipeline nodes at uniform times in
    ``window_s``; optionally recover each after ``recover_after_s``.

    ``draw(seed, nodes)`` is deterministic per seed and independent of the
    cell's arrival stream."""
    n_faults: int = 1
    window_s: tuple[float, float] = (5.0, 60.0)
    recover_after_s: float | None = None
    include_dispatcher: bool = False

    def draw(self, seed: int, nodes) -> list[NodeFault]:
        rng = np.random.default_rng([int(seed), _FAULT_STREAM])
        cand = list(nodes) if self.include_dispatcher else list(nodes[1:])
        k = min(self.n_faults, len(cand))
        picks = rng.choice(len(cand), size=k, replace=False)
        times = np.sort(rng.uniform(self.window_s[0], self.window_s[1],
                                    size=k))
        return [NodeFault(float(t), int(cand[i]), self.recover_after_s)
                for t, i in zip(times, picks)]


@dataclass(frozen=True)
class RandomLinkFaults:
    """Drop ``n_faults`` pipeline hops (stage k -> k+1 links) at uniform
    times in ``window_s`` for ``duration_s`` each."""
    n_faults: int = 1
    window_s: tuple[float, float] = (5.0, 60.0)
    duration_s: float = 10.0

    def draw(self, seed: int, nodes) -> list[LinkFault]:
        rng = np.random.default_rng([int(seed), _FAULT_STREAM, 1])
        n_hops = len(nodes) - 1
        k = min(self.n_faults, n_hops)
        picks = rng.choice(n_hops, size=k, replace=False)
        times = np.sort(rng.uniform(self.window_s[0], self.window_s[1],
                                    size=k))
        return [LinkFault(float(t), int(nodes[i]), int(nodes[i + 1]),
                          self.duration_s)
                for t, i in zip(times, picks)]


@dataclass(frozen=True)
class DriftingCluster:
    """Gradual cluster drift: staged per-hop bandwidth decay (with optional
    lognormal jitter), node slowdowns, and flapping links — the chaos model
    behind the static-vs-replan sweep (``sweep.compare_replan``).

    Decay is emitted as ``decay_steps`` *layered* permanent
    :class:`LinkDegrade` records per drifting hop: after step ``i`` the
    hop runs at ``decay_factor**i`` (jittered) of pristine.  Flaps are
    repeated short :class:`LinkFault` drops on a hop.  ``draw(seed,
    nodes)`` is deterministic per seed and independent of the arrival
    stream; ``stream`` decorrelates multiple models composed in a
    :class:`CompositeFaultModel`."""
    decay_hops: int = 1
    decay_factor: float = 0.8
    decay_every_s: float = 8.0
    decay_steps: int = 4
    jitter: float = 0.0                      # lognormal sigma per decay step
    slow_nodes: int = 0
    slowdown_factor: float = 0.5
    flap_hops: int = 0
    flap_period_s: float = 6.0
    flap_down_s: float = 1.5
    flap_count: int = 3
    start_s: float = 5.0
    stream: int = 2

    def draw(self, seed: int, nodes) -> list:
        rng = np.random.default_rng([int(seed), _FAULT_STREAM,
                                     int(self.stream)])
        n_hops = len(nodes) - 1
        out: list = []
        hops = rng.choice(n_hops, size=min(self.decay_hops, n_hops),
                          replace=False)
        for h in hops:
            a, b = int(nodes[h]), int(nodes[h + 1])
            t = self.start_s + float(rng.uniform(0.0, self.decay_every_s))
            for _ in range(self.decay_steps):
                f = self.decay_factor
                if self.jitter:
                    f = min(1.0, f * float(np.exp(
                        self.jitter * rng.standard_normal())))
                out.append(LinkDegrade(t, a, b, float(f), None))
                t += self.decay_every_s
        workers = list(nodes[1:])
        k = min(self.slow_nodes, len(workers))
        if k:
            picks = rng.choice(len(workers), size=k, replace=False)
            times = rng.uniform(self.start_s,
                                self.start_s + self.decay_every_s
                                * self.decay_steps, size=k)
            for t, i in zip(times, picks):
                out.append(NodeSlowdown(float(t), int(workers[i]),
                                        self.slowdown_factor, None))
        kf = min(self.flap_hops, n_hops)
        if kf:
            picks = rng.choice(n_hops, size=kf, replace=False)
            for i in picks:
                a, b = int(nodes[i]), int(nodes[i + 1])
                t0 = self.start_s + float(rng.uniform(0.0,
                                                      self.flap_period_s))
                for j in range(self.flap_count):
                    out.append(LinkFault(t0 + j * self.flap_period_s,
                                         a, b, self.flap_down_s))
        return sorted(out, key=lambda f: f.time_s)


def compose_faults(*schedules) -> list:
    """Merge fault schedules into one, stably ordered by fire time."""
    merged: list = []
    for s in schedules:
        merged.extend(s)
    return sorted(merged, key=lambda f: f.time_s)


@dataclass(frozen=True)
class CompositeFaultModel:
    """Compose several fault models; ``draw`` merges their schedules.

    Give each child a distinct ``stream`` (where supported) so their rng
    streams stay independent."""
    models: tuple

    def draw(self, seed: int, nodes) -> list:
        return compose_faults(*(m.draw(seed, nodes) for m in self.models))


def effective_cluster(cluster, faults, t: float):
    """The cluster as a perfect telemetry oracle would report it at ``t``.

    Replays the schedule's bandwidth/compute effects (and node deaths: a
    down node's links and compute_scale go to 0.0) up to time ``t`` and
    returns a fresh ``ClusterGraph`` — the input the static-vs-replan
    sweep feeds to ``repro_torch.core.replan.incremental_replan``."""
    from repro_torch.core.cluster import ClusterGraph
    bw = cluster.bw.copy()
    scale = np.asarray(cluster.compute_scale, dtype=np.float64).copy()
    links, nodes_led = EffectLedger(), EffectLedger()
    ev = []                                   # (time, order, kind, fault)
    for fi, f in enumerate(faults):
        if isinstance(f, NodeFault):
            ev.append((f.time_s, fi, "kill", f))
            if f.recover_after_s is not None:
                ev.append((f.time_s + f.recover_after_s, fi, "revive", f))
        elif isinstance(f, (LinkFault, LinkDegrade, NodeSlowdown, WireLoss)):
            ev.append((f.time_s, fi, "push", f))
            if f.duration_s is not None:
                ev.append((f.time_s + f.duration_s, fi, "pop", f))
        else:
            raise TypeError(f)
    down: set[int] = set()
    for time_s, fi, kind, f in sorted(ev, key=lambda e: (e[0], e[1])):
        if time_s > t:
            break
        if kind == "kill":
            down.add(f.node)
        elif kind == "revive":
            down.discard(f.node)
        elif isinstance(f, NodeSlowdown):
            if kind == "push":
                eff = nodes_led.push(f.node, float(scale[f.node]), fi,
                                     f.factor)
            else:
                eff = nodes_led.pop(f.node, fi)
            scale[f.node] = eff
        else:
            # a lossy wire's expected goodput is bw * (1 - loss_rate)
            factor = (0.0 if isinstance(f, LinkFault)
                      else 1.0 - f.loss_rate if isinstance(f, WireLoss)
                      else f.factor)
            key = link_key(f.a, f.b)
            if kind == "push":
                eff = links.push(key, float(bw[f.a, f.b]), fi, factor)
            else:
                eff = links.pop(key, fi)
            bw[f.a, f.b] = bw[f.b, f.a] = eff
    for nd in sorted(down):
        bw[nd, :] = bw[:, nd] = 0.0
        scale[nd] = 0.0
    return ClusterGraph(bw=bw, pos=cluster.pos, labels=cluster.labels,
                        compute_scale=scale)


class FaultInjector:
    def __init__(self, emu: PipelineEmulator):
        self.emu = emu
        self._links = EffectLedger()
        self._nodes = EffectLedger()

    # -- shared link push/pop so overlapping effects compose ----------------
    def _set_link(self, a: int, b: int, eff: float) -> None:
        bw = self.emu.cluster.bw
        bw[a, b] = bw[b, a] = eff

    def _push_link(self, f, factor: float) -> None:
        eff = self._links.push(link_key(f.a, f.b),
                               float(self.emu.cluster.bw[f.a, f.b]),
                               id(f), factor)
        self._set_link(f.a, f.b, eff)

    def _pop_link(self, f) -> None:
        self._set_link(f.a, f.b, self._links.pop(link_key(f.a, f.b), id(f)))

    def _set_scale(self, node: int, eff: float) -> None:
        emu = self.emu
        emu.cluster.compute_scale[node] = eff
        for st in emu.stages:
            for rep in st.replicas:
                if rep.node == node:
                    rep.compute_s = emu._compute_s(st.flops, rep.node)

    def schedule(self, faults) -> None:
        for f in faults:
            if isinstance(f, NodeFault):
                self.emu.sim.at(f.time_s,
                                lambda f=f: self.emu.kill_node(f.node))
                if f.recover_after_s is not None:
                    self.emu.sim.at(f.time_s + f.recover_after_s,
                                    lambda f=f: self.emu.revive_node(f.node))
            elif isinstance(f, LinkFault):
                def drop(f=f):
                    self._push_link(f, 0.0)
                    self.emu.sim.note(f"link ({f.a},{f.b}) DOWN")

                    def restore():
                        self._pop_link(f)
                        self.emu.sim.note(f"link ({f.a},{f.b}) restored")
                    self.emu.sim.after(f.duration_s, restore)

                self.emu.sim.at(f.time_s, drop)
            elif isinstance(f, LinkDegrade):
                def degrade(f=f):
                    self._push_link(f, f.factor)
                    self.emu.sim.note(
                        f"link ({f.a},{f.b}) degraded x{f.factor:g}")
                    if f.duration_s is None:
                        return

                    def clear():
                        self._pop_link(f)
                        self.emu.sim.note(f"link ({f.a},{f.b}) drift cleared")
                    self.emu.sim.after(f.duration_s, clear)

                self.emu.sim.at(f.time_s, degrade)
            elif isinstance(f, NodeSlowdown):
                def slow(f=f):
                    eff = self._nodes.push(
                        f.node,
                        float(self.emu.cluster.compute_scale[f.node]),
                        id(f), f.factor)
                    self._set_scale(f.node, eff)
                    self.emu.sim.note(f"node {f.node} slowdown x{f.factor:g}")
                    if f.duration_s is None:
                        return

                    def clear():
                        self._set_scale(f.node,
                                        self._nodes.pop(f.node, id(f)))
                        self.emu.sim.note(f"node {f.node} slowdown cleared")
                    self.emu.sim.after(f.duration_s, clear)

                self.emu.sim.at(f.time_s, slow)
            elif isinstance(f, WireLoss):
                def wire_on(f=f):
                    self.emu.wire[link_key(f.a, f.b)] = _WireRec(f)
                    self.emu.sim.note(
                        f"wire ({f.a},{f.b}) loss x{f.loss_rate:g} ON")
                    if f.duration_s is None:
                        return

                    def clear():
                        self.emu.wire.pop(link_key(f.a, f.b), None)
                        self.emu.sim.note(
                            f"wire ({f.a},{f.b}) loss cleared")
                    self.emu.sim.after(f.duration_s, clear)

                self.emu.sim.at(f.time_s, wire_on)
            else:
                raise TypeError(f)
