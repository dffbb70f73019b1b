"""Cluster inference-pipeline emulator (paper §6.2 / Table 4, in software).

Models the SEIFER runtime: a dispatcher node feeds batches into a chain of
inference pods placed on cluster nodes; each hop is a token-bucket-limited
link (the ChaosMesh TC-TBF analogue); each pod computes, then forwards the
compressed intermediate activation.  Compute and IO overlap (the paper's
separate inference/IO containers), so steady-state throughput is
1 / max_k max(compute_k, transfer_k) — Equation (1) — and the paper's
communication-dominated regime reduces it to Eq. (2).

Reliability model (paper §4.4): every hop is ack'd; the sender holds each
batch until the receiver acks, so node/link failures never lose data — the
sender reconnects (with retry backoff) and resends, exactly like the
paper's TCP-reconnect loops.  Node failures evict the pod; after a
detection + reschedule delay (Kubernetes analogue) the partition restarts
on a healthy spare node and the upstream neighbour reconnects.  In-flight
work is tracked by the node it *started* on (``_node_epoch``): compute or
transfers that were running on a node when it died are lost and replayed,
even if the pod has already been rescheduled to a healthy replacement by
the time the stale event fires.  Nodes that recover after their pod moved
elsewhere rejoin the spare pool.

Straggler mitigation (beyond paper): when a node's observed
service time exceeds ``straggler_factor`` x the fleet median, the runtime
migrates its partition to the fastest spare node.

This class is the *reference engine*: a readable closure-based event loop.
``repro_torch.emulator.engine`` implements the fast path (vectorized calendar +
flat event loop) and must stay metrics-identical — see the emulator
equivalence contract (``repro_torch.emulator.equivalence``).  Any
semantic change here MUST be mirrored in engine.py; the pinned fixture is
the reference emulator's.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.core.cluster import ClusterGraph
from .core import Simulator


@dataclass
class EmulatorConfig:
    node_flops: float = 20e9          # RPi-class: ~20 GFLOP/s effective
    detection_s: float = 2.0          # failure detection (heartbeat timeout)
    reschedule_s: float = 8.0         # pod restart on a new node
    retry_s: float = 0.5              # TCP reconnect retry interval
    ack_bytes: float = 64.0
    straggler_factor: float = 3.0
    straggler_check_s: float = 20.0
    enable_straggler_migration: bool = False


def summarize(times, e2e, events) -> dict:
    """Metrics from completion times and end-to-end latencies, both in
    completion order.  Shared by the reference and fast engines so they
    execute the identical float-op sequence (the emulator equivalence
    contract pins the outputs hex-exact).

    Span pairs the last completion with the earliest *submission among
    completed batches* (``(times - e2e).min()``), which stays correct when
    fault requeues complete batches out of submission order; the tail-rate
    estimator falls back to completions/span whenever the last-half window
    has fewer than two distinct completion instants."""
    times = np.asarray(times, dtype=np.float64)
    e2e = np.asarray(e2e, dtype=np.float64)
    n = len(times)
    if n == 0:
        return {"completed": 0, "throughput_hz": 0.0,
                "mean_e2e_s": float("inf"), "p95_e2e_s": float("inf"),
                "p99_e2e_s": float("inf"), "events": list(events)}
    span = times.max() - (times - e2e).min()
    # steady-state throughput: inter-completion rate over the last half
    tail = times[n // 2:]
    if len(tail) >= 2 and tail[-1] > tail[0]:
        thr = (len(tail) - 1) / (tail[-1] - tail[0])
    else:
        thr = n / max(span, 1e-9)
    return {"completed": n,
            "throughput_hz": float(thr),
            "mean_e2e_s": float(e2e.mean()),
            "p95_e2e_s": float(np.quantile(e2e, 0.95)),
            "p99_e2e_s": float(np.quantile(e2e, 0.99)),
            "events": list(events)}


def metrics_identical(a: dict, b: dict) -> bool:
    """The equivalence-contract predicate: two emulator runs produced the
    same metrics (exact float equality, not approximate).  The single
    definition shared by benchmarks and tests — extend it here when
    ``summarize`` grows a field."""
    return (a["completed"] == b["completed"]
            and a["throughput_hz"] == b["throughput_hz"]
            and a["mean_e2e_s"] == b["mean_e2e_s"]
            and a["p95_e2e_s"] == b["p95_e2e_s"]
            and a["p99_e2e_s"] == b["p99_e2e_s"])


class _Replica:
    """One pod: a copy of a partition hosted on a (replaceable) node."""

    __slots__ = ("node", "compute_s", "busy", "sending", "outbox", "inbox",
                 "unacked", "compute_token", "service_times", "inflight")

    def __init__(self, node, compute_s):
        self.node = node
        self.compute_s = compute_s       # seconds per batch on current node
        self.busy = False
        self.sending = False             # the link carries one batch at a time
        self.outbox = deque()
        self.inbox = deque()
        self.unacked = None              # batch held until ack (reliability)
        self.compute_token = 0           # bumped per compute start (races)
        self.service_times: list[float] = []
        self.inflight = 0                # transfers in the air toward this pod

    def queue_depth(self) -> int:
        return len(self.inbox) + (1 if self.busy else 0) + self.inflight


class _Stage:
    """One partition: one or more replica pods sharing its queue work.

    Slot 0 is the primary; extra slots are warm replicas placed by the
    planner's ``replicate_bottlenecks`` pass.  The legacy single-copy
    attributes (``node``, ``compute_s``, ``service_times``) proxy to the
    primary so existing callers and tests keep working."""

    def __init__(self, idx, node, flops, compute_s, out_bytes):
        self.idx = idx
        self.flops = flops               # nominal forward FLOPs (0=dispatcher)
        self.out_bytes = out_bytes       # compressed boundary bytes (0=last)
        self.replicas: list[_Replica] = [_Replica(node, compute_s)]

    @property
    def node(self) -> int:
        return self.replicas[0].node

    @property
    def compute_s(self) -> float:
        return self.replicas[0].compute_s

    @compute_s.setter
    def compute_s(self, v: float) -> None:
        self.replicas[0].compute_s = v

    @property
    def service_times(self) -> list[float]:
        return self.replicas[0].service_times


class PipelineEmulator:
    """Emulates one SEIFER plan on a cluster; measures throughput/E2E."""

    def __init__(self, cluster: ClusterGraph, nodes: list[int],
                 boundary_bytes: list[float], compute_flops: list[float],
                 cfg: EmulatorConfig | None = None,
                 rng: np.random.Generator | int = 0,
                 replicas: list[list[int]] | None = None):
        """nodes: dispatcher + one node per partition (len = parts + 1).
        boundary_bytes[k]: bytes sent from stage k to k+1 (k=0 dispatcher).
        compute_flops[k]: forward FLOPs of partition k.
        replicas[k]: warm-replica node ids for partition k (len = parts;
        the dispatcher is never replicated)."""
        self.cluster = cluster
        self.cfg = cfg or EmulatorConfig()
        self.rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
        self.sim = Simulator()
        self.down: set[int] = set()
        # link_key -> active WireLoss state (set by FaultInjector)
        self.wire: dict = {}
        n_parts = len(boundary_bytes)
        replicas = replicas or [[] for _ in range(n_parts)]
        rep_nodes = [n for r in replicas for n in r]
        if set(rep_nodes) & set(nodes) or len(rep_nodes) != len(set(rep_nodes)):
            raise ValueError(f"replica nodes {rep_nodes} collide with plan "
                             f"nodes {list(nodes)}")
        self.spares = [n for n in range(cluster.n)
                       if n not in nodes and n not in rep_nodes]
        # per-node death counter: in-flight work checks the epoch of the node
        # it started on, so a kill is detected even after the pod rescheduled
        self._node_epoch = [0] * cluster.n
        # stage 0 = dispatcher (no compute), stages 1..n = partitions
        self.stages: list[_Stage] = []
        for k in range(n_parts + 1):
            flops = 0.0 if k == 0 else compute_flops[k - 1]
            outb = boundary_bytes[k] if k < n_parts else 0.0
            st = _Stage(k, nodes[k], flops,
                        self._compute_s(flops, nodes[k]), outb)
            if k > 0:
                for rn in replicas[k - 1]:
                    st.replicas.append(_Replica(rn, self._compute_s(flops, rn)))
            self.stages.append(st)
        self.completed: list[tuple[float, float]] = []   # (t_done, e2e)
        self._next_id = 0

    # -- helpers ------------------------------------------------------------
    def _compute_s(self, flops, node) -> float:
        if flops == 0.0:
            return 0.0
        return flops / self.cfg.node_flops / self.cluster.compute_scale[node]

    def _bw(self, a: int, b: int) -> float:
        if a in self.down or b in self.down:
            return 0.0
        return self.cluster.bw[a, b]

    def _wire_rec(self, a: int, b: int):
        """Active unreliable-wire state on the (undirected) link, if any."""
        from .faults import link_key
        return self.wire.get(link_key(a, b))

    def _release(self, node: int) -> None:
        """Return a healthy node that hosts no stage to the spare pool (a
        recovered, already-replaced node is capacity again)."""
        if (node not in self.down and node not in self.spares
                and all(r.node != node
                        for s in self.stages for r in s.replicas)):
            self.spares.append(node)

    def _pick_replica(self, st: _Stage) -> _Replica:
        """Join-shortest-queue: the up replica with the fewest batches
        queued/computing/in the air; first minimum wins (list order), so
        routing is deterministic.  All replicas down -> the primary slot
        (its retry/reschedule machinery owns the stall)."""
        ups = [r for r in st.replicas if r.node not in self.down]
        cand = ups or st.replicas
        return min(cand, key=lambda r: (r.queue_depth(), st.replicas.index(r)))

    # -- batch flow ---------------------------------------------------------
    def submit(self, t_arrival: float) -> None:
        bid = self._next_id
        self._next_id += 1
        self.sim.at(t_arrival,
                    lambda: self._enqueue(0, {"id": bid, "t0": t_arrival}))

    def _enqueue(self, k: int, batch) -> None:
        st = self.stages[k]
        rep = self._pick_replica(st)
        rep.inbox.append(batch)
        self._try_start(k, rep)

    def _try_start(self, k: int, rep: _Replica | None = None) -> None:
        st = self.stages[k]
        rep = st.replicas[0] if rep is None else rep
        if rep.busy or not rep.inbox or rep.node in self.down:
            return
        rep.busy = True
        rep.compute_token += 1
        token = rep.compute_token
        node0 = rep.node
        epoch0 = self._node_epoch[node0]
        batch = rep.inbox.popleft()
        t0 = self.sim.now

        def done():
            # ``current`` is False when a reschedule cleared ``busy`` and a
            # newer compute started meanwhile: this result must not touch
            # the busy flag or restart the pod.
            current = token == rep.compute_token
            if current:
                rep.busy = False
            if self._node_epoch[node0] != epoch0:
                # host died after this compute started: the work is lost
                if rep in st.replicas:
                    # sole copy (its slot survives the kill): replay it
                    # wherever the pod lives now
                    rep.inbox.appendleft(batch)
                    if current:
                        self._try_start(k, rep)
                else:
                    # the slot was dissolved (warm survivors absorbed the
                    # stage): re-route this batch to them, zero restore
                    self._enqueue(k, batch)
                return
            if current and k > 0:
                rep.service_times.append(self.sim.now - t0)
            if st.idx == len(self.stages) - 1:
                self.completed.append((self.sim.now,
                                       self.sim.now - batch["t0"]))
            else:
                self._send(k, rep, batch)
            if current:
                self._try_start(k, rep)

        self.sim.after(rep.compute_s, done)

    def _send(self, k: int, rep: _Replica, batch) -> None:
        rep.outbox.append(batch)
        self._pump_send(k, rep)

    def _pump_send(self, k: int, rep: _Replica) -> None:
        if rep.sending or not rep.outbox:
            return
        rep.sending = True
        rep.unacked = rep.outbox.popleft()
        self._attempt_send(k, rep, rep.unacked)

    def _attempt_send(self, k: int, rep: _Replica, batch) -> None:
        st = self.stages[k]
        if rep not in st.replicas:
            # sender slot dissolved while a retry was pending: its unacked
            # batch was already re-routed at kill time
            return
        nxt = self.stages[k + 1]
        rep2 = self._pick_replica(nxt)         # route at send time (JSQ)
        src, dst = rep.node, rep2.node
        bw = self._bw(src, dst)
        if bw <= 0:                            # link/node down: retry loop
            self.sim.after(self.cfg.retry_s,
                           lambda: self._attempt_send(k, rep, batch))
            return
        dur = st.out_bytes / bw
        wrec = self._wire_rec(src, dst)
        if wrec is not None and wrec.lost():
            # frame lost on the unreliable wire: it still occupied the
            # link for the transfer duration, then the sender's reconnect
            # loop retransmits (the ack never arrived)
            self.sim.note(f"wire ({src},{dst}) frame LOST — retransmit")
            self.sim.after(dur + self.cfg.retry_s,
                           lambda: self._attempt_send(k, rep, batch))
            return
        e_src = self._node_epoch[src]
        e_dst = self._node_epoch[dst]
        rep2.inflight += 1

        def delivered():
            rep2.inflight -= 1
            if rep not in st.replicas:
                # sender slot dissolved mid-transfer: the batch was
                # re-routed from its unacked buffer at kill time
                return
            # the transfer ran between ``src`` and ``dst`` as they were at
            # attempt time: it is void if either endpoint died meanwhile or
            # either pod migrated off its endpoint (ack never arrives) —
            # the reconnect loop then resends to wherever the stage is now.
            if (self._node_epoch[src] != e_src
                    or self._node_epoch[dst] != e_dst
                    or rep.node != src or rep2 not in nxt.replicas
                    or rep2.node != dst):
                self.sim.after(self.cfg.retry_s,
                               lambda: self._attempt_send(k, rep, batch))
                return
            rep.unacked = None                 # ack received
            rep.sending = False
            rep2.inbox.append(batch)
            self._try_start(k + 1, rep2)
            self._pump_send(k, rep)

        self.sim.after(dur, delivered)

    # -- faults --------------------------------------------------------------
    def kill_node(self, node: int) -> None:
        self.down.add(node)
        self._node_epoch[node] += 1
        if node in self.spares:                # a dead spare must not be picked
            self.spares.remove(node)
        self.sim.note(f"node {node} FAILED")
        for st in self.stages:
            for rep in [r for r in st.replicas if r.node == node]:
                survivors = [r for r in st.replicas
                             if r is not rep and r.node not in self.down]
                if survivors:
                    # warm-spare failover: dissolve the slot and hand its
                    # queued work to the survivors immediately — capacity
                    # degrades, the stage never stalls, no restore fires
                    st.replicas.remove(rep)
                    self.sim.note(
                        f"stage {st.idx}: replica on node {node} LOST "
                        f"({len(survivors)} survivor(s), no restore)")
                    moved = ([rep.unacked] if rep.unacked is not None else [])
                    moved += list(rep.outbox) + list(rep.inbox)
                    for batch in moved:
                        self._enqueue(st.idx, batch)
                else:
                    # last copy: the checkpoint-restore path (detection +
                    # reschedule delay) is the only way back
                    self.sim.after(
                        self.cfg.detection_s + self.cfg.reschedule_s,
                        lambda st=st, rep=rep: self._reschedule(st, rep))

    def revive_node(self, node: int) -> None:
        self.down.discard(node)
        self.sim.note(f"node {node} recovered")
        hosted = [(st, r) for st in self.stages
                  for r in st.replicas if r.node == node]
        if hosted:
            for st, r in hosted:               # resume stalled pods in place
                self._try_start(st.idx, r)
        else:
            self._release(node)                # replaced: back to the pool

    def _reschedule(self, st: _Stage, rep: _Replica | None = None,
                    straggler: bool = False) -> None:
        rep = st.replicas[0] if rep is None else rep
        if not straggler and rep.node not in self.down:
            # the node recovered before the restart landed: keep the pod
            self.sim.note(f"stage {st.idx}: node {rep.node} recovered before "
                          f"reschedule; pod kept in place")
            self._try_start(st.idx, rep)
            return
        if not self.spares:
            self.sim.note(f"stage {st.idx}: NO SPARE NODE — pipeline stalled")
            return
        # best spare by bandwidth to neighbours (placement re-run, restricted)
        def score(n):
            s = 0.0
            if st.idx > 0:
                s += self.cluster.bw[self.stages[st.idx - 1].node, n]
            if st.idx < len(self.stages) - 1:
                s += self.cluster.bw[n, self.stages[st.idx + 1].node]
            return s
        best = max(self.spares, key=score)
        self.spares.remove(best)
        old = rep.node
        rep.node = best
        rep.compute_s = self._compute_s(st.flops, best)
        rep.service_times.clear()              # stats belong to the new pod
        rep.busy = False
        self.sim.note(f"stage {st.idx}: pod rescheduled {old} -> {best}")
        self._release(old)                     # straggler swap frees the old node
        self._try_start(st.idx, rep)
        # the upstream sender's retry loop (TCP reconnect) is already
        # polling; it will resend its unacked batch to the new node.

    # -- straggler mitigation --------------------------------------------------
    def _straggler_sweep(self) -> None:
        pods = [(st, r) for st in self.stages[1:] for r in st.replicas]
        med = np.median([np.mean(r.service_times[-5:]) for _, r in pods
                         if r.service_times]) if any(
            r.service_times for _, r in pods) else None
        if med:
            for st, r in pods:
                if (r.service_times and self.spares
                        and np.mean(r.service_times[-5:])
                        > self.cfg.straggler_factor * med):
                    self.sim.note(f"stage {st.idx}: straggler on node "
                                  f"{r.node}, migrating")
                    self._reschedule(st, r, straggler=True)
        if len(self.completed) < self._next_id:     # stop when drained
            self.sim.after(self.cfg.straggler_check_s, self._straggler_sweep)

    # -- the run loop -----------------------------------------------------
    def run(self, n_batches: int, duration_s: float,
            arrival_rate_hz: float | None = None):
        """Feed n_batches (all at t=0 if no rate, else Poisson) and run."""
        if self.cfg.enable_straggler_migration:
            self.sim.after(self.cfg.straggler_check_s, self._straggler_sweep)
        t = 0.0
        for i in range(n_batches):
            self.submit(t)
            if arrival_rate_hz:
                t += float(self.rng.exponential(1.0 / arrival_rate_hz))
        self.sim.run(until=duration_s)
        return self.metrics()

    def metrics(self) -> dict:
        return summarize(np.array([t for t, _ in self.completed]),
                         np.array([l for _, l in self.completed]),
                         self.sim.log)


def plan_stage_args(plan) -> tuple[list[int], list[float], list[float]]:
    """Adapt any plan dialect to the emulator's (nodes, boundary_bytes,
    compute_flops) triple.

    Accepts the stage-execution IR (``repro_torch.core.stageplan``, the preferred
    form), a ``SeiferPlan`` (adapted through the IR, byte-identical
    numbers), or — deprecated — the raw 3-tuple itself."""
    if hasattr(plan, "emulator_args"):          # StageExecutionPlan
        return plan.emulator_args()
    if hasattr(plan, "placement"):              # SeiferPlan
        return plan.execution_plan().emulator_args()
    import warnings
    warnings.warn(
        "passing a raw (nodes, boundary_sizes, compute_flops) tuple to the "
        "emulator is deprecated; build a StageExecutionPlan "
        "(repro_torch.core.stageplan) instead", DeprecationWarning, stacklevel=3)
    nodes, boundary, flops = plan
    return list(nodes), list(boundary), list(flops)


def plan_replicas(plan) -> list[list[int]]:
    """Per-partition warm-replica node lists from any plan dialect (empty
    lists when the plan carries none — raw tuples and SeiferPlans are
    always single-copy)."""
    if hasattr(plan, "replica_nodes"):          # StageExecutionPlan
        return [list(r) for r in plan.replica_nodes]
    if hasattr(plan, "placement"):              # SeiferPlan
        return [[] for _ in range(plan.partition.n_partitions)]
    _, boundary, _ = plan
    return [[] for _ in boundary]


def emulate_plan(plan, cluster: ClusterGraph, cfg: EmulatorConfig | None = None,
                 n_batches: int = 50, duration_s: float = 10_000.0,
                 rng=0, engine: str = "auto") -> dict:
    """Run a plan through the emulator.

    ``plan`` is a ``StageExecutionPlan`` (the IR — the same object
    ``PipelineServeEngine`` serves through), a ``SeiferPlan``, or the
    deprecated raw ``(nodes, boundary_sizes, compute_flops)`` tuple.
    Replicated IR stages (``StageSpec.replicas``) are emulated with
    warm-spare failover and JSQ routing in both engines.
    ``engine="auto"`` (default) picks the fast path (metrics-identical to the
    reference — see the equivalence contract); ``engine="reference"`` forces
    the closure-based reference loop."""
    nodes, boundary, flops = plan_stage_args(plan)
    replicas = plan_replicas(plan)
    if engine == "reference":
        return PipelineEmulator(cluster, nodes, boundary, flops, cfg, rng,
                                replicas=replicas).run(n_batches, duration_s)
    from .engine import simulate
    return simulate(cluster, nodes, boundary, flops, cfg,
                    n_batches=n_batches, duration_s=duration_s,
                    rng=rng, engine=engine, replicas=replicas)
