"""Bounded incremental replanning: warm-start from the current plan.

A copy of ``repro/core/replan.py`` with only its imports changed:
bit-identical plans are the planner copies' contract.

The full planner (Algorithm 1 partitioning + Algorithm 2/3 k-path
placement) is built for cold starts and is deliberately rng-pinned
(``tests/data/planner_equivalence.json``); re-running it on every
telemetry update would re-enter the k > 12 greedy fallback from scratch
and could emit an arbitrarily different plan whose migration cost dwarfs
the drift it reacts to.  :func:`incremental_replan` instead *warm-starts*
from the current :class:`~repro_torch.core.stageplan.StageExecutionPlan`:

* the partition (Algorithm 1's layer -> stage assignment) is reused
  verbatim — stage boundaries, ``in_bytes`` and ``compute_flops`` never
  change;
* the placement is repaired by a deterministic greedy local search that
  moves stages onto spare nodes, **bounded to at most ``max_moves``
  moves** — the ≤ m-stage diff bound that keeps live-migration cost
  proportional to the drift, not to the fleet.

Each candidate move is scored with the emulator's steady-state stage cost
(transfer-in + compute, the reciprocal-throughput bottleneck the paper
minimizes) under the *measured* cluster state — typically a
``repro_torch.serve.telemetry.ClusterState`` estimate or the emulator's
``effective_cluster`` oracle.  Moves are accepted only while they
strictly lower the bottleneck by more than ``min_gain_s``, so the search
cannot oscillate and always terminates within ``max_moves`` rounds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from .stageplan import StageExecutionPlan

# matches repro.emulator.pipeline.EmulatorConfig.node_flops — the serving
# fleet's per-node FLOP rate used to turn stage FLOPs into seconds
DEFAULT_NODE_FLOPS = 20e9

_INF = float("inf")


@dataclass(frozen=True)
class StageMove:
    """One placement diff: stage ``stage`` moves old_node -> new_node.

    When ``new_node`` is one of the stage's own warm replicas the move is
    a *promotion* (role swap, no checkpoint read, no state transfer); the
    vacated primary becomes the replica."""
    stage: int
    old_node: int
    new_node: int


@dataclass(frozen=True)
class ReplicaAdd:
    """One capacity diff: spend spare ``node`` as a warm replica of stage
    ``stage`` instead of migrating anything."""
    stage: int
    node: int


@dataclass(frozen=True)
class ReplanResult:
    plan: StageExecutionPlan
    moves: tuple[StageMove | ReplicaAdd, ...]
    bottleneck_before_s: float
    bottleneck_after_s: float

    @property
    def changed(self) -> bool:
        return bool(self.moves)

    @property
    def migrated_stages(self) -> tuple[int, ...]:
        """Stages whose primary actually moved (replica additions are
        capacity-only and need no cache replay)."""
        return tuple(mv.stage for mv in self.moves
                     if isinstance(mv, StageMove))


def _stage_cost(in_bytes: float, flops: float, bw: float, scale: float,
                node_flops: float) -> float:
    """Steady-state service time of one stage: transfer-in + compute."""
    if in_bytes == 0.0:
        transfer = 0.0
    elif bw > 0.0:
        transfer = in_bytes / bw
    else:
        transfer = _INF
    if flops == 0.0:
        compute = 0.0
    elif scale > 0.0:
        compute = flops / node_flops / scale
    else:
        compute = _INF
    return transfer + compute


def stage_costs(plan: StageExecutionPlan, cluster, *,
                node_flops: float = DEFAULT_NODE_FLOPS) -> list[float]:
    """Per-stage service time of ``plan`` under ``cluster`` (index k =
    stage k; the dispatcher contributes only the first hop's transfer).
    Primary copies only — see :func:`effective_stage_costs` for the
    replica-aware service time."""
    nodes = plan.nodes
    return [_stage_cost(s.in_bytes, s.compute_flops,
                        float(cluster.bw[nodes[k], s.node]),
                        float(cluster.compute_scale[s.node]), node_flops)
            for k, s in enumerate(plan.stages)]


def _parallel_cost(costs: list[float]) -> float:
    """Effective service time of replicated copies served in parallel
    (combined rate = sum of per-copy rates).  A single copy returns its
    cost unchanged — 1/(1/x) is not an IEEE identity, so the R=1 path
    must not round-trip through rates."""
    if len(costs) == 1:
        return costs[0]
    rate = 0.0
    for c in costs:
        if c == 0.0:
            return 0.0
        if c < _INF:
            rate += 1.0 / c
    return 1.0 / rate if rate > 0.0 else _INF


def effective_stage_costs(plan: StageExecutionPlan, cluster, *,
                          node_flops: float = DEFAULT_NODE_FLOPS
                          ) -> list[float]:
    """Replica-aware per-stage service time: copies of a replicated stage
    drain its queue in parallel, so the effective cost is the parallel
    combination of each copy's transfer-in + compute.  Identical to
    :func:`stage_costs` for unreplicated plans."""
    nodes = plan.nodes
    bw, scale = cluster.bw, cluster.compute_scale
    out = []
    for k, s in enumerate(plan.stages):
        per_copy = [_stage_cost(s.in_bytes, s.compute_flops,
                                float(bw[nodes[k], h]), float(scale[h]),
                                node_flops)
                    for h in s.all_nodes]
        out.append(_parallel_cost(per_copy))
    return out


def incremental_replan(plan: StageExecutionPlan, cluster, *,
                       max_moves: int = 2, min_gain_s: float = 0.0,
                       node_flops: float = DEFAULT_NODE_FLOPS,
                       allow_replicas: bool = False) -> ReplanResult:
    """Repair ``plan``'s placement under a drifted ``cluster`` estimate.

    Deterministic bounded local search: each round evaluates every
    candidate diff, commits the one that most lowers the bottleneck
    effective stage cost (first minimum wins on ties), and repeats for at
    most ``max_moves`` rounds or until no diff improves the bottleneck by
    more than ``min_gain_s``.  Candidates per round, in tie-break order:

    * promotion of stage k onto one of its own warm replicas (preferred
      migration target: a role swap costs no checkpoint read and no
      state transfer — the vacated primary becomes the replica);
    * migration of stage k onto a spare node (the vacated node returns
      to the spare pool);
    * with ``allow_replicas=True``, spending a spare as an extra warm
      replica of stage k instead of migrating anything
      (:class:`ReplicaAdd`) — the trade a replan can now make.

    The returned plan preserves the partition exactly; only
    ``StageSpec.node`` / ``StageSpec.replicas`` and ``spare_nodes``
    differ."""
    n = plan.n_stages
    nodes = [s.node for s in plan.stages]
    reps = [list(s.replicas) for s in plan.stages]
    spares = list(plan.spare_nodes)
    inb = [s.in_bytes for s in plan.stages]
    fl = [s.compute_flops for s in plan.stages]
    bw = cluster.bw
    scale = cluster.compute_scale

    def cost(k: int, host: int, prev: int) -> float:
        return _stage_cost(inb[k], fl[k], float(bw[prev, host]),
                           float(scale[host]), node_flops)

    def eff(k: int, host: int, reps_k: list[int], prev: int) -> float:
        if not reps_k:
            return cost(k, host, prev)
        return _parallel_cost([cost(k, host, prev)]
                              + [cost(k, r, prev) for r in reps_k])

    def costs(ns: list[int], rs: list[list[int]]) -> list[float]:
        prevs = [plan.dispatcher_node] + ns[:-1]
        return [eff(k, ns[k], rs[k], prevs[k]) for k in range(n)]

    def taken(sp: int) -> bool:
        return (sp in nodes or sp == plan.dispatcher_node
                or any(sp in r for r in reps))

    before = max(costs(nodes, reps), default=0.0)
    cur_max = before
    moves: list[StageMove | ReplicaAdd] = []
    for _ in range(max_moves):
        best = None                    # (new_max, kind, k, target)
        for k in range(n):
            for r in reps[k]:          # promotion swap: preferred target
                cand_r = [list(x) for x in reps]
                cand_r[k] = [nodes[k] if x == r else x for x in reps[k]]
                cand_n = nodes.copy()
                cand_n[k] = r
                new_max = max(costs(cand_n, cand_r))
                if best is None or new_max < best[0]:
                    best = (new_max, "swap", k, r)
            for sp in spares:
                if taken(sp):
                    continue
                cand = nodes.copy()
                cand[k] = sp
                new_max = max(costs(cand, reps))
                if best is None or new_max < best[0]:
                    best = (new_max, "move", k, sp)
        if allow_replicas:
            for k in range(n):
                for sp in spares:
                    if taken(sp):
                        continue
                    cand_r = [list(x) for x in reps]
                    cand_r[k] = reps[k] + [sp]
                    new_max = max(costs(nodes, cand_r))
                    if best is None or new_max < best[0]:
                        best = (new_max, "add", k, sp)
        if best is None or not cur_max > best[0] + min_gain_s:
            break
        new_max, kind, k, tgt = best
        if kind == "move":
            moves.append(StageMove(k, nodes[k], tgt))
            spares.remove(tgt)
            spares.append(nodes[k])
            nodes[k] = tgt
        elif kind == "swap":
            moves.append(StageMove(k, nodes[k], tgt))
            reps[k] = [nodes[k] if x == tgt else x for x in reps[k]]
            nodes[k] = tgt
        else:
            moves.append(ReplicaAdd(k, tgt))
            spares.remove(tgt)
            reps[k] = reps[k] + [tgt]
        cur_max = new_max

    if not moves:
        return ReplanResult(plan, (), before, before)
    stages = [dataclasses.replace(s, node=nodes[k], replicas=tuple(reps[k]))
              for k, s in enumerate(plan.stages)]
    new_plan = dataclasses.replace(plan, stages=stages,
                                   spare_nodes=tuple(spares))
    return ReplanResult(new_plan, tuple(moves), before, cur_max)
