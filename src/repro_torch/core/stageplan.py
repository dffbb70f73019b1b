"""The single stage-execution IR shared by planner, emulator, and runtime.

Historically four plan dialects accreted: ``core.api.SeiferPlan`` (planner
output), ``core.pipeline.StagePlan`` (LM stage assignment), the emulator's
raw ``(nodes, boundary_sizes, compute_flops)`` tuple, and ``launch/pp.py``'s
implicit uniform stage split.  :class:`StageExecutionPlan` unifies them:
one object that says, per stage, *which layers*, *on which node*, *how many
bytes arrive*, and *how the boundary is compressed on the wire* — and that
every consumer (``repro.emulator.emulate_plan``, ``repro.emulator.sweep``,
``repro.serve.pipeline.PipelineServeEngine``, ``launch/pp.make_pp_forward``)
accepts directly.

Adapters:

* :func:`from_seifer` — SeiferPlan -> IR (layer names from the partition,
  node ids from the placement, bytes/FLOPs verbatim, so the emulator sees
  *exactly* the numbers it always did: the round-trip is pinned against the
  emulator-equivalence fixture).
* :func:`from_block_cuts` — build an IR for an LM directly from block cut
  indices (no cluster required); the serving tests' first/middle/last-cut
  grids use this.
* ``SeiferPlan.execution_plan()`` / ``StagePlan.execution_plan()`` — the
  emitting side (see ``core.api`` / ``core.pipeline``).

See ROADMAP.md "Deployment contract" for the lockstep obligations.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .bottleneck import DEFAULT_COMPRESSION

_BLOCK_RE = re.compile(r"^block(\d+)$")


@dataclass(frozen=True)
class BoundarySpec:
    """How boundary activations are treated on the wire.

    lam       -- the *analytic* compression factor the planner divided
                 transfer sizes by (Eq. 4's lambda).
    wire_bits -- the runtime wire format: 0 = raw activation dtype,
                 8 = rowwise int8 (the quantize kernel's scheme; the TPU
                 lambda executed for real).  Quantized boundaries are lossy,
                 so token-identity pins only apply to wire_bits=0 plans.
    """

    lam: float = DEFAULT_COMPRESSION
    wire_bits: int = 0


@dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a contiguous run of planner layers on one node."""

    index: int
    layers: tuple[str, ...]      # planner layer names owned by this stage
    node: int                    # placement node id hosting the stage
    in_bytes: float = 0.0        # compressed bytes arriving at this stage
    memory_bytes: float = 0.0    # omega of the stage (params + work)
    compute_flops: float = 0.0   # forward FLOPs (emulator compute model)
    replicas: tuple[int, ...] = ()  # warm-spare replica node ids (primary
    #                                 excluded; () = unreplicated stage)

    @property
    def all_nodes(self) -> tuple[int, ...]:
        """Primary node followed by replica nodes."""
        return (self.node,) + self.replicas

    def block_range(self) -> tuple[int, int]:
        """(lo, hi) model-block index range owned by this stage (hi
        exclusive); (i, i) when the stage holds no transformer blocks
        (embed-only first stage / head-only last stage)."""
        ids = sorted(int(m.group(1)) for m in
                     (_BLOCK_RE.match(n) for n in self.layers) if m)
        if not ids:
            return (-1, -1)
        if ids != list(range(ids[0], ids[-1] + 1)):
            raise ValueError(
                f"stage {self.index}: non-contiguous blocks {ids}")
        return (ids[0], ids[-1] + 1)


@dataclass
class StageExecutionPlan:
    """Per-stage layer ranges + placement + boundary spec: the one plan
    object planner, emulator, and runtime agree on."""

    stages: list[StageSpec]
    dispatcher_node: int = 0
    compression: BoundarySpec = field(default_factory=BoundarySpec)
    spare_nodes: tuple[int, ...] = ()
    arch: str | None = None

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def nodes(self) -> list[int]:
        """Dispatcher + one node per stage (the emulator's node list)."""
        return [self.dispatcher_node] + [s.node for s in self.stages]

    @property
    def boundary_bytes(self) -> list[float]:
        """Compressed bytes per hop, dispatcher edge first (len n_stages)."""
        return [s.in_bytes for s in self.stages]

    @property
    def compute_flops(self) -> list[float]:
        return [s.compute_flops for s in self.stages]

    @property
    def replica_nodes(self) -> list[tuple[int, ...]]:
        """Replica node ids per stage (primaries excluded; () when the
        stage is unreplicated)."""
        return [s.replicas for s in self.stages]

    @property
    def replication_factors(self) -> list[int]:
        """Copies per stage (1 = single-copy)."""
        return [1 + len(s.replicas) for s in self.stages]

    def emulator_args(self) -> tuple[list[int], list[float], list[float]]:
        """The emulator's (nodes, boundary_bytes, compute_flops) triple —
        byte-exact what ``SeiferPlan`` used to feed it (pinned by the
        round-trip test against the emulator-equivalence fixture)."""
        return self.nodes, self.boundary_bytes, self.compute_flops

    def block_ranges(self, n_layers: int | None = None
                     ) -> list[tuple[int, int]]:
        """Model-block index ranges per stage, validated to tile
        ``[0, n_layers)`` contiguously (stages may be block-free at either
        end: embed-only / head-only)."""
        out = []
        nxt = 0
        for s in self.stages:
            lo, hi = s.block_range()
            if lo < 0:
                out.append((nxt, nxt))
                continue
            if lo != nxt:
                raise ValueError(
                    f"stage {s.index}: blocks start at {lo}, expected {nxt}")
            out.append((lo, hi))
            nxt = hi
        if n_layers is not None and nxt != n_layers:
            raise ValueError(
                f"plan covers blocks [0, {nxt}), model has {n_layers}")
        return out

    def describe(self) -> str:
        lines = [f"StageExecutionPlan: {self.n_stages} stages "
                 f"(dispatcher node {self.dispatcher_node}, "
                 f"lam={self.compression.lam:g}, "
                 f"wire={'int' + str(self.compression.wire_bits) if self.compression.wire_bits else 'raw'})"]
        for s in self.stages:
            rep = f" +replicas {list(s.replicas)}" if s.replicas else ""
            lines.append(
                f"  stage {s.index}: {len(s.layers)} layers -> node {s.node} "
                f"(in {s.in_bytes / 1e6:.2f}MB, mem {s.memory_bytes / 1e6:.1f}MB, "
                f"{s.compute_flops / 1e9:.2f} GFLOP){rep}")
        if self.spare_nodes:
            lines.append(f"  spares: {list(self.spare_nodes)}")
        return "\n".join(lines)


def from_seifer(plan, cluster=None, *, wire_bits: int = 0,
                arch: str | None = None) -> StageExecutionPlan:
    """SeiferPlan -> IR.  Bytes, FLOPs, and node ids are carried over
    verbatim so emulator metrics are unchanged; ``cluster`` (optional)
    contributes the spare-node pool exactly as the emulator derives it."""
    part, place = plan.partition, plan.placement
    nodes = list(place.nodes)
    spares = tuple(n for n in range(cluster.n) if n not in nodes) \
        if cluster is not None else ()
    stages = [
        StageSpec(index=r, layers=tuple(part.partition_layers[r]),
                  node=nodes[r + 1], in_bytes=float(part.boundary_sizes[r]),
                  memory_bytes=float(part.memory_bytes[r]),
                  compute_flops=float(part.compute_flops[r]))
        for r in range(part.n_partitions)
    ]
    return StageExecutionPlan(
        stages=stages, dispatcher_node=nodes[0],
        compression=BoundarySpec(lam=getattr(part, "lam", DEFAULT_COMPRESSION),
                                 wire_bits=wire_bits),
        spare_nodes=spares, arch=arch)


def from_block_cuts(cfg, cuts, *, nodes=None, spare_nodes=(),
                    lam: float = DEFAULT_COMPRESSION, wire_bits: int = 0,
                    shape=None, replicas=None) -> StageExecutionPlan:
    """Build an LM IR directly from block cut indices (no cluster needed).

    ``cuts`` are the block indices where stage boundaries fall: stage k owns
    blocks ``[cuts[k-1], cuts[k])`` (with embed prepended to the first stage
    and the head appended to the last), matching ``lm_block_graph`` naming.
    ``nodes`` defaults to ``[0, 1, .., n_stages]``; ``shape`` (a
    ShapeConfig) optionally prices boundaries/FLOPs through the planner's
    own block graph so the IR is emulator-ready too.  ``replicas`` maps a
    stage index to a tuple of warm-replica node ids for that stage."""
    cuts = list(cuts)
    if sorted(set(cuts)) != cuts or any(not 0 < c < cfg.n_layers
                                        for c in cuts):
        raise ValueError(f"cuts must be strictly ascending in "
                         f"(0, {cfg.n_layers}), got {cuts}")
    bounds = [0] + cuts + [cfg.n_layers]
    n_stages = len(bounds) - 1
    if nodes is None:
        nodes = list(range(n_stages + 1))
    if len(nodes) != n_stages + 1:
        raise ValueError(f"need {n_stages + 1} nodes, got {len(nodes)}")

    graph = None
    if shape is not None:
        from .pipeline import lm_block_graph
        graph = lm_block_graph(cfg, shape)

    stages = []
    for k in range(n_stages):
        lo, hi = bounds[k], bounds[k + 1]
        layers = [f"block{i}" for i in range(lo, hi)]
        if k == 0:
            layers = ["input", "embed"] + layers
        if k == n_stages - 1:
            layers = layers + ["head"]
        in_bytes = flops = mem = 0.0
        if graph is not None:
            named = [n for n in layers if n in graph.layers]
            flops = sum(graph.layers[n].flops for n in named)
            mem = sum(graph.layers[n].param_bytes for n in named)
            src = "input" if k == 0 else f"block{lo - 1}"
            in_bytes = graph.layers[src].out_bytes / lam
        stages.append(StageSpec(index=k, layers=tuple(layers),
                                node=nodes[k + 1], in_bytes=in_bytes,
                                memory_bytes=mem, compute_flops=flops,
                                replicas=tuple((replicas or {}).get(k, ()))))
    return StageExecutionPlan(
        stages=stages, dispatcher_node=nodes[0],
        compression=BoundarySpec(lam=lam, wire_bits=wire_bits),
        spare_nodes=tuple(spare_nodes), arch=cfg.name)
