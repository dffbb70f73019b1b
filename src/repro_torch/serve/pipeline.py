"""Plan-faithful pipelined serving with fault-tolerant stage replacement.

Counterpart of ``repro/serve/pipeline.py`` (the sequential engine and its
whole fault surface).  ``PipelineServeEngine`` executes a
``StageExecutionPlan`` (``repro_torch.core.stageplan``): the params are
split into per-stage subtrees (``models.staging``), each stage runs its own
prefill and bucketed greedy decode, and the activation at each stage
boundary is handed to the next stage explicitly — as is, or rowwise-int8
on the wire when ``plan.compression.wire_bits == 8`` (the paper's lambda
compression, executed by the quantize and dequantize kernels).

**Token identity.**  A chain of stages runs the same op sequence as the
monolithic model, so through a raw wire its greedy tokens are bit-identical
to ``ServeEngine``'s.  Faults, routing and migration reorder execution,
never math: across a kill and restore, a silent kill, a faulty wire, a
replica kill or a live migration the tokens are those of the undisturbed
run, on either wire (the int8 wire is lossy, so there the undisturbed run
is the int8 one).

**MoE.**  A stage holds whole groups (``staging``); the batch goes
through each stage as one, so routing (whose expert capacity couples the
rows) sees the rows the monolithic model sees, in a replay too.

**Side inputs.**  Every VLM stage reads the request's vision embeddings,
and the encoder-decoder's first stage encodes the frames and ships the
encoder output to every later stage, once per request (the planner's
``side_in_bytes``).  Each stage fills its own cross caches from them at
prefill.  Side inputs go to each stage directly on both wires: only the
residual boundary goes through the int8 wire and the transport, as in the
reference.

**Fault tolerance.**  At construction every stage's param subtree is
checkpointed (``repro_torch.checkpoint``, the NFS analogue); a hybrid
stage that holds a call site of the shared attention block checkpoints its
own copy of that block, as the plan charges it, and gets it back on
restore.  ``kill_stage`` drops one copy of a stage; when it was the last,
the stage is down (params lost) until ``restore_stage`` reads them back
from the checkpoint onto a spare node — the best by bandwidth to the
pipeline neighbours when a cluster is given — and the in-flight batch is
replayed: greedy decoding is deterministic, so the replay rebuilds the lost
caches exactly.  Spare acquisition and the checkpoint read run under
bounded retry (``serve.retry``; a corrupt checkpoint, a ``ValueError``, is
retried); exhaustion raises :class:`RestoreExhausted` (a
:class:`StageDown`) with every attempt, the stage still down and the spare
pool untouched.

**Replicas** (``StageSpec.replicas``): copies of a stage are routed to by
least-served first (``_route``); losing a copy with survivors is a
zero-restore :class:`ReplicaLost`, killing the primary promotes a replica,
and only a last-copy loss restores and replays.  Copies on one card share
the stage's param tensors, as the reference's copies share one immutable
tree.

**The wire and failure detection.**  With a ``BoundaryTransport``
(``serve.transport``) every boundary payload is framed, CRC-checked,
acknowledged and deduplicated, and rebuilt on the receiving stage's device
from the bytes received on the host.  With a ``HeartbeatMonitor`` every
stage beats after its compute; a silent failure (``fail_silent``) is acted
on only once the monitor rules it DEAD, and suspicion alone never
restores.

**Elastic serving.**  With a ``TelemetryStream`` attached, each decode
step records every stage's latency and boundary-transfer samples (the
stage's device synchronised between the clock's reads); ``replan_live``
folds them into a ``ClusterState``, runs the bounded
``core.replan.incremental_replan`` and executes its moves as live
migrations (checkpoint-backed, the vacated node back in the spare pool; a
failed one raises :class:`StageDegraded` and the stage keeps serving) or
replica additions.

**Per-stage devices** (``devices=``): each stage's params, caches, side
inputs and restored or migrated params live on its own device, and every
boundary payload is delivered onto the receiving stage's device (by the
transport's rebuild when one is attached, else a device-to-device copy).
Placement never changes tokens.

**The overlapped executor** (``overlap=True``): a synchronized batch is
split into contiguous micro-batches (MoE runs one: expert capacity couples
the rows), prefilled and decoded on the reference's skewed schedule (at
tick t stage k runs micro-batch t - k, later stages first), so with stages
on distinct devices stage k computes micro-batch j while the k -> k+1
handoff of micro-batch j - 1 is in flight.  Each micro-batch is an
independent greedy stream, so the tokens are the sequential chain's, also
across kills, replays and wire faults with micro-batches in flight; the
decode loop reads no device value but the telemetry's synchronise.  With
every stage on one device and nothing observing the stages (no transport,
monitor, telemetry, replica, down or dark stage: ``_fused_ok``) the
decode chain is fused: on the CPU the stage bodies run back to back; on
the card each micro-batch's whole chain is one CUDA graph, captured for
each (micro-batch, rows, kv bucket) into caches the engine keeps for that
micro-batch and replays every step; a restore or migration drops every
graph (``_rebuild_fused``).  A capture that fails raises.

**Continuous batching across stages**: ``SlotScheduler`` drives this
engine through per-stage cache banks (``slot_bank``), per-request
admission at the exact prompt length (``admit_slot``), the sequential
chain as the batched decode step (``bank_step``), and per-slot replay
after a restore or a migration (``recover_and_replay``,
``migrate_and_replay``).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import kernels
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                    template_of)
from repro_torch.core.replan import ReplicaAdd, incremental_replan
from repro_torch.kernels.quantize.ops import (rowwise_dequantize,
                                              rowwise_quantize)
from repro_torch.models import staging
from repro_torch.models.layers import dtype_of

from .banks import insert_slot, kill_specs, leaf_batch_axes
from .engine import ServeEngine, as_batch
from .retry import RetryExhausted, RetryPolicy, retry_call
from .transport import DEAD, SUSPECTED


class StageDown(RuntimeError):
    """A dead stage executor was asked to compute."""


class StageDegraded(RuntimeError):
    """A planned migration failed; the stage keeps serving on its old
    node (degraded placement, no outage).  ``attempts`` is the bounded
    -retry failure history of the migration that was abandoned."""

    def __init__(self, msg: str, attempts=()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


class RestoreExhausted(StageDown):
    """Stage restore gave up after bounded retries (spare acquisition or
    checkpoint read); ``attempts`` carries the per-attempt history."""

    def __init__(self, msg: str, attempts=()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


@dataclasses.dataclass(frozen=True)
class ReplicaLost:
    """Typed zero-restore incident: one copy of a replicated stage died
    and the survivors absorbed its share immediately — no checkpoint
    read, no replay, the stage never entered ``down``.  ``promoted`` is
    True when the dead copy was the primary and a replica took over."""

    stage: int
    node: int
    survivors: tuple[int, ...]
    promoted: bool = False


def _result(outs, logs, collect_logits):
    """A generate's np tokens (B, gen_len) int32, with its logits (B,
    gen_len, V) float32 when ``collect_logits``: one host read."""
    toks = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
    if collect_logits:
        return toks, torch.cat(logs, dim=1).float().cpu().numpy()
    return toks


@dataclasses.dataclass
class _Graph:
    """One captured fused decode chain: its graph, the token input it
    reads, the (tokens, logits) it writes, the caches it was captured
    over, and the kernel launches a replay makes (the wrappers' counts its
    capture recorded)."""

    graph: object
    tokens: torch.Tensor
    out: tuple
    caches: list
    launches: dict


class PipelineServeEngine:
    """Greedy pipelined serving over one StageExecutionPlan.

    cfg/params : the model (any ported family); params are split into
                 per-stage subtrees (views of ``params``).
    plan       : StageExecutionPlan; block ranges, node ids, spares and the
                 wire format come from it.
    max_len    : cache capacity per sequence (as ServeEngine).
    kv_block   : decode-attention bucket granularity (as ServeEngine).
    ckpt_dir   : where per-stage param checkpoints live (default: a fresh
                 temp dir owned by the engine); the restore source.
    cluster    : optional ClusterGraph — spare selection then scores
                 bandwidth to the pipeline neighbours, as the emulator's
                 reschedule does.
    telemetry  : optional TelemetryStream — per-stage decode latency and
                 boundary-transfer samples, read through its injected
                 clock; feeds ClusterState -> replan_live.
    retry      : RetryPolicy for checkpoint reads and spare acquisition on
                 the restore and migration paths (default 3 attempts,
                 exponential backoff).
    transport  : optional BoundaryTransport — every stage-boundary handoff
                 (prefill, decode, replay) is framed, CRC-checked,
                 acknowledged and deduplicated through it, and delivered
                 from the received host bytes; with ``None`` the handoff is
                 the in-process tensor pass.
    monitor    : optional HeartbeatMonitor — stages beat after every
                 compute; a silent failure is acted on only once the
                 monitor rules it DEAD (SUSPECTED alone never restores).
    overlap    : ``generate`` and ``timed_decode`` run the overlapped
                 executor: micro-batches on the skewed schedule, and the
                 fused chain where ``_fused_ok`` holds.  It reorders
                 execution only: the tokens are the sequential chain's.
    micro_batches : micro-batches under ``overlap`` (clamped to the batch;
                 1 for MoE).  Default: one a stage when the stages span
                 devices, else 1.
    devices    : per-stage placement: ``None`` (every stage on the params'
                 device), ``"auto"`` (round-robin over the visible CUDA
                 devices; raises without a card), or a sequence of devices,
                 cycled; ``place`` changes it later.  Placement never
                 changes tokens.
    """

    def __init__(self, cfg, params, plan, *, max_len: int, kv_block: int = 32,
                 ckpt_dir=None, cluster=None, telemetry=None, retry=None,
                 transport=None, monitor=None, overlap: bool = False,
                 micro_batches: int | None = None, devices=None):
        self.cfg = cfg
        self.plan = plan
        self.device = params["embed"].device
        self.max_len = int(max_len)
        self.kv_block = int(kv_block)
        self.wire_bits = plan.compression.wire_bits
        if self.wire_bits not in (0, 8):
            raise ValueError(f"wire_bits {self.wire_bits}: need 0 or 8")
        self.ranges = plan.block_ranges(cfg.n_layers)
        staging.check_stage_ranges(cfg, self.ranges)
        self.n_stages = len(self.ranges)
        last = self.n_stages - 1
        self.overlap = bool(overlap)
        self.micro_batches = (None if micro_batches is None
                              else int(micro_batches))
        self.stage_params = [
            staging.extract_stage_params(cfg, params, lo, hi, k == 0,
                                         k == last)
            for k, (lo, hi) in enumerate(self.ranges)]
        self.graph_captures = 0
        self.place(devices)
        self.node_of_stage = [s.node for s in plan.stages]
        self.replica_nodes = [list(s.replicas) for s in plan.stages]
        taken = set(plan.nodes) | set(plan.spare_nodes)
        for k, reps in enumerate(self.replica_nodes):
            for r in reps:
                if r in taken:
                    raise ValueError(
                        f"stage {k}: replica node {r} already hosts a "
                        "stage, the dispatcher, a spare, or another "
                        "replica")
                taken.add(r)
        self._served = [{} for _ in plan.stages]
        self.incidents: list[ReplicaLost] = []
        self.spares = list(plan.spare_nodes)
        self.cluster = cluster
        self.telemetry = telemetry
        self.retry = retry or RetryPolicy()
        self._silent: set[int] = set()   # dark nodes awaiting confirmation
        self.detections: list[tuple[int, float]] = []  # (stage, latency_s)
        self.attach_wire(transport, monitor)
        self.down: set[int] = set()
        self.events: list[tuple[float, str]] = []
        # event-log timestamps are diagnostics, never token-affecting
        self._t0 = time.perf_counter()

        # durable per-stage subtrees: the restore source for replacement
        if ckpt_dir is not None:
            self.ckpt_dir = Path(ckpt_dir)
        else:
            self._ckpt_tmp = tempfile.TemporaryDirectory(
                prefix="repro-torch-stage-ckpt-")
            self.ckpt_dir = Path(self._ckpt_tmp.name)
        self._templates = []
        for k, sp in enumerate(self.stage_params):
            save_checkpoint(self.ckpt_dir / f"stage_{k}", 0, sp)
            self._templates.append(template_of(sp))
        self._bank_axes = None
        self._bank_shape = None

    # -- per-stage device placement ----------------------------------------

    def place(self, devices) -> None:
        """Re-place the stages between requests: ``devices`` as the
        constructor takes it (the constructor places through this too).
        Each stage's params go to its device (kept, not copied, where they
        are already there), and the fused chain's graphs and caches are
        dropped.  The stage checkpoints are not written again: a serving
        process moves its stages onto other devices (or back onto one, to
        fuse the chain) without the seconds a full-width checkpoint write
        takes, and later restores and migrations land on the new devices.
        Later requests get their caches on the new devices."""
        self.devices = staging.resolve_stage_devices(devices, self.n_stages)
        self._multi_device = (self.devices is not None
                              and len(set(self.devices)) > 1)
        self.stage_params = [None if sp is None else self._adopt_params(k, sp)
                             for k, sp in enumerate(self.stage_params)]
        # the fused chain on the card: (micro-batch, rows, kv bucket) ->
        # its captured graph; (micro-batch, rows, enc_len) -> the caches
        # the graphs of that micro-batch read and write
        self._graphs: dict = {}
        self._graph_caches: dict = {}

    def _stage_device(self, k) -> torch.device:
        """Stage ``k``'s device (the params' under the single-node
        layout)."""
        return self.device if self.devices is None else self.devices[k]

    def _to_stage(self, k, x):
        """``x`` (a tensor, or the int8 wire's (q, scale)) on stage ``k``'s
        device; the same tensors where they are already there."""
        dev = self._stage_device(k)
        if isinstance(x, tuple):
            return tuple(t.to(dev) for t in x)
        return x.to(dev)

    def _adopt_params(self, k, tree):
        """A param subtree (extracted, restored or migrated) on stage
        ``k``'s device."""
        return staging.place_stage_params(
            tree, None if self.devices is None else self.devices[k])

    def _sync(self):
        """Wait for every card the stages run on (the timing helpers)."""
        for dev in set(self._stage_device(k) for k in range(self.n_stages)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- wire format --------------------------------------------------------

    def _wire_out(self, h):
        """Boundary activation -> wire payload."""
        if self.wire_bits == 8:
            return rowwise_quantize(h)
        return h

    def _wire_in(self, x):
        if self.wire_bits == 8:
            q, scale = x
            return rowwise_dequantize(q, scale, dtype_of(self.cfg))
        return x

    # -- per-stage steps ----------------------------------------------------

    def _stage_step(self, k, x_in, cache, kv_bucket=None, *, prefill,
                    side=None):
        """Stage ``k`` on its input: tokens (first stage) or the wire
        payload; at prefill ``side`` fills its cross caches first.  Returns
        the wire payload, or (tokens, logits) from the last stage."""
        cfg = self.cfg
        lo, hi = self.ranges[k]
        sp = self.stage_params[k]
        h = (staging.embed_tokens(sp, cfg, x_in) if k == 0
             else self._wire_in(x_in))
        b, s = h.shape[:2]
        if prefill:
            staging.fill_cross_caches(cfg, sp, cache, side)
            positions = torch.arange(s, device=h.device)[None].expand(b, s)
            kv_bucket = None
        elif lo < hi:
            positions = staging.stage_cache_len(cfg, cache)[:, None].expand(
                b, 1)
        else:
            positions = None
        h, cache = staging.stage_backbone(cfg, sp, h, positions, cache, lo,
                                          hi, kv_bucket)
        if k == self.n_stages - 1:
            logits = staging.lm_logits(sp, cfg, h[:, -1:] if prefill else h)
            return (logits.argmax(-1).int(), logits)
        return self._wire_out(h)

    def _side(self, k, batch, enc_out):
        """Stage ``k``'s side input at prefill, on its device: the VLM's
        vision embeddings, or the encoder output the first stage computed
        from the frames (``enc_out``); None for the other families."""
        if self.cfg.family == "vlm":
            return {"vision": self._to_stage(k, batch["vision"])}
        if self.cfg.family == "encdec":
            return {"enc_out": self._to_stage(k, enc_out)}
        return None

    def _prefill_stage(self, k, x, cache, batch, enc_out):
        """Stage ``k``'s prefill with its side input (the first stage of
        the encoder-decoder encodes the frames first; a replay encodes
        them again).  Returns (its output, the encoder output)."""
        if k == 0 and self.cfg.family == "encdec":
            enc_out = staging.encode(self.cfg, self.stage_params[0],
                                     batch["frames"])
        return self._stage_step(k, x, cache, prefill=True,
                                side=self._side(k, batch, enc_out)), enc_out

    # the same bucket and fit contract as ServeEngine
    bucket_for = ServeEngine.bucket_for
    _check_fit = ServeEngine._check_fit

    # -- chained execution --------------------------------------------------

    def _require_up(self, k):
        if self.stage_params[k] is None:
            raise StageDown(f"stage {k} (node {self.node_of_stage[k]}) "
                            "is down — restore it first")

    def stage_copies(self, k: int) -> list[int]:
        """Live copy nodes of stage ``k``, primary first."""
        return [self.node_of_stage[k]] + self.replica_nodes[k]

    def _route(self, k: int) -> int:
        """Deterministic join-shortest-queue routing across stage ``k``'s
        copies: with no standing queues in the synchronous host loop, the
        first copy (primary-then-replica order) with the fewest batches
        served so far wins.  Copies hold the same params, so routing never
        affects tokens."""
        copies = self.stage_copies(k)
        if len(copies) == 1:
            return copies[0]
        served = self._served[k]
        tgt = min(copies, key=lambda n: (served.get(n, 0), copies.index(n)))
        served[tgt] = served.get(tgt, 0) + 1
        return tgt

    def _pre_stage(self, k):
        """Liveness gate before computing stage ``k``: a silently failed
        node cannot answer, so the heartbeat monitor is driven until it
        rules DEAD (raising :class:`StageDown` into the restore path) —
        mere SUSPECTED keeps the pipeline serving."""
        if k in self._silent:
            self._confirm_dead(k)
        self._require_up(k)

    def _post_stage(self, k, x):
        """After stage ``k`` computes: heartbeat, then the boundary wire
        onto stage ``k+1``'s device: through the transport when one is
        attached (the payload rebuilt there from the received bytes), else
        a device-to-device copy where the stages' devices differ."""
        if self.monitor is not None:
            self.monitor.beat(k)
        if k < self.n_stages - 1:
            if self.transport is not None:
                x = self.transport.send(k, x,
                                        device=self._stage_device(k + 1))
            elif self.devices is not None:
                x = self._to_stage(k + 1, x)
        return x

    def _chain_prefill(self, batch, caches):
        """Prefill through every stage, each given its side input.
        Returns the last stage's (tokens, logits)."""
        x, enc_out = batch["tokens"], None
        for k in range(self.n_stages):
            self._pre_stage(k)
            self._route(k)
            x, enc_out = self._prefill_stage(k, x, caches[k], batch,
                                             enc_out)
            x = self._post_stage(k, x)
        return x

    def _chain_decode(self, toks, caches, bucket):
        """One decode step through every stage (the last stage's tokens go
        back to the first stage's device).  Returns (tokens, logits)."""
        x = self._to_stage(0, toks)
        for k in range(self.n_stages):
            self._pre_stage(k)
            self._route(k)
            x = self._timed_stage(k, x, caches[k], bucket)
            x = self._post_stage(k, x)
        return x

    def _timed_stage(self, k, x, cache, bucket):
        """Stage ``k``'s decode step; with telemetry, its latency and
        boundary-transfer samples at the reference's three clock reads
        (the stage's device synchronised between the second and third:
        the one device read the decode loops make)."""
        tel = self.telemetry
        if tel is None:
            return self._stage_step(k, x, cache, bucket, prefill=False)
        t0 = tel.now()
        x = self._stage_step(k, x, cache, bucket, prefill=False)
        t1 = tel.now()
        dev = self._stage_device(k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = tel.now()
        tel.record_decode(k, t2 - t0)
        if k < self.n_stages - 1:
            # boundary materialization time stands in for the wire hop
            tel.record_transfer(k, self._payload_bytes(x), t2 - t1)
        return x

    @staticmethod
    def _payload_bytes(x) -> float:
        leaves = x if isinstance(x, tuple) else (x,)
        return float(sum(t.numel() * t.element_size() for t in leaves))

    def _fresh_caches(self, b, enc_len=None):
        """Empty stage caches for ``b`` rows, each on its stage's device
        (the encoder-decoder's cross caches of ``enc_len`` rows, the
        frames' length)."""
        return [staging.init_stage_cache(self.cfg, lo, hi, b, self.max_len,
                                         device=self._stage_device(k),
                                         enc_len=enc_len)
                for k, (lo, hi) in enumerate(self.ranges)]

    @staticmethod
    def _enc_len(batch):
        return batch["frames"].shape[1] if "frames" in batch else None

    def _batch_caches(self, batch):
        """Empty stage caches for a request batch."""
        return self._fresh_caches(batch["tokens"].shape[0],
                                  self._enc_len(batch))

    # -- synchronized-batch generation with deterministic fault injection ---

    @torch.inference_mode()
    def generate(self, batch, gen_len: int, *, kill=None, replan=None,
                 collect_logits: bool = False):
        """Greedy-decode a synchronized batch for ``gen_len`` tokens
        through the stage pipeline; np tokens (B, gen_len) int32, or
        (tokens, logits (B, gen_len, V) float32) when ``collect_logits``
        (each step's logits as the step that emitted its tokens computed
        them).  With ``overlap`` the overlapped executor serves it, to the
        same contract.

        kill: optional ``{"after_step": s, "stage": k}`` — or a list of such
        specs — stage ``k`` loses a copy after ``s`` completed decode steps
        (0 = right after prefill); ``"replica"`` names the copy node to
        kill (default: the primary), and ``"silent": True`` makes the
        primary go dark instead, for the heartbeat monitor to find.  A copy
        with survivors is absorbed with zero restore; once a stage has no
        copy left the engine restores it onto a spare and replays the
        in-flight batch, so the stream is identical to an undisturbed run
        either way.

        replan: optional ``{"after_step": s, "cluster": state, ...}`` —
        after ``s`` completed decode steps, run ``replan_live`` against
        ``state`` (a ClusterState or ClusterGraph; optional keys
        ``max_moves``, ``min_gain_s``); if the plan changed, the in-flight
        batch is replayed across the migrated placement."""
        batch = as_batch(batch, self._stage_device(0))
        if self.overlap:
            return self._generate_overlap(batch, gen_len, kill, replan,
                                          collect_logits)
        b, prompt_len = batch["tokens"].shape
        self._check_fit(prompt_len, gen_len)
        kills = kill_specs(kill)
        for k in sorted(self.down):        # e.g. killed between calls
            self.restore_stage(k)
        caches = self._batch_caches(batch)
        while True:
            try:
                toks, logits = self._chain_prefill(batch, caches)
                break
            except StageDown:      # silent failure confirmed mid-prefill
                for k in sorted(self.down):
                    self.restore_stage(k)
                caches = self._batch_caches(batch)
        outs, logs = [toks], [logits]
        cur = prompt_len
        for step in range(gen_len - 1):
            self._fire_kills(kills, step)
            if self.down:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks, caches = self._replay_sync(batch, step)
            if self._replanned(replan, step):
                toks, caches = self._replay_sync(batch, step)
            (toks, logits), caches = self._decode_step_checked(
                batch, toks, caches, step, cur)
            cur += 1
            outs.append(toks)
            if collect_logits:
                logs.append(logits)
        return _result(outs, logs, collect_logits)

    def _fire_kills(self, kills, step):
        """The kills due after ``step`` completed decode steps."""
        for spec in kills:
            if spec["after_step"] == step:
                if spec.get("silent"):
                    self.fail_silent(spec["stage"])
                else:
                    self.kill_stage(spec["stage"],
                                    replica=spec.get("replica"))

    def _replanned(self, replan, step) -> bool:
        """Run the replan due after ``step`` decode steps; True when it
        moved a stage (the in-flight batch must be replayed)."""
        if replan is None or replan["after_step"] != step:
            return False
        return self.replan_live(
            replan["cluster"], max_moves=replan.get("max_moves", 1),
            min_gain_s=replan.get("min_gain_s", 0.0)).changed

    def _decode_step_checked(self, batch, toks, caches, step, cur):
        """One decode step with silent-failure recovery: a
        :class:`StageDown` raised mid-chain (a silent stage the heartbeat
        monitor just confirmed DEAD) restores every down stage, replays the
        in-flight batch to ``step`` completed decode steps, and retries.
        The replay builds fresh caches, so the ones the aborted chain
        updated are never read again.  Returns ((tokens, logits),
        caches)."""
        while True:
            try:
                return self._chain_decode(toks, caches,
                                          self.bucket_for(cur + 1)), caches
            except StageDown:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks, caches = self._replay_sync(batch, step)

    def _replay_sync(self, batch, steps_done):
        """Replay the in-flight batch after a restore or migration: fresh
        caches, prefill (every stage gets its side input again), and the
        ``steps_done`` decode steps already emitted (greedy decoding is
        deterministic, so the replay rebuilds the lost stage state
        exactly)."""
        b, prompt_len = batch["tokens"].shape
        caches = self._batch_caches(batch)
        toks, _ = self._chain_prefill(batch, caches)
        cur = prompt_len
        for _ in range(steps_done):
            toks, _ = self._chain_decode(toks, caches,
                                         self.bucket_for(cur + 1))
            cur += 1
        self._note(f"replayed {b} in-flight request(s), {steps_done} "
                   "decode step(s)")
        return toks, caches

    # -- overlapped execution (micro-batch interleave) -----------------------
    #
    # The overlapped executor reorders execution only.  Each micro-batch is
    # an independent greedy stream (a row's tokens depend on no other row),
    # so splitting a synchronized batch and skewing the schedule — at tick
    # t, stage k runs micro-batch t - k, later stages first — changes no
    # token.  PyTorch's launches are asynchronous: with stages on distinct
    # devices, stage k's kernels for micro-batch j run while the k -> k+1
    # handoff of micro-batch j - 1 is copied.  The decode loop reads no
    # device value; the only host waits are the end of ``generate`` and the
    # telemetry's samples.

    def _resolve_micro(self, b: int) -> int:
        """Micro-batch count for a ``b``-row batch (see ``micro_batches``
        in the class docstring)."""
        if not self.overlap or self.cfg.family == "moe":
            # MoE: expert capacity couples the rows (Switch-style drops),
            # so a split would change routing — never split
            return 1
        m = self.micro_batches
        if m is None:
            m = self.n_stages if self._multi_device else 1
        return max(1, min(int(m), b))

    @staticmethod
    def _split_batch(batch, m: int):
        """Every request field split into ``m`` contiguous row blocks (row
        order kept, so concatenating the micro-batches' streams restores
        the caller's batch order)."""
        if m == 1:
            return [batch]
        b = batch["tokens"].shape[0]
        bounds = [(i * b) // m for i in range(m + 1)]
        return [{kk: v[lo:hi] for kk, v in batch.items()}
                for lo, hi in zip(bounds[:-1], bounds[1:])]

    def _mb_caches(self, j, mb):
        """Micro-batch ``j``'s empty stage caches: fresh ones, or on the
        card's fused path the ones its graphs read and write, kept by the
        engine for this micro-batch's shape and zeroed in place."""
        if not (self._fused_ok() and self.device.type == "cuda"):
            return self._batch_caches(mb)
        key = (j, mb["tokens"].shape[0], self._enc_len(mb))
        caches = self._graph_caches.get(key)
        if caches is None:
            caches = self._graph_caches[key] = self._batch_caches(mb)
        else:
            for c in caches:
                for t in tree_leaves(c):
                    t.zero_()
        return caches

    def _overlap_prefill(self, mbs):
        """Prefill ``mbs`` through the stage pipeline on the skewed
        schedule.  Returns (per-micro-batch first tokens, prefill logits,
        caches)."""
        m = len(mbs)
        last = self.n_stages - 1
        caches_mb = [self._mb_caches(j, mb) for j, mb in enumerate(mbs)]
        xs = [mb["tokens"] for mb in mbs]
        enc = [None] * m
        for t in range(m + last):
            for k in range(min(t, last), max(t - m, -1), -1):
                j = t - k
                self._pre_stage(k)
                self._route(k)
                xs[j], enc[j] = self._prefill_stage(k, xs[j],
                                                    caches_mb[j][k], mbs[j],
                                                    enc[j])
                xs[j] = self._post_stage(k, xs[j])
        return [x[0] for x in xs], [x[1] for x in xs], caches_mb

    def _rebuild_fused(self):
        """Drop the fused chain's captured graphs: each read the stage
        params it was captured with, so a restore or migration that swaps
        a stage's params needs new ones (captured again at the next
        step)."""
        self._graphs = {}

    def _fused_ok(self) -> bool:
        """True when the overlapped executor may fuse the decode chain.
        With every stage on one device the skewed schedule overlaps
        nothing — one device queue serialises the stage calls — so each
        micro-batch's whole chain runs as one unit.  Anything that
        observes per-stage execution (per-stage devices, a boundary
        transport, heartbeats, telemetry, replica routing, a dead or dark
        stage) keeps the staged schedule, which holds every fault and
        observability contract."""
        return (self.overlap and self.devices is None
                and self.transport is None and self.monitor is None
                and self.telemetry is None
                and not self.down and not self._silent
                and all(not r for r in self.replica_nodes))

    def _fused_chain(self, toks, caches, bucket):
        """The decode step's stage bodies back to back, without the
        per-stage gates: (tokens, logits)."""
        x = toks
        for k in range(self.n_stages):
            x = self._stage_step(k, x, caches[k], bucket, prefill=False)
        return x

    def _fused_step(self, j, toks, caches, bucket):
        """Micro-batch ``j``'s fused decode step.  On the CPU the chain
        runs as it is.  On the card it is one CUDA graph a (micro-batch,
        rows, kv bucket): the first step of a shape runs the chain eagerly
        (that step's result, and the warm-up of every kernel and buffer
        the capture records) and then captures it; later steps copy their
        tokens into the graph's input, replay it and clone its outputs out
        (the next replay overwrites them).  A capture that fails raises.
        The kernel launch counts see the launches that run: the eager
        step's and each replay's, never the capture's."""
        if toks.device.type != "cuda":
            return self._fused_chain(toks, caches, bucket)
        key = (j, toks.shape[0], bucket)
        g = self._graphs.get(key)
        if g is None or g.caches is not caches:
            out = self._fused_chain(toks, caches, bucket)
            inp = toks.clone()
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph):
                    return self._fused_chain(inp, caches, bucket)

            res, launches = kernels.recorded_launches(capture)
            self._graphs[key] = _Graph(graph, inp, res, caches, launches)
            self.graph_captures += 1
            return out
        g.tokens.copy_(toks)
        g.graph.replay()
        kernels.add_launches(g.launches)
        return g.out[0].clone(), g.out[1].clone()

    def _overlap_step(self, toks_mb, caches_mb, bucket):
        """One greedy decode step for every micro-batch on the skewed
        schedule: within a tick, later stages (older micro-batches) go
        before earlier ones, so stage k's compute of micro-batch j overlaps
        the k -> k+1 handoff of micro-batch j - 1.  No host read but the
        telemetry's samples.  A :class:`StageDown` raised mid-schedule
        aborts the step; callers replay the in-flight window.  Under
        ``_fused_ok`` each micro-batch runs its fused chain instead.
        Returns (tokens, logits, caches) by micro-batch."""
        m = len(toks_mb)
        if self._fused_ok():
            outs = [self._fused_step(j, toks_mb[j], caches_mb[j], bucket)
                    for j in range(m)]
            return [o[0] for o in outs], [o[1] for o in outs], caches_mb
        last = self.n_stages - 1
        xs = [self._to_stage(0, t) for t in toks_mb]
        for t in range(m + last):
            for k in range(min(t, last), max(t - m, -1), -1):
                j = t - k
                self._pre_stage(k)
                self._route(k)
                xs[j] = self._timed_stage(k, xs[j], caches_mb[j][k], bucket)
                xs[j] = self._post_stage(k, xs[j])
        return [x[0] for x in xs], [x[1] for x in xs], caches_mb

    def _overlap_replay(self, mbs, steps_done: int):
        """Replay the in-flight window after a restore or migration under
        overlap: fresh caches, the skewed prefill, and the ``steps_done``
        decode steps already emitted (the overlapped counterpart of
        ``_replay_sync``)."""
        toks_mb, _, caches_mb = self._overlap_prefill(mbs)
        cur = mbs[0]["tokens"].shape[1]
        for _ in range(steps_done):
            toks_mb, _, caches_mb = self._overlap_step(
                toks_mb, caches_mb, self.bucket_for(cur + 1))
            cur += 1
        n = sum(mb["tokens"].shape[0] for mb in mbs)
        self._note(f"replayed {n} in-flight request(s) across {len(mbs)} "
                   f"micro-batch(es), {steps_done} decode step(s)")
        return toks_mb, caches_mb

    def _generate_overlap(self, batch, gen_len, kill, replan,
                          collect_logits):
        """The overlapped executor behind ``generate`` (same contract, same
        fault semantics, the same tokens): micro-batched, one host read at
        the end."""
        b, prompt_len = batch["tokens"].shape
        self._check_fit(prompt_len, gen_len)
        kills = kill_specs(kill)
        for k in sorted(self.down):        # e.g. killed between calls
            self.restore_stage(k)
        mbs = self._split_batch(batch, self._resolve_micro(b))
        while True:
            try:
                toks_mb, logits_mb, caches_mb = self._overlap_prefill(mbs)
                break
            except StageDown:      # silent failure confirmed mid-prefill
                for k in sorted(self.down):
                    self.restore_stage(k)
        outs = [[t] for t in toks_mb]
        logs = [[lg] for lg in logits_mb]
        cur = prompt_len
        for step in range(gen_len - 1):
            self._fire_kills(kills, step)
            if self.down:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks_mb, caches_mb = self._overlap_replay(mbs, step)
            if self._replanned(replan, step):
                toks_mb, caches_mb = self._overlap_replay(mbs, step)
            while True:
                try:
                    toks_mb, logits_mb, caches_mb = self._overlap_step(
                        toks_mb, caches_mb, self.bucket_for(cur + 1))
                    break
                except StageDown:  # silent failure confirmed mid-step
                    for k in sorted(self.down):
                        self.restore_stage(k)
                    toks_mb, caches_mb = self._overlap_replay(mbs, step)
            cur += 1
            for j in range(len(mbs)):
                outs[j].append(toks_mb[j])
                if collect_logits:
                    logs[j].append(logits_mb[j])
        # row order restored by the contiguous split
        toks = [torch.cat(o, dim=1) for o in outs]
        logits = [torch.cat(lg, dim=1) for lg in logs]
        return _result([torch.cat(toks)], [torch.cat(logits)],
                       collect_logits)

    # -- fault injection / recovery ----------------------------------------

    def _note(self, msg: str):
        self.events.append((time.perf_counter() - self._t0, msg))

    def kill_stage(self, k: int, replica: int | None = None) -> None:
        """Kill one copy of stage ``k`` (default: the primary).

        With surviving copies this is a **zero-restore** event
        (:class:`ReplicaLost`, appended to ``incidents``): the survivors
        absorb the dead copy's share immediately — no checkpoint read, no
        replay, the stage never enters ``down`` (caches are request-owned
        here, so nothing is lost with the node).  Killing the primary
        promotes the first replica.  Only when the *last* copy dies does
        the stage go down — params and caches lost, checkpoint restore and
        replay required."""
        self._require_up(k)
        copies = self.stage_copies(k)
        node = copies[0] if replica is None else replica
        if node not in copies:
            raise ValueError(f"stage {k}: node {node} hosts no copy of it "
                             f"(copies: {copies})")
        if len(copies) > 1:
            promoted = node == self.node_of_stage[k]
            if promoted:
                self.node_of_stage[k] = self.replica_nodes[k].pop(0)
            else:
                self.replica_nodes[k].remove(node)
            self._served[k].pop(node, None)
            survivors = tuple(self.stage_copies(k))
            self.incidents.append(ReplicaLost(k, node, survivors, promoted))
            self._note(f"stage {k}: replica on node {node} LOST "
                       f"({len(survivors)} survivor(s), no restore"
                       + (", replica promoted to primary)" if promoted
                          else ")"))
            return
        self.down.add(k)
        self.stage_params[k] = None
        self._note(f"node {self.node_of_stage[k]} FAILED (stage {k})")

    def attach_wire(self, transport=None, monitor=None) -> None:
        """Swap the boundary transport and heartbeat monitor and reset the
        wire-side failure state, so one engine (whose stages are
        checkpointed once) serves many fault cases."""
        if transport is not None and transport.n_hops != self.n_stages - 1:
            raise ValueError(
                f"transport has {transport.n_hops} hop(s) but the plan has "
                f"{self.n_stages} stage(s) ({self.n_stages - 1} boundaries)")
        self.transport = transport
        self.monitor = monitor
        self._silent.clear()
        self.detections = []

    def fail_silent(self, k: int) -> None:
        """Inject a *silent* failure of stage ``k``'s primary: the node
        stops computing and heartbeating but nothing raises yet — the
        failure only becomes actionable once the heartbeat monitor rules
        it DEAD (``_confirm_dead``, driven from ``_pre_stage``).  Requires
        a monitor: without one a silent failure is undetectable."""
        if self.monitor is None:
            raise ValueError(
                f"stage {k}: silent failure injected with no heartbeat "
                "monitor attached — it would never be detected")
        self._require_up(k)
        self._silent.add(k)
        self._note(f"stage {k} (node {self.node_of_stage[k]}) went SILENT")

    def _confirm_dead(self, k: int) -> None:
        """Drive the heartbeat monitor until silent stage ``k`` is ruled
        DEAD, then take the kill path.  While the silence is short the
        stage is merely SUSPECTED and keeps serving (a stalled wire must
        never trigger a restore).  At DEAD the copy dies: survivors absorb
        it, else :class:`StageDown` is raised into restore and replay.
        The silence at confirmation lands in ``detections``."""
        mon = self.monitor
        noted = False
        while (st := mon.state(k)) != DEAD:
            if st == SUSPECTED and not noted:
                noted = True
                self._note(f"stage {k}: heartbeat SUSPECTED (silence "
                           f"{mon.silence_s(k):.3g}s) — still serving, "
                           "no restore")
            mon.wait()
        latency = float(mon.silence_s(k))
        self.detections.append((k, latency))
        self._silent.discard(k)
        self._note(f"stage {k}: heartbeat silence {latency:.3g}s >= "
                   f"{mon.dead_after_s:.3g}s — CONFIRMED DEAD")
        self.kill_stage(k)             # survivors absorb; else StageDown:
        self._require_up(k)

    def kill_replica(self, k: int, node: int | None = None) -> None:
        """Kill a warm replica of stage ``k`` (never the primary; default:
        the first replica).  Always a zero-restore event."""
        if not self.replica_nodes[k]:
            raise ValueError(f"stage {k} has no replicas to kill")
        tgt = self.replica_nodes[k][0] if node is None else node
        if tgt not in self.replica_nodes[k]:
            raise ValueError(f"stage {k}: node {tgt} is not one of its "
                             f"replicas {self.replica_nodes[k]}")
        self.kill_stage(k, replica=tgt)

    def _spare_score(self, k: int, n: int) -> float:
        """The emulator's reschedule score: bandwidth to the neighbours."""
        prev = (self.plan.dispatcher_node if k == 0
                else self.node_of_stage[k - 1])
        s = self.cluster.bw[prev, n]
        if k < self.n_stages - 1:
            s += self.cluster.bw[n, self.node_of_stage[k + 1]]
        return s

    def _acquire_spare(self, k: int, node: int | None = None) -> int:
        """The spare node stage ``k`` would restore or migrate onto, not
        yet removed from the pool (callers commit only after the checkpoint
        read also succeeded).  StageDown when the pool is empty (retryable)
        and ValueError for an explicit node that is not a spare (a bug,
        not a blip)."""
        if node is None:
            if not self.spares:
                raise StageDown(f"stage {k}: no spare node to restore onto")
            if self.cluster is None:
                return self.spares[0]
            return max(self.spares, key=lambda n: self._spare_score(k, n))
        if node not in self.spares:
            raise ValueError(
                f"stage {k}: node {node} is not in the spare pool "
                f"{self.spares} (stages restore onto spares, as in the "
                "emulator's reschedule)")
        return node

    def _restore_params(self, k: int):
        """Stage ``k``'s checkpoint read onto the stage's device under
        bounded retry (a corrupt leaf, ``CheckpointCorrupt``, is a
        ``ValueError``: retried)."""
        return retry_call(
            lambda: restore_checkpoint(self.ckpt_dir / f"stage_{k}", 0,
                                       self._templates[k],
                                       device=self._stage_device(k)),
            what=f"stage {k}: checkpoint restore", policy=self.retry,
            retry_on=(OSError, ValueError, KeyError))

    def restore_stage(self, k: int, node: int | None = None) -> None:
        """Restore stage ``k``'s params from its checkpoint onto a spare
        node.  Spare acquisition and the checkpoint read each run under the
        engine's retry policy; on exhaustion the stage stays down, the
        spare pool is untouched (the call is retryable later), and
        :class:`RestoreExhausted` carries every attempt."""
        if k not in self.down:
            return
        try:
            target = retry_call(lambda: self._acquire_spare(k, node),
                                what=f"stage {k}: spare acquisition",
                                policy=self.retry, retry_on=(StageDown,))
        except RetryExhausted as e:
            self._note(f"stage {k}: NO SPARE NODE — pipeline stalled")
            raise RestoreExhausted(str(e), e.attempts) from e
        try:
            restored = self._restore_params(k)
        except RetryExhausted as e:
            self._note(f"stage {k}: checkpoint restore FAILED "
                       f"({len(e.attempts)} attempt(s)) — still down")
            raise RestoreExhausted(str(e), e.attempts) from e
        self.spares.remove(target)
        old = self.node_of_stage[k]
        self.node_of_stage[k] = target
        self.stage_params[k] = self._adopt_params(k, restored)
        self._rebuild_fused()              # the graphs read the old params
        self.down.discard(k)
        self._note(f"stage {k}: pod rescheduled {old} -> {target} "
                   "(params restored from checkpoint)")

    def migrate_stage(self, k: int, node: int | None = None) -> int:
        """Move a *live* stage onto a spare node (planned migration, the
        executor half of ``replan_live``).  The new executor is stood up
        first — spare acquisition and checkpoint read under bounded retry —
        and only then does the stage switch nodes; the vacated (healthy)
        node rejoins the spare pool.  On failure the stage keeps serving
        where it is and :class:`StageDegraded` is raised.  Callers replay
        in-flight work.

        Migrating onto one of the stage's **own replicas** is a
        *promotion*: a role swap, with no checkpoint read and no spare
        spent; the vacated primary becomes the replica.  Returns the new
        node id."""
        self._require_up(k)
        if node is not None and node in self.replica_nodes[k]:
            old = self.node_of_stage[k]
            self.replica_nodes[k] = [old if x == node else x
                                     for x in self.replica_nodes[k]]
            self.node_of_stage[k] = node
            self._note(f"stage {k}: PROMOTED replica {old} -> {node} "
                       "(role swap with warm replica, no checkpoint read)")
            return node
        try:
            target = self._acquire_spare(k, node)
            restored = self._restore_params(k)
        except (StageDown, RetryExhausted) as e:
            attempts = getattr(e, "attempts", ())
            self._note(f"stage {k}: migration ABANDONED ({e}) — "
                       f"serving degraded on node {self.node_of_stage[k]}")
            raise StageDegraded(
                f"stage {k}: migration failed, still on node "
                f"{self.node_of_stage[k]}: {e}", attempts) from e
        self.spares.remove(target)
        old = self.node_of_stage[k]
        self.node_of_stage[k] = target
        self.stage_params[k] = self._adopt_params(k, restored)
        self._rebuild_fused()              # the graphs read the old params
        self.spares.append(old)            # vacated node is healthy
        self._note(f"stage {k}: MIGRATED {old} -> {target} "
                   "(params restored from checkpoint, "
                   f"node {old} returned to spare pool)")
        return target

    def add_replica(self, k: int, node: int | None = None) -> int:
        """Stand up an extra warm replica of stage ``k`` on a spare node
        (the executor half of a ``ReplicaAdd`` replan move): spare
        acquisition and the new executor's checkpoint read run under the
        retry policy; on failure nothing changes and
        :class:`StageDegraded` is raised.  Returns the replica's node."""
        self._require_up(k)
        try:
            target = self._acquire_spare(k, node)
            self._restore_params(k)    # the new executor's param read
        except (StageDown, RetryExhausted) as e:
            attempts = getattr(e, "attempts", ())
            self._note(f"stage {k}: replica add ABANDONED ({e}) — "
                       "serving without the extra copy")
            raise StageDegraded(
                f"stage {k}: replica add failed: {e}", attempts) from e
        self.spares.remove(target)
        self.replica_nodes[k].append(target)
        self._note(f"stage {k}: replica ADDED on node {target} "
                   f"(copies: {self.stage_copies(k)})")
        return target

    # -- closed-loop replanning ---------------------------------------------

    def current_plan(self):
        """The plan as deployed now: the original plan with the live node
        assignment, replicas and spare pool substituted in."""
        stages = [dataclasses.replace(s, node=self.node_of_stage[i],
                                      replicas=tuple(self.replica_nodes[i]))
                  for i, s in enumerate(self.plan.stages)]
        return dataclasses.replace(self.plan, stages=tuple(stages),
                                   spare_nodes=tuple(self.spares))

    def replan_live(self, state, *, max_moves: int = 1,
                    min_gain_s: float = 0.0, allow_replicas: bool = False):
        """Close the telemetry -> replan -> migrate loop once.

        ``state``: a ClusterState (this engine's pending telemetry samples
        and the monitor's report are folded in first) or a ClusterGraph.
        Runs the bounded ``incremental_replan`` against the estimate and
        executes its moves: a ``StageMove`` by ``migrate_stage`` (onto the
        stage's own replica, a promotion), a ``ReplicaAdd`` by
        ``add_replica``; a move that fails (:class:`StageDegraded`) is
        skipped.  Returns the ReplanResult with ``moves`` trimmed to those
        executed; callers replay in-flight work for its migrated
        stages."""
        if self.telemetry is not None and hasattr(state, "fold"):
            state.fold(self.telemetry, self.node_of_stage,
                       self.plan.dispatcher_node)
        if self.monitor is not None and hasattr(state, "fold_health"):
            state.fold_health(self.monitor.report(), self.node_of_stage)
        est = state.as_cluster() if hasattr(state, "as_cluster") else state
        res = incremental_replan(self.current_plan(), est,
                                 max_moves=max_moves, min_gain_s=min_gain_s,
                                 allow_replicas=allow_replicas)
        moved = []
        for mv in res.moves:
            try:
                if isinstance(mv, ReplicaAdd):
                    self.add_replica(mv.stage, mv.node)
                else:
                    self.migrate_stage(mv.stage, mv.new_node)
            except StageDegraded:
                continue
            moved.append(mv)
        self._note(f"replan: {len(moved)}/{len(res.moves)} move(s) "
                   f"executed (bottleneck {res.bottleneck_before_s:.3g}s "
                   f"-> {res.bottleneck_after_s:.3g}s est.)")
        return dataclasses.replace(res, moves=tuple(moved))

    # -- scheduler integration (continuous batching across stages) ----------

    def admit_burst(self) -> int | None:
        """How many admissions the scheduler interleaves a decode round.
        ``None`` (the sequential engine) fills every free slot before a
        step; under overlap at most one admission a micro-batch slot of
        the pipeline a round.  Pacing reorders admissions only: a
        request's tokens do not depend on the schedule."""
        if not self.overlap:
            return None
        m = (self.micro_batches if self.micro_batches is not None
             else self.n_stages)
        return max(1, int(m))

    def slot_bank(self, slots: int, proto=None):
        """Per-stage cache banks of ``slots`` rows, each on its stage's
        device, for requests whose side inputs are shaped like ``proto``'s
        (leading dim 1; the encoder-decoder's frames fix the cross caches'
        rows).  Also fixes each bank leaf's batch axis, found from caches
        built on the meta device (the port's
        ``SlotScheduler._leaf_batch_axes``)."""
        enc_len = self._enc_len(proto or {})
        self._bank_shape = (int(slots), enc_len)
        self._bank_axes = [
            leaf_batch_axes(lambda b, lo=lo, hi=hi: staging.init_stage_cache(
                self.cfg, lo, hi, b, self.max_len, device="meta",
                enc_len=enc_len))
            for lo, hi in self.ranges]
        return self._fresh_caches(slots, enc_len)

    def _scatter(self, k, bank, one, slot):
        """Stage ``k``'s batch-1 cache ``one`` into slot ``slot`` of its
        bank, in place."""
        insert_slot(bank, one, slot, self._bank_axes[k])

    def admit_slot(self, batch, caches, slot_tokens, slot):
        """Admit one request (``batch``: its tokens (1, S) and side input)
        into slot ``slot`` of every stage's bank: each stage prefills it at
        its exact prompt length into a batch-1 stage cache, with its side
        input, through the liveness gate and the boundary wire (so the
        transport and the heartbeats see admissions; as in the reference,
        an admission is not routed), and scatters the cache into its bank.
        Returns (first token (1, 1), slot_tokens with the token in
        ``slot``: a new tensor, the old one holds a recorded step)."""
        batch = as_batch(batch, self._stage_device(0))
        s, enc_len = batch["tokens"].shape[1], self._enc_len(batch)
        x, enc_out = batch["tokens"], None
        for k, (lo, hi) in enumerate(self.ranges):
            self._pre_stage(k)
            c1 = staging.init_stage_cache(self.cfg, lo, hi, 1, s,
                                          device=self._stage_device(k),
                                          enc_len=enc_len)
            x, enc_out = self._prefill_stage(k, x, c1, batch, enc_out)
            self._scatter(k, caches[k], c1, slot)
            x = self._post_stage(k, x)
        tok = x[0]
        slot_tokens = slot_tokens.clone()
        slot_tokens[slot] = tok[0].to(slot_tokens.device)
        return tok, slot_tokens

    def bank_step(self, slot_tokens, caches, bucket, inflight):
        """The scheduler's batched decode step over the banks: the
        sequential chain (also under ``overlap``).  A silent stage
        confirmed DEAD mid-chain is restored, every in-flight request
        (``inflight``, as ``_replay_into_banks`` takes it) replayed into
        its slot, and the step retried.  Returns (tokens, logits,
        caches)."""
        while True:
            try:
                toks, logits = self._chain_decode(slot_tokens, caches,
                                                  bucket)
                return toks, logits, caches
            except StageDown:
                caches, slot_tokens = self.recover_and_replay(
                    inflight, caches, slot_tokens)

    def _replay_into_banks(self, stages, inflight, caches, slot_tokens):
        """Re-create the banks of ``stages`` (whose executors just changed
        nodes) and replay every in-flight request into its slot.

        inflight: list of (slot, Request, n_emitted).  Each request is
        replayed alone (prefill and its emitted decode steps on batch-1
        caches: a row's tokens do not depend on its neighbours) and its
        per-stage state is scattered back into every bank.  Returns
        (caches, slot_tokens)."""
        slots, enc_len = self._bank_shape
        for k in stages:
            lo, hi = self.ranges[k]
            caches[k] = staging.init_stage_cache(
                self.cfg, lo, hi, slots, self.max_len,
                device=self._stage_device(k), enc_len=enc_len)
        for slot, req, n_emitted in inflight:
            batch = as_batch({"tokens": req.tokens, **(req.extras or {})},
                             self._stage_device(0))
            c1 = self._batch_caches(batch)
            toks, _ = self._chain_prefill(batch, c1)
            cur = req.tokens.shape[1]
            for _ in range(n_emitted - 1):
                toks, _ = self._chain_decode(toks, c1,
                                             self.bucket_for(cur + 1))
                cur += 1
            for k in range(self.n_stages):
                self._scatter(k, caches[k], c1[k], slot)
            slot_tokens = slot_tokens.clone()
            slot_tokens[slot] = toks[0].to(slot_tokens.device)
        return caches, slot_tokens

    def recover_and_replay(self, inflight, caches, slot_tokens):
        """Scheduler-side recovery: restore the dead stages, re-create
        their banks and replay every in-flight request into its slot (see
        ``_replay_into_banks``)."""
        dead = sorted(self.down)
        for k in dead:
            self.restore_stage(k)
        caches, slot_tokens = self._replay_into_banks(dead, inflight, caches,
                                                      slot_tokens)
        self._note(f"replayed {len(inflight)} in-flight request(s) after "
                   f"restoring stage(s) {dead}")
        return caches, slot_tokens

    def migrate_and_replay(self, stages, inflight, caches, slot_tokens):
        """Scheduler-side counterpart of a live migration: the moved
        stages' banks stayed with the vacated executors, so they are
        re-created and every in-flight request is replayed into its slot
        (see ``_replay_into_banks``)."""
        stages = sorted(stages)
        caches, slot_tokens = self._replay_into_banks(stages, inflight,
                                                      caches, slot_tokens)
        self._note(f"replayed {len(inflight)} in-flight request(s) after "
                   f"migrating stage(s) {stages}")
        return caches, slot_tokens

    # -- timing helpers ------------------------------------------------------

    def warmup(self, batch, gen_len: int) -> float:
        """One throwaway ``generate`` (kernel builds, graph captures);
        its wall seconds, ending in a device synchronise."""
        t0 = time.perf_counter()
        self.generate(batch, gen_len)
        self._sync()
        return time.perf_counter() - t0

    @torch.inference_mode()
    def timed_decode(self, batch, steps: int) -> float:
        """Steady-state decode seconds for ``steps`` tokens, the prefill
        outside the clock and the clock stopped after a device
        synchronise.  An overlap engine times the overlapped executor, the
        path ``generate`` takes.  Warm up first."""
        batch = as_batch(batch, self._stage_device(0))
        prompt_len = batch["tokens"].shape[1]
        self._check_fit(prompt_len, steps + 1)
        cur = prompt_len
        if self.overlap:
            mbs = self._split_batch(
                batch, self._resolve_micro(batch["tokens"].shape[0]))
            toks, _, caches = self._overlap_prefill(mbs)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                toks, _, caches = self._overlap_step(
                    toks, caches, self.bucket_for(cur + 1))
                cur += 1
        else:
            caches = self._batch_caches(batch)
            toks, _ = self._chain_prefill(batch, caches)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                toks, _ = self._chain_decode(toks, caches,
                                             self.bucket_for(cur + 1))
                cur += 1
        self._sync()
        return time.perf_counter() - t0
