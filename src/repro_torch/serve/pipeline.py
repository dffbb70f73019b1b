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

Not ported here: the reference's overlapped executor (micro-batches,
per-stage devices, the fused decode chain) and its slot-bank scheduler
integration.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                    template_of)
from repro_torch.core.replan import ReplicaAdd, incremental_replan
from repro_torch.kernels.quantize.ops import (rowwise_dequantize,
                                              rowwise_quantize)
from repro_torch.models import staging
from repro_torch.models.layers import dtype_of

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
    """

    def __init__(self, cfg, params, plan, *, max_len: int, kv_block: int = 32,
                 ckpt_dir=None, cluster=None, telemetry=None, retry=None,
                 transport=None, monitor=None):
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
        self.stage_params = [
            staging.extract_stage_params(cfg, params, lo, hi, k == 0,
                                         k == last)
            for k, (lo, hi) in enumerate(self.ranges)]
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
        (through the transport when one is attached, the payload rebuilt
        on the receiving stage's device from the received bytes)."""
        if self.monitor is not None:
            self.monitor.beat(k)
        if k < self.n_stages - 1 and self.transport is not None:
            x = self.transport.send(k, x, device=self.device)
        return x

    def _chain_prefill(self, batch, caches):
        """Prefill through every stage, each given its side input: the
        VLM's vision embeddings, or the encoder output that the first stage
        computes from the frames (a replay computes it again)."""
        x = batch["tokens"]
        side = None
        if self.cfg.family == "vlm":
            side = {"vision": batch["vision"]}
        for k in range(self.n_stages):
            self._pre_stage(k)
            self._route(k)
            if k == 0 and self.cfg.family == "encdec":
                side = {"enc_out": staging.encode(
                    self.cfg, self.stage_params[0], batch["frames"])}
            x = self._stage_step(k, x, caches[k], prefill=True, side=side)
            x = self._post_stage(k, x)
        return x

    def _chain_decode(self, toks, caches, bucket):
        x = toks
        tel = self.telemetry
        for k in range(self.n_stages):
            self._pre_stage(k)
            self._route(k)
            if tel is None:
                x = self._stage_step(k, x, caches[k], bucket, prefill=False)
                x = self._post_stage(k, x)
                continue
            t0 = tel.now()
            x = self._stage_step(k, x, caches[k], bucket, prefill=False)
            t1 = tel.now()
            # the telemetry sample waits for the stage's work on the card
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = tel.now()
            tel.record_decode(k, t2 - t0)
            if k < self.n_stages - 1:
                # boundary materialization time stands in for the wire hop
                tel.record_transfer(k, self._payload_bytes(x), t2 - t1)
            x = self._post_stage(k, x)
        return x

    @staticmethod
    def _payload_bytes(x) -> float:
        leaves = x if isinstance(x, tuple) else (x,)
        return float(sum(t.numel() * t.element_size() for t in leaves))

    def _fresh_caches(self, b, enc_len=None):
        """Empty stage caches for ``b`` rows (the encoder-decoder's cross
        caches of ``enc_len`` rows, the frames' length)."""
        return [staging.init_stage_cache(self.cfg, lo, hi, b, self.max_len,
                                         device=self.device, enc_len=enc_len)
                for lo, hi in self.ranges]

    def _batch_caches(self, batch):
        """Empty stage caches for a request batch."""
        return self._fresh_caches(
            batch["tokens"].shape[0],
            batch["frames"].shape[1] if "frames" in batch else None)

    # -- synchronized-batch generation with deterministic fault injection ---

    @torch.inference_mode()
    def generate(self, batch, gen_len: int, *, kill=None, replan=None):
        """Greedy-decode a synchronized batch for ``gen_len`` tokens
        through the stage pipeline; np tokens (B, gen_len) int32.

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
        batch = as_batch(batch, self.device)
        b, prompt_len = batch["tokens"].shape
        self._check_fit(prompt_len, gen_len)
        kills = ([] if kill is None
                 else [kill] if isinstance(kill, dict) else list(kill))
        for k in sorted(self.down):        # e.g. killed between calls
            self.restore_stage(k)
        caches = self._batch_caches(batch)
        while True:
            try:
                toks, _ = self._chain_prefill(batch, caches)
                break
            except StageDown:      # silent failure confirmed mid-prefill
                for k in sorted(self.down):
                    self.restore_stage(k)
                caches = self._batch_caches(batch)
        outs = [toks]
        cur = prompt_len
        for step in range(gen_len - 1):
            for spec in kills:
                if spec["after_step"] == step:
                    if spec.get("silent"):
                        self.fail_silent(spec["stage"])
                    else:
                        self.kill_stage(spec["stage"],
                                        replica=spec.get("replica"))
            if self.down:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks, caches = self._replay_sync(batch, step)
            if replan is not None and replan["after_step"] == step:
                res = self.replan_live(
                    replan["cluster"],
                    max_moves=replan.get("max_moves", 1),
                    min_gain_s=replan.get("min_gain_s", 0.0))
                if res.changed:
                    toks, caches = self._replay_sync(batch, step)
            toks, caches = self._decode_step_checked(batch, toks, caches,
                                                     step, cur)
            cur += 1
            outs.append(toks)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    def _decode_step_checked(self, batch, toks, caches, step, cur):
        """One decode step with silent-failure recovery: a
        :class:`StageDown` raised mid-chain (a silent stage the heartbeat
        monitor just confirmed DEAD) restores every down stage, replays the
        in-flight batch to ``step`` completed decode steps, and retries.
        The replay builds fresh caches, so the ones the aborted chain
        updated are never read again."""
        while True:
            try:
                t, _ = self._chain_decode(toks, caches,
                                          self.bucket_for(cur + 1))
                return t, caches
            except StageDown:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks, caches = self._replay_sync(batch, step)

    def _replay_sync(self, batch, steps_done):
        """Replay the in-flight batch after a restore or migration: fresh
        caches,
        prefill (every stage gets its side input again), and the
        ``steps_done`` decode steps already emitted
        (greedy decoding is deterministic, so the replay rebuilds the lost
        stage state exactly)."""
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
        """Stage ``k``'s checkpoint read onto the engine's device under
        bounded retry (a corrupt leaf, ``CheckpointCorrupt``, is a
        ``ValueError``: retried)."""
        return retry_call(
            lambda: restore_checkpoint(self.ckpt_dir / f"stage_{k}", 0,
                                       self._templates[k],
                                       device=self.device),
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
        self.stage_params[k] = restored
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
        self.stage_params[k] = restored
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
