"""Plan-faithful pipelined serving with fault-tolerant stage replacement.

Counterpart of ``repro/serve/pipeline.py`` (the sequential engine).
``PipelineServeEngine`` executes a ``StageExecutionPlan``
(``repro_torch.core.stageplan``): the params are split into per-stage
subtrees (``models.staging``), each stage runs its own prefill and bucketed
greedy decode, and the activation at each stage boundary is handed to the
next stage explicitly — as is, or rowwise-int8 on the wire when
``plan.compression.wire_bits == 8`` (the paper's lambda compression,
executed by the quantize and dequantize kernels).

**Token identity.**  A chain of stages runs the same op sequence as the
monolithic model, so through a raw wire its greedy tokens are bit-identical
to ``ServeEngine``'s, across a mid-stream stage kill and restore too.  The
int8 wire is lossy, so there the contract is that a run with a kill gives
the same tokens as the same run without it.

**MoE.**  A stage holds whole groups (``staging``); the batch goes
through each stage as one, so routing (whose expert capacity couples the
rows) sees the rows the monolithic model sees, in a replay too.  The
reference's overlapped executor never splits a MoE batch into
micro-batches for that reason (``repro/serve/pipeline.py``,
``_resolve_micro``); that executor is not ported yet.

**Side inputs.**  Every VLM stage reads the request's vision embeddings,
and the encoder-decoder's first stage encodes the frames and ships the
encoder output to every later stage, once per request (the planner's
``side_in_bytes``).  Each stage fills its own cross caches from them at
prefill.  Side inputs travel raw on both wires: only the residual
boundary goes through the int8 wire, as in the reference.

**Fault tolerance.**  At construction every stage's param subtree is
checkpointed (``repro_torch.checkpoint``, the NFS analogue); a hybrid
stage that holds a call site of the shared attention block checkpoints its
own copy of that block, as the plan charges it, and gets it back on
restore.
``kill_stage`` drops a stage's params (everything a dead node loses);
``restore_stage`` reads them back from the checkpoint onto a spare node —
the best by bandwidth to the pipeline neighbours when a cluster is given —
and the in-flight batch is replayed: greedy decoding is deterministic, so
the replay rebuilds the lost caches exactly and the stream continues
unchanged.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                    template_of)
from repro_torch.kernels.quantize.ops import (rowwise_dequantize,
                                              rowwise_quantize)
from repro_torch.models import staging
from repro_torch.models.layers import dtype_of

from .engine import ServeEngine, as_batch


class StageDown(RuntimeError):
    """A dead stage was asked to compute, or has no spare to restore
    onto."""


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
    """

    def __init__(self, cfg, params, plan, *, max_len: int, kv_block: int = 32,
                 ckpt_dir=None, cluster=None):
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
        self.spares = list(plan.spare_nodes)
        self.cluster = cluster
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

    def _chain_prefill(self, batch, caches):
        """Prefill through every stage, each given its side input: the
        VLM's vision embeddings, or the encoder output that the first stage
        computes from the frames (a replay computes it again)."""
        x = batch["tokens"]
        side = None
        if self.cfg.family == "vlm":
            side = {"vision": batch["vision"]}
        for k in range(self.n_stages):
            self._require_up(k)
            if k == 0 and self.cfg.family == "encdec":
                side = {"enc_out": staging.encode(
                    self.cfg, self.stage_params[0], batch["frames"])}
            x = self._stage_step(k, x, caches[k], prefill=True, side=side)
        return x

    def _chain_decode(self, toks, caches, bucket):
        x = toks
        for k in range(self.n_stages):
            self._require_up(k)
            x = self._stage_step(k, x, caches[k], bucket, prefill=False)
        return x

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
    def generate(self, batch, gen_len: int, *, kill=None):
        """Greedy-decode a synchronized batch for ``gen_len`` tokens
        through the stage pipeline; np tokens (B, gen_len) int32.

        kill: optional ``{"after_step": s, "stage": k}`` — or a list of such
        specs — stage ``k`` dies after ``s`` completed decode steps (0 =
        right after prefill); the engine restores it onto a spare and
        replays the in-flight batch before continuing, so the stream is
        identical to an undisturbed run."""
        batch = as_batch(batch, self.device)
        b, prompt_len = batch["tokens"].shape
        self._check_fit(prompt_len, gen_len)
        kills = ([] if kill is None
                 else [kill] if isinstance(kill, dict) else list(kill))
        for k in sorted(self.down):        # e.g. killed between calls
            self.restore_stage(k)
        caches = self._batch_caches(batch)
        toks, _ = self._chain_prefill(batch, caches)
        outs = [toks]
        cur = prompt_len
        for step in range(gen_len - 1):
            for spec in kills:
                if spec["after_step"] == step:
                    self.kill_stage(spec["stage"])
            if self.down:
                for k in sorted(self.down):
                    self.restore_stage(k)
                toks, caches = self._replay_sync(batch, step)
            toks, _ = self._chain_decode(toks, caches,
                                         self.bucket_for(cur + 1))
            cur += 1
            outs.append(toks)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    def _replay_sync(self, batch, steps_done):
        """Replay the in-flight batch after a restore: fresh caches,
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

    def kill_stage(self, k: int) -> None:
        """Kill stage ``k``'s node: its params and caches are lost until
        :meth:`restore_stage` brings it back from the checkpoint."""
        self._require_up(k)
        self.down.add(k)
        self.stage_params[k] = None
        self._note(f"node {self.node_of_stage[k]} FAILED (stage {k})")

    def _spare_score(self, k: int, n: int) -> float:
        """The emulator's reschedule score: bandwidth to the neighbours."""
        prev = (self.plan.dispatcher_node if k == 0
                else self.node_of_stage[k - 1])
        s = self.cluster.bw[prev, n]
        if k < self.n_stages - 1:
            s += self.cluster.bw[n, self.node_of_stage[k + 1]]
        return s

    def _acquire_spare(self, k: int) -> int:
        """The spare node stage ``k`` would restore onto (not yet removed
        from the pool); StageDown when the pool is empty."""
        if not self.spares:
            raise StageDown(f"stage {k}: no spare node to restore onto")
        if self.cluster is None:
            return self.spares[0]
        return max(self.spares, key=lambda n: self._spare_score(k, n))

    def restore_stage(self, k: int) -> None:
        """Restore stage ``k``'s params from its checkpoint onto a spare
        node.  The checkpoint is read once; a failed read leaves the stage
        down and the spare pool untouched."""
        if k not in self.down:
            return
        target = self._acquire_spare(k)
        self.stage_params[k] = restore_checkpoint(
            self.ckpt_dir / f"stage_{k}", 0, self._templates[k],
            device=self.device)
        self.spares.remove(target)
        old = self.node_of_stage[k]
        self.node_of_stage[k] = target
        self.down.discard(k)
        self._note(f"stage {k}: pod rescheduled {old} -> {target} "
                   "(params restored from checkpoint)")
