"""Slot-based continuous batching over a ServeEngine.

Counterpart of ``repro/serve/scheduler.py`` for the monolithic engine.  A
fixed bank of ``slots`` batch rows shares one cache.  Requests are admitted
into free slots in arrival order (prefill runs per request at its exact
prompt length, so no prompt is padded), decode advances every slot in one
batched step, and finished requests are evicted so waiting requests can
reuse the slot.

Token identity: each slot's attention sees only its own rows (per-slot
lengths mask the kv cache, per-slot positions drive RoPE) and each slot's
SSM state is its own, so a request decoded in a mixed batch emits the same
greedy tokens as the same request decoded alone.  On the card every
product and reduction of a decode step runs in the row-invariant decode
kernels (``kernels.decode``), whose bits for a row depend neither on the
other rows nor on their number, so each decode step's logits equal the
request's alone bit for bit (``chip_smoke.py`` checks it); the CPU's plain
matmuls may round a row by the row count, so there the tokens are what
is held identical.

Inactive slots keep stepping, as the reference's do (the batch shape is
fixed): each feeds back its own last token and its lengths grow by one a
step, past ``max_len`` if it idles long enough.  There its decode writes
land nowhere and its attention reads the keys the bucket holds, as the
reference's out-of-bounds scatter is dropped and its slice of the cache
bounds the keys (``models.layers``).  Their outputs are never recorded.
Admission scatters a batch-1 cache into the bank at offset 0 along every
axis but the batch axis; stale rows past the new request's length are
masked by its length until overwritten.

A request of the VLM brings its own vision embeddings, one of the
encoder-decoder its own frames (``Request.extras``); admission fills the
slot's cross caches from them, and every decode step reads each slot's
own.  The encoder-decoder's requests must share one frames length: the
bank's cross caches have one shape.

Like the engine's, the decode loop never reads a device value (an
admission's prefill reads its fresh cache's length once): the schedule
depends only on the known prompt and generation lengths, and every token
comes back to the host once, at the end.

The same bookkeeping drives a ``PipelineServeEngine`` (continuous
batching across its stages): the engine keeps a cache bank a stage
(``slot_bank``), admits a request through every stage (``admit_slot``),
steps the banks through its sequential chain (``bank_step``; also under
``overlap``, where only the admissions are paced: ``admit_burst``), and
after a stage kill or a live replan re-creates the moved stages' banks
and replays every in-flight request into its slot (``recover_and_replay``,
``migrate_and_replay``).  The schedule here is the same either way, so a
pipelined stream is token-identical to the monolithic one.

Except for the MoE family, a slot's rows never influence the other slots.
A MoE model's rows are coupled by expert capacity: a row's entries compete
with the others' for each expert's ``cap`` places (the idle slots' rows
too), so a MoE request's tokens depend on what the other slots hold and a
stream need not equal its requests served alone; the reference pins no
MoE stream.  The idle slots stepping as the reference's is what lets a MoE
stream equal the reference's stream of the same requests.  A replay after
a restore serves each in-flight request alone, as the reference's does,
so a MoE stream with a kill need not equal the stream without it.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.models import decode_step, init_serve_cache, prefill

from .banks import insert_slot, kill_specs, leaf_batch_axes
from .engine import as_batch
from .pipeline import PipelineServeEngine


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens (1, S) int + a fixed greedy
    generation budget.  extras: per-request modal inputs with leading dim
    1 (vlm: ``vision``; encdec: ``frames``, one length for every request
    of a stream), numpy (bf16 as ``ml_dtypes.bfloat16``) or tensors."""
    rid: int
    tokens: np.ndarray
    gen_len: int
    extras: dict | None = None


def _meta_batch(extras, b):
    """Side inputs shaped like ``extras`` (leading dim 1) for ``b`` rows,
    on the meta device: what sizes a cache."""
    return {k: torch.empty((b, *v.shape[1:]), device="meta")
            for k, v in extras.items()}


class SlotScheduler:
    """Continuous batching: admit/evict requests into ``slots`` cache rows
    of a ``ServeEngine`` or, a bank a stage, of a ``PipelineServeEngine``."""

    def __init__(self, engine, slots: int):
        self.engine = engine
        self.slots = int(slots)
        self._batch_axes = None

    def _leaf_batch_axes(self, proto=None):
        """Each cache leaf's batch axis, from caches shaped on the meta
        device by a batch like ``proto`` (its side inputs' shapes)."""
        cfg, ml = self.engine.cfg, self.engine.max_len
        return leaf_batch_axes(lambda b: init_serve_cache(
            cfg, b, ml, batch=_meta_batch(proto or {}, b), device="meta"))

    def _admit(self, batch, cache, slot_tokens, slot):
        """Prefill one request (its tokens and side input, on the device)
        into a batch-1 cache of its prompt length, scatter it into ``slot``
        of the bank, and put its first token in ``slot_tokens`` (a new
        tensor: the old one holds a recorded step).  Returns (first token
        (1, 1), slot_tokens)."""
        eng = self.engine
        c1 = init_serve_cache(eng.cfg, 1, batch["tokens"].shape[1],
                              batch=batch, device=eng.device)
        logits, c1 = prefill(eng.cfg, eng.params, batch, c1)
        tok = logits.argmax(-1).int()
        insert_slot(cache, c1, slot, self._batch_axes)
        slot_tokens = slot_tokens.clone()
        slot_tokens[slot] = tok[0]
        return tok, slot_tokens

    @torch.inference_mode()
    def run(self, requests: list[Request], engine: str = "fast",
            kill: dict | list | None = None, replan: dict | None = None):
        """Serve ``requests`` to completion; returns (streams, stats) with
        streams[i] the i-th request's np int32 greedy tokens (gen_len,).

        ``engine="reference"`` serves each request alone (through
        ``ServeEngine.generate(..., engine="reference")``, or the pipeline
        engine's ``generate``): the oracle the slot path must match.

        kill: a ``PipelineServeEngine``'s ``{"after_step": s, "stage":
        k}`` or a list of such specs (``"replica"``: the copy node;
        ``"silent"``: the primary goes dark for the heartbeat monitor to
        find): stage ``k`` loses a copy once ``s`` batched decode steps
        are done.  A copy with survivors costs no restore; a stage's last
        copy is restored from its checkpoint and every in-flight request
        replayed into its slot.

        replan: a ``PipelineServeEngine``'s ``{"after_step": s,
        "cluster": state, ...}`` (optional ``max_moves``, ``min_gain_s``,
        ``allow_replicas``): after ``s`` batched decode steps,
        ``replan_live`` runs and the in-flight requests are replayed into
        the banks of the stages whose primary moved.  The streams equal an
        undisturbed run's either way."""
        eng = self.engine
        pipeline = isinstance(eng, PipelineServeEngine)
        if engine not in ("fast", "reference"):
            raise ValueError(engine)
        if not pipeline and (kill is not None or replan is not None):
            raise ValueError("kill and replan need a PipelineServeEngine")
        if not requests:
            return [], {"wall_s": 0.0, "decode_steps": 0,
                        "slot_utilization": 0.0}
        for r in requests:
            eng._check_fit(r.tokens.shape[1], r.gen_len)
        proto = requests[0].extras or {}
        for r in requests:
            extras = r.extras or {}
            if {k: tuple(v.shape) for k, v in extras.items()} != {
                    k: tuple(v.shape) for k, v in proto.items()}:
                raise ValueError(f"request {r.rid}: side inputs "
                                 f"{list(extras)} shaped unlike the first "
                                 "request's: a stream shares one shape")

        if engine == "reference":
            t0 = time.perf_counter()
            alone = (eng.generate if pipeline else functools.partial(
                eng.generate, engine="reference"))
            streams = [alone({"tokens": r.tokens, **(r.extras or {})},
                             r.gen_len)[0] for r in requests]
            stats = {"wall_s": time.perf_counter() - t0, "decode_steps": 0,
                     "slot_utilization": 1.0}
            return streams, stats

        cfg, B = eng.cfg, self.slots
        if pipeline:
            cache = eng.slot_bank(B, proto)
        else:
            self._batch_axes = self._leaf_batch_axes(proto)
            cache = init_serve_cache(cfg, B, eng.max_len, device=eng.device,
                                     batch=_meta_batch(proto, B))
        slot_tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=eng.device)
        tel = getattr(eng, "telemetry", None)

        t0 = time.perf_counter()
        next_idx = 0
        active: dict[int, list] = {}          # slot -> [request, n_emitted]
        free = list(range(B))
        slot_len = np.zeros(B, np.int64)      # host mirror of cache lens
        first_tok: dict[int, torch.Tensor] = {}  # rid -> (1, 1) token
        step_toks: list[torch.Tensor] = []    # per-step (B, 1) tokens
        step_maps: list[dict[int, int]] = []  # per-step slot -> rid
        n_steps = busy = 0
        kills = kill_specs(kill)
        fired = [False] * len(kills)
        replanned = False
        burst = eng.admit_burst() if pipeline else None

        def inflight():
            return [(s, st[0], st[1]) for s, st in sorted(active.items())]

        while next_idx < len(requests) or active:
            admitted = 0
            while free and next_idx < len(requests) and (
                    burst is None or admitted < burst):
                r = requests[next_idx]
                next_idx += 1
                admitted += 1
                slot = free.pop(0)
                batch = as_batch({"tokens": r.tokens, **(r.extras or {})},
                                 eng.device)
                admit = eng.admit_slot if pipeline else self._admit
                first_tok[r.rid], slot_tokens = admit(batch, cache,
                                                      slot_tokens, slot)
                slot_len[slot] = r.tokens.shape[1]
                if r.gen_len > 1:
                    active[slot] = [r, 1]
                else:
                    free.append(slot)
                    free.sort()
            if not all(fired):
                # a copy dies once `after_step` batched decode steps are
                # done (0: right after the first admissions); only a
                # stage's last copy costs a restore, with every in-flight
                # request replayed into its slot
                hit = False
                for i, spec in enumerate(kills):
                    if not fired[i] and n_steps >= spec["after_step"]:
                        fired[i] = hit = True
                        if spec.get("silent"):
                            eng.fail_silent(spec["stage"])
                        else:
                            eng.kill_stage(spec["stage"],
                                           replica=spec.get("replica"))
                if hit and eng.down:
                    cache, slot_tokens = eng.recover_and_replay(
                        inflight(), cache, slot_tokens)
            if (replan is not None and not replanned
                    and n_steps >= replan["after_step"]):
                replanned = True
                res = eng.replan_live(
                    replan["cluster"],
                    max_moves=replan.get("max_moves", 1),
                    min_gain_s=replan.get("min_gain_s", 0.0),
                    allow_replicas=replan.get("allow_replicas", False))
                if res.migrated_stages:
                    cache, slot_tokens = eng.migrate_and_replay(
                        list(res.migrated_stages), inflight(), cache,
                        slot_tokens)
            if not active:
                continue
            if tel is not None:
                tel.record_queue_depth(len(active))
            bucket = eng.bucket_for(
                int(max(slot_len[s] for s in active)) + 1)
            if pipeline:
                slot_tokens, _, cache = eng.bank_step(slot_tokens, cache,
                                                      bucket, inflight())
            else:
                logits, cache = decode_step(cfg, eng.params, slot_tokens,
                                            cache, kv_bucket=bucket)
                slot_tokens = logits.argmax(-1).int()
            slot_len += 1                  # every row writes, active or not
            n_steps += 1
            busy += len(active)
            step_toks.append(slot_tokens)
            step_maps.append({s: st[0].rid for s, st in active.items()})
            for slot in list(active):
                active[slot][1] += 1
                if active[slot][1] >= active[slot][0].gen_len:
                    del active[slot]
                    free.append(slot)
            free.sort()

        # one host read: every step's tokens and every first token at once
        stacked = (torch.cat(step_toks, dim=1).cpu().numpy() if step_toks
                   else np.zeros((B, 0), np.int32))
        firsts = torch.cat([first_tok[r.rid].to(eng.device)
                            for r in requests]).view(-1)
        firsts = firsts.cpu().numpy()
        streams = {r.rid: [int(firsts[i])] for i, r in enumerate(requests)}
        for i, m in enumerate(step_maps):
            for slot, rid in m.items():
                streams[rid].append(int(stacked[slot, i]))
        stats = {"wall_s": time.perf_counter() - t0,
                 "decode_steps": n_steps,
                 "slot_utilization": busy / max(1, n_steps * B)}
        return [np.asarray(streams[r.rid], np.int32) for r in requests], stats
