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

Inactive slots keep stepping with garbage rows (the batch shape is fixed);
their outputs are never recorded and their rows never influence other
slots.  An inactive row writes its kv at its own length, so a slot that
stays idle long enough would write past the end of the cache (the
reference clamps that write); here its lengths go back to 0 first, which
changes no active row.  Admission scatters a batch-1 cache into the bank
at offset 0 along every axis but the batch axis; stale rows past the new
request's length are masked by its length until overwritten.

A request of the VLM brings its own vision embeddings, one of the
encoder-decoder its own frames (``Request.extras``); admission fills the
slot's cross caches from them, and every decode step reads each slot's
own.  The encoder-decoder's requests must share one frames length: the
bank's cross caches have one shape.

Like the engine's, the decode loop never reads a device value (an
admission's prefill reads its fresh cache's length once): the schedule
depends only on the known prompt and generation lengths, and every token
comes back to the host once, at the end.  Continuous batching across the stages of a
``PipelineServeEngine`` is not ported yet; ``run`` refuses one.

A MoE model is refused (``MOE_REFUSAL``).  Expert capacity couples the
rows of a batch: a row's entries compete with the others' for each
expert's ``cap`` slots, so the reference pins no MoE stream.  Here the
idle slots' garbage rows differ from the reference's too (their lengths
go back to 0 rather than being clamped), so they would contend for
capacity differently again.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.models import decode_step, init_serve_cache, prefill

from .engine import ServeEngine, as_batch


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


def leaf_batch_axes(shapes):
    """Per-leaf batch-axis index from a ``shapes(batch_size)`` callable
    returning a cache tree: the one axis where a batch-1 and a batch-2
    cache disagree."""
    return tree_map(
        lambda a, b: int(np.argmax(np.array(a.shape) != np.array(b.shape))),
        shapes(1), shapes(2))


def _insert_leaf(full, one, slot, b_ax):
    """Scatter a single-request cache leaf into slot ``slot`` of the bank,
    in place: ``one``'s full extent at offset 0 on every axis except the
    batch axis (kv rows [0, S1), and per-slot state, conv buffers and
    length counters whole)."""
    src = one.select(b_ax, 0)
    full.select(b_ax, slot)[tuple(slice(0, n) for n in src.shape)].copy_(
        src)


def _meta_batch(extras, b):
    """Side inputs shaped like ``extras`` (leading dim 1) for ``b`` rows,
    on the meta device: what sizes a cache."""
    return {k: torch.empty((b, *v.shape[1:]), device="meta")
            for k, v in extras.items()}


def _zero_lens(cache, axes, slot):
    """Every length counter of slot ``slot`` back to 0, in place (cross
    caches have none)."""
    for key, leaf in cache.items():
        if isinstance(leaf, dict):
            _zero_lens(leaf, axes[key], slot)
        elif key == "len":
            leaf.select(axes[key], slot).zero_()


MOE_REFUSAL = (
    "SlotScheduler does not serve the MoE family: expert capacity couples "
    "the rows of a batch (a request's routing depends on the other slots' "
    "rows, so the reference pins no MoE stream), and the idle slots' rows "
    "here differ from the reference's (lengths reset, not clamped), so "
    "they would contend for capacity differently")


class SlotScheduler:
    """Continuous batching: admit/evict requests into ``slots`` cache rows
    of a monolithic ``ServeEngine``."""

    def __init__(self, engine, slots: int):
        if engine.cfg.family == "moe":
            raise NotImplementedError(MOE_REFUSAL)
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
        tree_map(lambda full, one, ax: _insert_leaf(full, one, slot, ax),
                 cache, c1, self._batch_axes)
        slot_tokens = slot_tokens.clone()
        slot_tokens[slot] = tok[0]
        return tok, slot_tokens

    @torch.inference_mode()
    def run(self, requests: list[Request], engine: str = "fast"):
        """Serve ``requests`` to completion; returns (streams, stats) with
        streams[i] the i-th request's np int32 greedy tokens (gen_len,).

        ``engine="reference"`` serves each request alone through
        ``ServeEngine.generate(..., engine="reference")``: the oracle the
        slot path must match."""
        eng = self.engine
        if not isinstance(eng, ServeEngine):
            raise NotImplementedError(
                "SlotScheduler over a pipeline engine is not ported yet; "
                "give it a ServeEngine")
        if engine not in ("fast", "reference"):
            raise ValueError(engine)
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
            streams = [eng.generate({"tokens": r.tokens, **(r.extras or {})},
                                    r.gen_len, engine="reference")[0]
                       for r in requests]
            stats = {"wall_s": time.perf_counter() - t0, "decode_steps": 0,
                     "slot_utilization": 1.0}
            return streams, stats

        cfg, B = eng.cfg, self.slots
        self._batch_axes = self._leaf_batch_axes(proto)
        cache = init_serve_cache(cfg, B, eng.max_len, device=eng.device,
                                 batch=_meta_batch(proto, B))
        slot_tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=eng.device)

        t0 = time.perf_counter()
        next_idx = 0
        active: dict[int, list] = {}          # slot -> [request, n_emitted]
        free = list(range(B))
        slot_len = np.zeros(B, np.int64)      # host mirror of cache lens
        first_tok: dict[int, torch.Tensor] = {}  # rid -> (1, 1) token
        step_toks: list[torch.Tensor] = []    # per-step (B, 1) tokens
        step_maps: list[dict[int, int]] = []  # per-step slot -> rid
        n_steps = busy = 0
        while next_idx < len(requests) or active:
            while free and next_idx < len(requests):
                r = requests[next_idx]
                next_idx += 1
                slot = free.pop(0)
                first_tok[r.rid], slot_tokens = self._admit(
                    as_batch({"tokens": r.tokens, **(r.extras or {})},
                             eng.device), cache, slot_tokens, slot)
                slot_len[slot] = r.tokens.shape[1]
                if r.gen_len > 1:
                    active[slot] = [r, 1]
                else:
                    free.append(slot)
                    free.sort()
            if not active:
                continue
            for slot in range(B):     # an idle row about to write past the end
                if slot not in active and slot_len[slot] >= eng.max_len:
                    _zero_lens(cache, self._batch_axes, slot)
                    slot_len[slot] = 0
            bucket = eng.bucket_for(
                int(max(slot_len[s] for s in active)) + 1)
            logits, cache = decode_step(cfg, eng.params, slot_tokens, cache,
                                        kv_bucket=bucket)
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
        firsts = torch.cat([first_tok[r.rid] for r in requests]).view(-1)
        firsts = firsts.cpu().numpy()
        streams = {r.rid: [int(firsts[i])] for i, r in enumerate(requests)}
        for i, m in enumerate(step_maps):
            for slot, rid in m.items():
                streams[rid].append(int(stacked[slot, i]))
        stats = {"wall_s": time.perf_counter() - t0,
                 "decode_steps": n_steps,
                 "slot_utilization": busy / max(1, n_steps * B)}
        return [np.asarray(streams[r.rid], np.int32) for r in requests], stats
