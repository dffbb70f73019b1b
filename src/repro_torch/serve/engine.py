"""Monolithic greedy serving engine (the reference the pipeline is held to).

Counterpart of ``repro/serve/engine.py``.  Two loops over the same model
functions:

* ``fast`` — the cache is preallocated once and updated in place, decode
  attention is given only the filled prefix rounded up to ``kv_block``
  rows (``kv_bucket``), greedy argmax stays on the device and feeds the
  next step, and the decode loop never reads a device value (the prefill
  reads the fresh cache's length once, where its k/v go): tokens come back
  to the host once, at the end.
* ``reference`` — the same steps with ``kv_bucket=None`` (attention over
  the whole cache).

Both give the same greedy tokens.  On the card they also give the same
logits bit for bit: the decode-attention kernel reads each row's own keys
whatever the bucket (``kernels.decode``).  MLA (deepseek-v3) has no such
kernel: its plain attention reads the whole cache, masked by each row's
length, in both loops and ignores the bucket, since plain reductions over
a bucket and over the whole cache need not round alike
(``layers.mla_attention``).  The MoE dispatch and its combine have no
atomics, so they repeat bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import decode_step, init_serve_cache, prefill
from repro_torch.models.bridge import tensor_from_numpy


def make_batch(cfg, b: int, s: int, seed: int, *,
               frames_len: int | None = None) -> dict:
    """A synthetic request batch from a numpy seed: uniform random prompt
    tokens (B, S), and the family's side input, standard normal in bf16
    (numpy ``ml_dtypes.bfloat16``) shaped as the reference's
    ``serve.equivalence.make_batch`` shapes it: the VLM's ``vision`` (B,
    vision_tokens, D), the encoder-decoder's ``frames`` (B, S, D), or (B,
    ``frames_len``, D) when given."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int64)}
    side = {"vlm": ("vision", cfg.vision_tokens),
            "encdec": ("frames", frames_len or s)}.get(cfg.family)
    if side is not None:
        import ml_dtypes    # numpy's bfloat16
        batch[side[0]] = rng.standard_normal(
            (b, side[1], cfg.d_model), dtype=np.float32).astype(
            ml_dtypes.bfloat16)
    return batch


def as_batch(batch, device):
    """A request batch with its tensors on ``device`` (numpy accepted,
    ``ml_dtypes.bfloat16`` arrays as bf16 tensors)."""
    return {k: tensor_from_numpy(v, device) if isinstance(v, np.ndarray)
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


class ServeEngine:
    """Greedy serving over one model.

    cfg/params : the model (any ported family); params live on one device,
                 and the engine serves there.
    max_len    : cache capacity per sequence; every request must satisfy
                 prompt_len + gen_len - 1 <= max_len.
    kv_block   : decode-attention bucket granularity (rows).
    """

    def __init__(self, cfg, params, *, max_len: int, kv_block: int = 32):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_len = int(max_len)
        self.kv_block = int(kv_block)

    def bucket_for(self, filled: int) -> int:
        """Smallest kv_block multiple covering `filled` rows (<= max_len)."""
        b = -(-filled // self.kv_block) * self.kv_block
        return min(max(b, self.kv_block), self.max_len)

    def _check_fit(self, prompt_len: int, gen_len: int) -> None:
        if prompt_len + gen_len - 1 > self.max_len:
            raise ValueError(
                f"prompt {prompt_len} + gen {gen_len} - 1 exceeds "
                f"max_len {self.max_len}")

    @torch.inference_mode()
    def generate(self, batch, gen_len: int, engine: str = "fast",
                 collect_logits: bool = False):
        """Greedy-decode a synchronized batch for `gen_len` tokens (the
        batch holds the family's side input beside ``tokens``).

        Returns np tokens (B, gen_len) int32 — or (tokens, logits
        (B, gen_len, V) float32) when collect_logits."""
        if engine not in ("fast", "reference"):
            raise ValueError(engine)
        batch = as_batch(batch, self.device)
        prompt_len = batch["tokens"].shape[1]
        self._check_fit(prompt_len, gen_len)
        toks, logits, cache = self._start(batch)
        outs, logs = [toks], [logits]
        cur = prompt_len
        for _ in range(gen_len - 1):
            bucket = self.bucket_for(cur + 1) if engine == "fast" else None
            logits, cache = decode_step(self.cfg, self.params, toks, cache,
                                        kv_bucket=bucket)
            toks = logits.argmax(-1).int()
            cur += 1
            outs.append(toks)
            if collect_logits:
                logs.append(logits)
        out = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
        if collect_logits:
            return out, torch.cat(logs, dim=1).cpu().numpy()
        return out

    # -- timing helpers ------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch, gen_len: int, engine: str = "fast") -> float:
        """One throwaway ``generate`` (the kernels' builds and first
        launches); its wall seconds, ending in a device synchronise."""
        t0 = time.perf_counter()
        self.generate(batch, gen_len, engine=engine)
        self._sync()
        return time.perf_counter() - t0

    def _start(self, batch):
        """A prefill into a fresh cache: (tokens (B, 1), logits, cache)."""
        b = batch["tokens"].shape[0]
        cache = init_serve_cache(self.cfg, b, self.max_len, batch=batch,
                                 device=self.device)
        logits, cache = prefill(self.cfg, self.params, batch, cache)
        return logits.argmax(-1).int(), logits, cache

    @torch.inference_mode()
    def timed_decode(self, batch, steps: int, engine: str = "fast") -> float:
        """Steady-state decode seconds for ``steps`` greedy tokens: the
        prefill runs outside the clock, and the clock stops after a device
        synchronise (launches return before the card finishes).  Warm up
        first."""
        batch = as_batch(batch, self.device)
        prompt_len = batch["tokens"].shape[1]
        self._check_fit(prompt_len, steps + 1)
        toks, _, cache = self._start(batch)
        self._sync()
        cur = prompt_len
        t0 = time.perf_counter()
        for _ in range(steps):
            bucket = self.bucket_for(cur + 1) if engine == "fast" else None
            logits, cache = decode_step(self.cfg, self.params, toks, cache,
                                        kv_bucket=bucket)
            toks = logits.argmax(-1).int()
            cur += 1
        self._sync()
        return time.perf_counter() - t0

    @torch.inference_mode()
    def timed_prefill(self, batch, reps: int = 1) -> float:
        """Seconds a prefill (the cache's allocation included), each rep
        ending in a device synchronise."""
        batch = as_batch(batch, self.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            self._start(batch)
            self._sync()
        return (time.perf_counter() - t0) / reps
