"""Per-stage views of the model (the model half of pipelined serving).

Counterpart of ``repro/models/staging.py``.  A pipeline stage owns a
contiguous block range ``[lo, hi)``, plus the embedding (and the
encoder-decoder's encoder) when it is the first stage and the final norm
and LM head when it is the last.  A chain of stages runs the same op
sequence as the monolithic model, so greedy tokens through a raw wire are
bit-identical to ``ServeEngine``'s.

Family notes:

* dense / ssm — any cut between blocks.
* hybrid (zamba2) — the shared attention params ride along into *every*
  stage that holds a call site of them (a cut between call sites
  duplicates the shared weights, as the partitioner's omega charges them),
  and the shared kv cache is sliced per stage by call-site index.
* vlm (llama-3.2-vision) — cuts fall on group boundaries
  (``cross_attn_every + 1`` blocks): a stage holds whole groups, and every
  stage fills its cross caches from the vision embeddings, a side input
  each stage receives.
* moe (deepseek-v3, llama4-maverick) — cuts fall on group boundaries
  (``moe_interleave`` blocks: llama4's dense block and its MoE block stay
  together); a stage's MLA caches (``ckv``, ``krope``) are its own groups'.
  deepseek-v3's multi-token-prediction weights go to no stage: serving
  never runs them.
* encdec (whisper) — the encoder (``frontend``, ``enc_blocks``,
  ``enc_norm``) runs with the first stage, whatever its decoder blocks (a
  plan that cuts inside the planner's encoder layers gives a block-free
  first stage that runs the whole encoder); its output is a side input
  shipped to every later stage once per request, where it fills that
  stage's cross caches at prefill.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map

from .config import ModelConfig
# a stage fills its own cross caches at prefill from its side input
# (``side["vision"]``, or ``side["enc_out"]`` shipped by the first stage)
from .model import (_backbone, _cache_len, _init_cache, embed_tokens, encode,
                    family, fill_cross_caches, hybrid_apps as _hybrid_apps,
                    lm_logits)


def stage_granularity(cfg: ModelConfig) -> int:
    """Smallest block count a stage boundary must align to (the VLM's and
    the MoE family's group, 1 for the other families)."""
    fam = family(cfg)
    if fam == "moe":
        return cfg.moe_interleave
    if fam == "vlm":
        return cfg.cross_attn_every + 1
    return 1


def check_stage_ranges(cfg: ModelConfig, ranges) -> None:
    g = stage_granularity(cfg)
    for lo, hi in ranges:
        if lo % g or hi % g:
            raise ValueError(
                f"{cfg.name}: stage cut [{lo}, {hi}) not aligned to the "
                f"family's stacking granularity {g}")


def _slice(tree, lo, hi):
    return tree_map(lambda a: a[lo:hi], tree)


def extract_stage_params(cfg: ModelConfig, params, lo: int, hi: int,
                         first: bool, last: bool):
    """The param subtree stage ``[lo, hi)`` needs — and nothing else.

    Leaves are views of ``params`` (no copy).  A tied embedding goes to the
    last stage as well (its head reads it), the hybrid's shared block to
    every stage with a call site in ``[lo, hi)``, the encoder to the first
    stage."""
    fam = family(cfg)
    g = stage_granularity(cfg)
    if fam in ("vlm", "moe"):
        sp = {"groups": _slice(params["groups"], lo // g, hi // g)}
    elif fam == "encdec":
        sp = {"dec_blocks": _slice(params["dec_blocks"], lo, hi)}
        if first:
            for key in ("frontend", "enc_blocks", "enc_norm"):
                sp[key] = params[key]
    else:
        sp = {"blocks": _slice(params["blocks"], lo, hi)}
    if _hybrid_apps(cfg, lo, hi)[1]:
        sp["shared_attn"] = params["shared_attn"]
    if first:
        sp["embed"] = params["embed"]
    if last:
        sp["final_norm"] = params["final_norm"]
        if "lm_head" in params:
            sp["lm_head"] = params["lm_head"]
        else:
            sp["embed"] = params["embed"]      # tied head
    return sp


def init_stage_cache(cfg: ModelConfig, lo: int, hi: int, batch_size: int,
                     max_len: int, *, device, enc_len: int | None = None):
    """Empty decode cache for blocks ``[lo, hi)`` (``{}`` for a block-free
    stage; the hybrid's ``shared`` sized to the call sites inside; the
    encoder-decoder's cross caches to ``enc_len`` rows, the frames'
    length)."""
    if lo == hi:
        return {}
    return _init_cache(cfg, lo, hi, batch_size, max_len, device, enc_len)


def stage_backbone(cfg: ModelConfig, sparams, h, positions, cache, lo: int,
                   hi: int, kv_bucket: int | None = None):
    """Blocks ``[lo, hi)`` applied to ``h`` (cache updated in place): the
    same op sequence the monolithic model runs over those blocks."""
    if lo == hi:
        return h, cache
    return _backbone(cfg, sparams, h, positions, cache, kv_bucket,
                     layer_offset=lo, app_offset=_hybrid_apps(cfg, lo, hi)[0])


def stage_cache_len(cfg: ModelConfig, cache):
    """Current per-row sequence length from a (non-empty) stage cache."""
    return _cache_len(cfg, cache)


def resolve_stage_devices(spec, n_stages: int):
    """A per-stage device assignment: ``None`` (every stage on the params'
    device, the single-node layout), or a list of ``n_stages`` devices.
    ``"auto"`` round-robins the stages over the visible CUDA devices, one
    stage a card, wrapping when stages outnumber cards; it raises where
    there is no card, as ``resolve_device`` does, and never falls back to
    the CPU.  An explicit sequence of devices is cycled the same way."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(f"devices spec must be None, 'auto', or a "
                             f"sequence of devices, got {spec!r}")
        resolve_device("cuda")
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [torch.device(d) for d in spec]
        if not pool:
            raise ValueError("devices sequence is empty")
    return [pool[k % len(pool)] for k in range(n_stages)]


def place_stage_params(sparams, device):
    """One stage's param subtree on its executor's device (stage k's
    weights live where stage k computes); leaves already there are kept,
    not copied."""
    if device is None:
        return sparams
    return tree_map(lambda t: t.to(device), sparams)


__all__ = ["check_stage_ranges", "embed_tokens", "encode",
           "extract_stage_params", "fill_cross_caches", "init_stage_cache",
           "lm_logits", "place_stage_params", "resolve_stage_devices",
           "stage_backbone", "stage_cache_len", "stage_granularity"]
