"""Models of the port: params, forward, and serving steps.

Counterpart of ``repro/models/model.py`` for the dense family, the pure
SSM family (mamba2) and the hybrid family (zamba2: mamba2 blocks with one
weight-shared attention+MLP block applied before every
``hybrid_attn_every``-th of them); the other families are not ported yet
and raise.  Params keep the reference's tree layout, with the blocks
stacked on a leading layer axis (``blocks/attn/wq`` is (L, D, H*hd),
``blocks/in_proj`` (L, D, ...)) and the hybrid's ``shared_attn`` unstacked,
so ``models.bridge`` and the checkpoint map leaf for leaf.  The layer loop
is a Python loop over views of the stacked tensors, and the serving cache
is updated in place.

  init_params(cfg, generator, device=)             -> params
  forward(cfg, params, batch)                      -> (logits, (h, aux))
  init_serve_cache(cfg, batch_size, max_len, device=) -> cache
  prefill(cfg, params, batch, cache)               -> (last logits, cache)
  decode_step(cfg, params, tokens, cache, kv_bucket=) -> (logits, cache)
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.kernels.decode.ops import residual_rms_norm_rows

from .config import ModelConfig
from .layers import (attention, cache_offset, dtype_of, init_attention,
                     init_cache, init_mlp, linear, mlp, ninit, rms_norm)
from .ssm import init_mamba_block, init_mamba_cache, mamba_block

FAMILIES = ("dense", "ssm", "hybrid")


def family(cfg: ModelConfig) -> str:
    """``cfg.family`` when the port has it; raises otherwise."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (have "
            f"{FAMILIES})")
    return cfg.family


def layer_view(tree, i):
    """Layer ``i`` of a stacked tree, as views (writes reach the stack)."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device=None):
    """Random params drawn from ``generator`` (default: seed 0 on the
    target device).  The generator's device is where the draws happen."""
    fam = family(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    elif torch.device(gen.device).type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dt = dtype_of(cfg)
    d, n = cfg.d_model, cfg.n_layers

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def dense_blocks(n_blocks):
        return {"ln1": ones(n_blocks, d),
                "attn": init_attention(gen, cfg, n_blocks),
                "ln2": ones(n_blocks, d),
                "mlp": init_mlp(gen, cfg, n_blocks)}

    p = {"embed": ninit(gen, (cfg.vocab, d), dt), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ninit(gen, (d, cfg.vocab), dt, fan_in=d)
    if fam == "dense":
        p["blocks"] = dense_blocks(n)
    else:
        p["blocks"] = init_mamba_block(gen, cfg, n)
    if fam == "hybrid":
        # one block, unstacked (the reference's init_dense_block)
        p["shared_attn"] = layer_view(dense_blocks(1), 0)
    return p


# ---------------------------------------------------------------------------
# blocks / embeddings / head
# ---------------------------------------------------------------------------

def apply_dense_block(p, h, cfg: ModelConfig, positions, cache=None,
                      kv_bucket=None, offset=None):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, attention(p["attn"], x, cfg, positions, cache=cache,
                     kv_bucket=kv_bucket, offset=offset), p["ln2"],
        cfg.norm_eps)
    return h + mlp(p["mlp"], x)


def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens]


def lm_logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return linear(h, w).float()


def _dense_apply(cfg, params, h, positions, cache=None, kv_bucket=None):
    """The stacked blocks of ``params`` over ``h``; ``cache`` (stacked like
    the blocks) is updated in place.  Returns (h, cache)."""
    blocks = params["blocks"]
    offset = _write_offset(h, cache)
    for i in range(blocks["ln1"].shape[0]):
        c = None if cache is None else layer_view(cache, i)
        h = apply_dense_block(layer_view(blocks, i), h, cfg, positions,
                              cache=c, kv_bucket=kv_bucket, offset=offset)
    return h, cache


def _write_offset(h, attn_cache):
    """Where a multi-token pass writes its k/v: the rows' common length in
    the (stacked) attention cache, read on the host once a pass rather
    than once a layer.  None for a decode step or without a cache."""
    if attn_cache is None or h.shape[1] == 1:
        return None
    return cache_offset(attn_cache["len"])


def _ssm_apply(cfg, params, h, positions, cache=None, kv_bucket=None,
               layer_offset=0, app_offset=0):
    """The stacked mamba blocks of ``params`` over ``h`` (pre-norm,
    residual); ``cache`` (``{"mamba": ...}``, stacked like the blocks, and
    for the hybrid ``"shared"``, stacked by call site) is updated in place.
    Returns (h, cache).

    Hybrid: before block ``idx = layer_offset + i`` with ``idx % every ==
    0``, the shared attention block runs with the cache of call site ``idx
    // every - app_offset`` (a pipeline stage passes its first block and
    the call sites before it; the defaults are the whole model).  A tree
    without ``shared_attn`` (a stage with no call site) is a pure-ssm
    run."""
    blocks = params["blocks"]
    shared = params.get("shared_attn")
    every = cfg.hybrid_attn_every if shared is not None else 0
    offset = (_write_offset(h, cache["shared"])
              if every and cache is not None else None)
    for i in range(blocks["pre_norm"].shape[0]):
        idx = layer_offset + i
        if every and idx % every == 0:
            sc = (None if cache is None
                  else layer_view(cache["shared"], idx // every - app_offset))
            h = apply_dense_block(shared, h, cfg, positions, cache=sc,
                                  kv_bucket=kv_bucket, offset=offset)
        c = None if cache is None else layer_view(cache["mamba"], i)
        bp = layer_view(blocks, i)
        h = h + mamba_block(bp, rms_norm(h, bp["pre_norm"], cfg.norm_eps),
                            cfg, cache=c)
    return h, cache


def _backbone(cfg, params, h, positions, cache=None, kv_bucket=None,
              layer_offset=0, app_offset=0):
    """The family's stacked blocks over ``h``.  ``kv_bucket`` bounds decode
    attention (dense, and the hybrid's shared block); the offsets place a
    stage's blocks in the hybrid's call-site order (``_ssm_apply``)."""
    if family(cfg) == "dense":
        return _dense_apply(cfg, params, h, positions, cache, kv_bucket)
    return _ssm_apply(cfg, params, h, positions, cache, kv_bucket,
                      layer_offset, app_offset)


def _positions(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(cfg: ModelConfig, params, batch):
    """Full-sequence causal forward -> (logits, (h, aux))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed_tokens(params, cfg, tokens)
    h, _ = _backbone(cfg, params, h, _positions(b, s, tokens.device))
    return lm_logits(params, cfg, h), (h, 0.0)


# ---- serving ---------------------------------------------------------------

def init_serve_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
                     device=None):
    """An empty decode cache (zeros); prefill fills it in place.  The SSM
    cache has a fixed size: ``max_len`` only bounds attention caches."""
    return _init_cache(cfg, 0, cfg.n_layers, batch_size, max_len,
                       resolve_device(device))


def hybrid_apps(cfg: ModelConfig, lo: int, hi: int) -> tuple[int, int]:
    """(call sites before ``lo``, call sites inside ``[lo, hi)``) of the
    hybrid's shared attention block; (0, 0) without one."""
    every = cfg.hybrid_attn_every
    if not every:
        return 0, 0
    before = -(-lo // every)
    return before, -(-hi // every) - before


def _init_cache(cfg, lo, hi, batch_size, max_len, device):
    """The family's empty cache for blocks ``[lo, hi)``: the hybrid's
    ``shared`` holds one attention cache per call site inside the range,
    and is left out where there is none."""
    n_layers = hi - lo
    if family(cfg) == "dense":
        return init_cache(cfg, n_layers, batch_size, max_len, device=device)
    out = {"mamba": init_mamba_cache(cfg, n_layers, batch_size,
                                     device=device)}
    apps = hybrid_apps(cfg, lo, hi)[1]
    if apps:
        out["shared"] = init_cache(cfg, apps, batch_size, max_len,
                                   device=device)
    return out


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt through the model, writing its k/v at the cache's
    length (0 for a fresh cache; positions start at 0, as the reference's).
    Returns (last-token logits (B, 1, V) float32, cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed_tokens(params, cfg, tokens)
    h, cache = _backbone(cfg, params, h, _positions(b, s, tokens.device),
                         cache)
    return lm_logits(params, cfg, h[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, tokens, cache,
                kv_bucket: int | None = None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    kv_bucket: attention reads only rows [0, kv_bucket) of the cache;
    callers guarantee max(len) + 1 <= kv_bucket.  None reads all rows.
    The pure SSM family has no attention and ignores it."""
    b = tokens.shape[0]
    h = embed_tokens(params, cfg, tokens)
    positions = _cache_len(cfg, cache)[:, None].expand(b, 1)
    h, cache = _backbone(cfg, params, h, positions, cache, kv_bucket)
    return lm_logits(params, cfg, h), cache


def _cache_len(cfg, cache):
    """Current per-row sequence length (layer 0's counter), as a copy: the
    layers advance the counters in place."""
    if family(cfg) == "dense":
        return cache["len"][0].clone()
    return cache["mamba"]["len"][0].clone()
