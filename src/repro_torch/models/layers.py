"""Shared model building blocks of the dense family (PyTorch).

Counterpart of ``repro/models/layers.py``.  Caches are updated in place (a
decode step writes one row per sequence into the preallocated cache instead
of returning a new one), which keeps serving free of per-step cache copies.
The length-aware decode bound ``kv_bucket`` is an argument here, not a
module global.

Attention over a fresh prompt (prefill at cache offset 0, and the cacheless
``forward``) goes through the flash-attention kernel; decode attention and
every projection are plain torch ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ops import flash_attention

from .config import ModelConfig

NEG = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def ninit(gen: torch.Generator, shape, dtype, *, scale=0.02, fan_in=None):
    """Normal init drawn in float32 from ``gen`` (on ``gen``'s device)."""
    scale = scale if fan_in is None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (scale * x).to(dtype)


def rms_norm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions, dim, theta):
    """positions: (B, S) int -> cos/sin (B, S, dim/2) float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); rotate-half convention."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA) with optional KV cache
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, n_layers: int):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg)
    return {
        "wq": ninit(gen, (n_layers, d, cfg.n_heads * hd), dt, fan_in=d),
        "wk": ninit(gen, (n_layers, d, cfg.n_kv_heads * hd), dt, fan_in=d),
        "wv": ninit(gen, (n_layers, d, cfg.n_kv_heads * hd), dt, fan_in=d),
        "wo": ninit(gen, (n_layers, cfg.n_heads * hd, d), dt,
                    fan_in=cfg.n_heads * hd),
    }


def _sdpa(q, k, v, causal, kv_len=None):
    """Plain grouped-query attention.  q: (B,Sq,H,hd)  k/v: (B,Skv,KV,hd).

    kv_len: optional (B,) active cache lengths, applied when Sq == 1
    (decode): the query attends to the written slots only."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    k, v = k.to(q.dtype), v.to(q.dtype)     # a bf16 cache under f32 params
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    s_pos = torch.arange(skv, device=q.device)
    if sq == 1:
        if kv_len is not None:
            keep = (s_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
            scores = scores.masked_fill(~keep, NEG)
    elif causal:
        keep = s_pos[None, :] <= torch.arange(sq, device=q.device)[:, None]
        scores = scores.masked_fill(~keep, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _batched_update(cache, new, lens):
    """Write ``new`` (B,s,...) into ``cache`` (B,S,...) in place.

    Decode (s == 1) writes each row at its own length.  A multi-token write
    is a prefill, which always fills a fresh cache from offset 0."""
    if new.shape[1] == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, lens.long()] = new[:, 0].to(cache.dtype)
    else:
        cache[:, :new.shape[1]] = new.to(cache.dtype)


def attention(params, x, cfg: ModelConfig, positions, *, causal=True,
              cache=None, kv_bucket: int | None = None):
    """Returns the attention output (B, S, D).

    cache: None, or dict(k, v, len) with k/v (B, S_max, KV, hd) and len
    (B,); it is updated in place.  kv_bucket: decode attends to rows
    [0, kv_bucket) of the cache only; every row's length + 1 must fit."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        lens = cache["len"]
        kv_len = lens + s
        _batched_update(cache["k"], k, lens)
        _batched_update(cache["v"], v, lens)
        if s == 1:
            kc, vc = cache["k"], cache["v"]
            if kv_bucket is not None and kv_bucket < kc.shape[1]:
                kc, vc = kc[:, :kv_bucket], vc[:, :kv_bucket]
            out = _sdpa(q, kc, vc, causal, kv_len)
        else:
            # prefill at offset 0: the causal mask hides every cache slot
            # past the prompt, so attending over the new k/v is the same
            # function; k/v go through the cache's dtype as the reference's
            # attention over the cache does
            out = flash_attention(q, k.to(cache["k"].dtype).to(q.dtype),
                                  v.to(cache["v"].dtype).to(q.dtype),
                                  causal=causal)
        lens.copy_(kv_len)
    elif s > 1:
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = _sdpa(q, k, v, causal)
    return out.reshape(b, s, cfg.n_heads * hd) @ params["wo"]


def init_cache(cfg: ModelConfig, n_layers, batch, max_len, *, device):
    """Stacked per-layer caches: k/v (L, B, S_max, KV, hd) in bfloat16 (as
    the reference's serving caches, whatever the param dtype), len (L, B)."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((n_layers, batch, max_len, kv, hd),
                         dtype=torch.bfloat16, device=device),
        "v": torch.zeros((n_layers, batch, max_len, kv, hd),
                         dtype=torch.bfloat16, device=device),
        "len": torch.zeros((n_layers, batch), dtype=torch.int32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, n_layers: int):
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "wg": ninit(gen, (n_layers, d, f), dt, fan_in=d),
        "wu": ninit(gen, (n_layers, d, f), dt, fan_in=d),
        "wd": ninit(gen, (n_layers, f, d), dt, fan_in=f),
    }


def mlp(params, x):
    h = F.silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
