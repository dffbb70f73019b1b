"""Shared model building blocks of the dense family (PyTorch).

Counterpart of ``repro/models/layers.py``.  Caches are updated in place (a
decode step writes one row per sequence into the preallocated cache instead
of returning a new one), which keeps serving free of per-step cache copies.
The length-aware decode bound ``kv_bucket`` is an argument here, not a
module global.

Self-attention over a fresh prompt (prefill at cache offset 0, the
cacheless ``forward``, and the encoder's non-causal blocks) goes through the
flash-attention kernel.  Cross-attention (queries against keys from another
sequence: the vision embeddings or the encoder output) goes through plain
torch ops over a prompt's rows, as the reference's ``_sdpa`` (flash takes
no Sq != Sk), and through the decode kernels at a decode step.  A prefill into a
cache that already holds rows writes at the rows' length and attends over
the cache in plain torch ops, as the reference does.  Rows of one token per
sequence (a decode step, and the last prompt token's head) go through the
row-invariant decode kernels (``kernels.decode``): the projections and
decode attention, so that on the card a row gets the same bits in a batch
of any size and against a cache cut to any bucket.  Every other product is
``torch.matmul``.  Every RMSNorm, of any number of rows, goes through
``rms_norm_rows``, row-invariant too.  The MLP's SiLU is torch's own: the
SiLU with the reference's bf16 rounding points serves the mamba blocks'
fused kernels (``ssm.py``), where that rounding was the measured fault.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.decode.ops import (decode_attention, rms_norm_rows,
                                            rows_matmul)

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


def _one_token(x):
    """Whether x (B, S, D) holds one token per sequence: the rows that go
    through the decode kernels."""
    return x.dim() == 3 and x.shape[1] == 1


def rms_norm(x, w, eps):
    return rms_norm_rows(x, w, eps)


def linear(x, w):
    """x (B, S, K) @ w (K, N); one token per sequence goes through
    ``rows_matmul`` (``w`` may be the transposed view of a tied head)."""
    return rows_matmul(x, w) if _one_token(x) else x @ w


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


def _sdpa(q, k, v, causal, q_offset: int = 0):
    """Plain grouped-query attention.  q: (B,Sq,H,hd)  k/v: (B,Skv,KV,hd).

    q_offset: the cache position of q's first token; a causal query at
    position q_offset + i attends to keys [0, q_offset + i]."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    k, v = k.to(q.dtype), v.to(q.dtype)     # a bf16 cache under f32 params
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    if sq > 1 and causal:
        s_pos = torch.arange(skv, device=q.device)
        q_pos = torch.arange(sq, device=q.device) + q_offset
        scores = scores.masked_fill(~(s_pos[None, :] <= q_pos[:, None]), NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def cache_offset(lens) -> int:
    """The rows' common cache length, where a multi-token write goes (the
    reference's ``lens[0]``).  A host read of ``lens`` (any shape); raises
    if the lengths disagree, which the reference assumes they never do."""
    vals = set(lens.flatten().tolist())
    if len(vals) != 1:
        raise ValueError(f"a multi-token cache write needs rows of one "
                         f"length, got lengths {sorted(vals)}")
    return vals.pop()


def _batched_update(cache, new, lens, offset: int):
    """Write ``new`` (B,s,...) into ``cache`` (B,S,...) in place.

    Decode (s == 1) writes each row at its own length ``lens`` (on the
    device).  A multi-token write goes at ``offset``, the rows' common
    length (``cache_offset``), as the reference's
    ``dynamic_update_slice_in_dim`` at ``lens[0]``; it must fit."""
    s = new.shape[1]
    if s == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, lens.long()] = new[:, 0].to(cache.dtype)
        return
    if offset + s > cache.shape[1]:
        raise ValueError(f"a write of {s} rows at {offset} does not fit a "
                         f"cache of {cache.shape[1]}")
    cache[:, offset:offset + s] = new.to(cache.dtype)


def attention(params, x, cfg: ModelConfig, positions, *, causal=True,
              cache=None, kv_bucket: int | None = None,
              offset: int | None = None):
    """Returns the attention output (B, S, D).

    cache: None, or dict(k, v, len) with k/v (B, S_max, KV, hd) and len
    (B,); it is updated in place.  kv_bucket: the plain decode attention
    reads rows [0, kv_bucket) of the cache only; every row's length + 1
    must fit (the decode kernel reads each row's own length whatever the
    bucket).  offset: for a multi-token write, the rows' common cache
    length when the caller has read it (``cache_offset``); None reads it
    here."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = linear(x, params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(x, params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        lens = cache["len"]
        if s > 1 and offset is None:
            offset = cache_offset(lens)
        _batched_update(cache["k"], k, lens, offset)
        _batched_update(cache["v"], v, lens, offset)
        kv_len = lens + s
        if s == 1:
            kc, vc = cache["k"], cache["v"]
            if kv_bucket is not None and kv_bucket < kc.shape[1]:
                kc, vc = kc[:, :kv_bucket], vc[:, :kv_bucket]
            out = decode_attention(q, kc, vc, kv_len)
        elif offset == 0:
            # a fresh cache: the causal mask hides every cache slot past
            # the prompt, so attending over the new k/v is the same
            # function; k/v go through the cache's dtype as the reference's
            # attention over the cache does
            out = flash_attention(q, k.to(cache["k"].dtype).to(q.dtype),
                                  v.to(cache["v"].dtype).to(q.dtype),
                                  causal=causal)
        else:
            # rows already in the cache: attend over [0, offset + s) with
            # the causal mask from q_offset, as the reference's _sdpa
            end = offset + s
            out = _sdpa(q, cache["k"][:, :end], cache["v"][:, :end], causal,
                        q_offset=offset)
        lens.copy_(kv_len)
    elif s > 1:
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = _sdpa(q, k, v, causal)
    return linear(out.reshape(b, s, cfg.n_heads * hd), params["wo"])


def cross_attention(params, x, cfg: ModelConfig, kv, kv_len=None):
    """x's queries against cross-attention keys and values ``kv`` ({k, v}
    (B, S_kv, KV, hd): a filled cross cache, or the model's ``cross_kv``
    over the source without one): no RoPE, no mask, every key read (the
    reference's ``_cross_attend``).  Given ``kv_len`` (int32 (B,) on the
    device, the cache's length), one token per sequence goes through the
    decode kernels, row-invariant as a decode step's self-attention; a
    prompt's rows go through plain attention, as the reference's ``_sdpa``
    (flash takes no Sq != Sk)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    if kv_len is not None:
        out = decode_attention(q, kv["k"], kv["v"], kv_len)
    else:
        out = _sdpa(q, kv["k"], kv["v"], causal=False)
    return linear(out.reshape(b, s, cfg.n_heads * hd), params["wo"])


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
    h = F.silu(linear(x, params["wg"])) * linear(x, params["wu"])
    return linear(h, params["wd"])
