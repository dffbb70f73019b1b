"""Shared model building blocks (PyTorch): GQA and cross-attention, MLA,
the MLP and the MoE layer.

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

MLA (``mla_attention``) and the MoE layer (``moe_ffn``) keep the
reference's plain ops where it has no Pallas kernel: MLA's decompressions
and attention, the router and the experts' batched products are torch
ops; their per-token projections and norms go through the kernels above.
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

DRAW = 1 << 32         # elements of float32 a draw holds at most (16 GiB)


def ninit(gen: torch.Generator, shape, dtype, *, scale=0.02, fan_in=None):
    """Normal init drawn in float32 from ``gen`` (on ``gen``'s device) and
    written into a tensor of ``dtype``, ``DRAW`` elements at a time.  A
    leaf of at most ``DRAW`` elements (every leaf of the dense, SSM,
    hybrid, VLM and encoder-decoder models at the depths served on one
    card) is one draw, bit for bit ``(scale * randn(shape)).to(dtype)``; a
    MoE model's expert stack (deepseek-v3's are 7.5 G elements) is drawn in
    parts, so it never has a whole float32 copy."""
    scale = scale if fan_in is None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW):
        part = flat[i:i + DRAW]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device,
                               dtype=torch.float32).mul_(scale))
    return out


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


def _sdpa(q, k, v, causal, q_offset: int = 0, kv_len=None):
    """Plain grouped-query attention.  q: (B,Sq,H,hd)  k/v: (B,Skv,KV,hd);
    v's head dim may differ from q's and k's (MLA).

    q_offset: the cache position of q's first token; a causal query at
    position q_offset + i attends to keys [0, q_offset + i].  kv_len: for
    one query token per sequence, each row's keys [0, kv_len[b]) (int32
    (B,) on the device); None reads every key."""
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
    elif sq == 1 and kv_len is not None:
        s_pos = torch.arange(skv, device=q.device)
        keep = (s_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
        scores = scores.masked_fill(~keep, NEG)
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


def _batched_update(pairs, lens, offset: int):
    """Write each ``new`` (B,s,...) of ``pairs`` into its ``cache``
    (B,S,...), in place; ``pairs`` is ((cache, new), ...), one layer's
    caches (k and v, or MLA's ckv and krope).

    Decode (s == 1) writes each row at its own length ``lens`` (on the
    device); a row whose length has passed the cache (an idle slot of
    ``SlotScheduler``, which steps on) writes nothing, as the reference's
    scatter ``cache.at[rows, lens].set(...)`` drops an update out of
    bounds.  A multi-token write goes at ``offset``, the rows' common
    length (``cache_offset``), as the reference's
    ``dynamic_update_slice_in_dim`` at ``lens[0]``; it must fit."""
    s, size = pairs[0][1].shape[1], pairs[0][0].shape[1]
    if s == 1:
        rows = torch.arange(lens.shape[0], device=lens.device)
        at, inside = lens.clamp(max=size - 1), lens < size
        for cache, new in pairs:
            old = cache[rows, at]
            keep = inside.view(-1, *(1,) * (old.dim() - 1))
            cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype),
                                          old)
        return
    if offset + s > size:
        raise ValueError(f"a write of {s} rows at {offset} does not fit a "
                         f"cache of {size}")
    for cache, new in pairs:
        cache[:, offset:offset + s] = new.to(cache.dtype)


def attention(params, x, cfg: ModelConfig, positions, *, causal=True,
              cache=None, kv_bucket: int | None = None,
              offset: int | None = None):
    """Returns the attention output (B, S, D).

    cache: None, or dict(k, v, len) with k/v (B, S_max, KV, hd) and len
    (B,); it is updated in place.  kv_bucket: decode attention reads rows
    [0, kv_bucket) of the cache only; an active row's length + 1 must fit
    (the decode kernel reads each row's own length whatever the bucket),
    and a longer row (an idle slot stepping on) reads the bucket's rows,
    as the reference's slice of the cache does.  offset: for a
    multi-token write, the rows' common cache length when the caller has
    read it (``cache_offset``); None reads it here."""
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
        _batched_update(((cache["k"], k), (cache["v"], v)), lens, offset)
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
# MLA: multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, n_layers: int):
    d, nh = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dt = dtype_of(cfg)
    return {
        "wdq": ninit(gen, (n_layers, d, ql), dt, fan_in=d),
        "q_norm": torch.ones((n_layers, ql), dtype=dt, device=gen.device),
        "wuq": ninit(gen, (n_layers, ql, nh * qk), dt, fan_in=ql),
        "wdkv": ninit(gen, (n_layers, d, kl + cfg.qk_rope_dim), dt, fan_in=d),
        "kv_norm": torch.ones((n_layers, kl), dtype=dt, device=gen.device),
        "wuk": ninit(gen, (n_layers, kl, nh * cfg.qk_nope_dim), dt,
                     fan_in=kl),
        "wuv": ninit(gen, (n_layers, kl, nh * cfg.v_head_dim), dt, fan_in=kl),
        "wo": ninit(gen, (n_layers, nh * cfg.v_head_dim, d), dt,
                    fan_in=nh * cfg.v_head_dim),
    }


def mla_attention(params, x, cfg: ModelConfig, positions, *, cache=None,
                  kv_bucket: int | None = None, offset: int | None = None):
    """Returns the attention output (B, S, D).

    cache: None, or dict(ckv, krope, len): the compressed ``c_kv`` (B,
    S_max, kv_lora) and the shared rope key (B, S_max, rope_dim), updated
    in place (the reference's serving memory win).  The per-token
    projections go through ``linear`` and both norms through
    ``rms_norm``; the decompressions ``c_kv @ wuk`` and ``c_kv @ wuv`` and
    the attention are plain torch over the cache's rows, as the reference
    (its ``_sdpa``): causal from ``offset`` over ``[0, offset + S)`` at a
    prefill, and at a decode step over the whole cache, masked by each
    row's length.  ``kv_bucket`` bounds that length and no more: the
    reference slices the cache to the bucket before decompressing, which
    changes which masked zeros a plain reduction sums, so reading the
    whole cache in both ``ServeEngine`` loops is what keeps their logits
    bit-identical on the card; a row longer than the bucket (an idle slot
    stepping on) reads the bucket's keys, as the reference's.  q and k
    have ``qk_nope + qk_rope`` dims a head, v ``v_head_dim``:
    ``decode_attention`` takes neither."""
    b, s, _ = x.shape
    nh, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kl = cfg.kv_lora_rank
    q = linear(rms_norm(linear(x, params["wdq"]), params["q_norm"],
                        cfg.norm_eps), params["wuq"])
    q = q.reshape(b, s, nh, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = linear(x, params["wdkv"])                     # (B, S, kv_lora+rope)
    c_kv = rms_norm(dkv[..., :kl], params["kv_norm"], cfg.norm_eps)
    k_rope = dkv[..., kl:][:, :, None, :]               # one shared head
    cos, sin = rope_tables(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    q_offset, kv_len = 0, None
    if cache is not None:
        lens = cache["len"]
        if s > 1 and offset is None:
            offset = cache_offset(lens)
        _batched_update(((cache["ckv"], c_kv),
                         (cache["krope"], k_rope[:, :, 0])), lens, offset)
        if s == 1:
            kv_len = lens + 1
            if kv_bucket is not None:
                kv_len = kv_len.clamp(max=kv_bucket)
            c_kv, k_rope = cache["ckv"], cache["krope"][:, :, None]
        else:
            end = offset + s
            c_kv = cache["ckv"][:, :end]
            k_rope = cache["krope"][:, :end, None]
            q_offset = offset
        lens.add_(s)
    skv = c_kv.shape[1]
    wuk, wuv = params["wuk"], params["wuv"]
    k_nope = (c_kv.to(wuk.dtype) @ wuk).reshape(b, skv, nh, nope)
    val = (c_kv.to(wuv.dtype) @ wuv).reshape(b, skv, nh, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(b, skv, nh, rope)],
                  dim=-1)
    out = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, val, True,
                q_offset=q_offset, kv_len=kv_len)
    return linear(out.reshape(b, s, nh * cfg.v_head_dim), params["wo"])


def init_mla_cache(cfg: ModelConfig, n_layers, batch, max_len, *, device):
    """Stacked per-layer MLA caches: ckv (L, B, S_max, kv_lora) and krope
    (L, B, S_max, rope_dim) in bfloat16, len (L, B)."""
    def zeros(width):
        return torch.zeros((n_layers, batch, max_len, width),
                           dtype=torch.bfloat16, device=device)
    return {"ckv": zeros(cfg.kv_lora_rank), "krope": zeros(cfg.qk_rope_dim),
            "len": torch.zeros((n_layers, batch), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, n_layers: int, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "wg": ninit(gen, (n_layers, d, f), dt, fan_in=d),
        "wu": ninit(gen, (n_layers, d, f), dt, fan_in=d),
        "wd": ninit(gen, (n_layers, f, d), dt, fan_in=f),
    }


def mlp(params, x):
    h = F.silu(linear(x, params["wg"])) * linear(x, params["wu"])
    return linear(h, params["wd"])


# ---------------------------------------------------------------------------
# MoE: top-k routing with sorted capacity-based dispatch
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig, n_layers: int):
    """The router (float32, as the reference's), the experts' stacked
    SwiGLU weights (L, E, ...) and the shared expert."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dt = dtype_of(cfg)
    p = {"router": ninit(gen, (n_layers, d, e), torch.float32, fan_in=d),
         "wg": ninit(gen, (n_layers, e, d, f), dt, fan_in=d),
         "wu": ninit(gen, (n_layers, e, d, f), dt, fan_in=d),
         "wd": ninit(gen, (n_layers, e, f, d), dt, fan_in=f)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, n_layers,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def _route(params, xf, k):
    """The router over the rows xf (T, D): float32 logits, softmax, the
    top k (the first k of a stable descending sort: on a tie the lower
    expert id first, as ``jax.lax.top_k``), gates renormalised.  Returns
    (probs (T, E), gates (T, k) float32, idx (T, k) int64)."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def _combine(contrib, sort_idx, idx):
    """The tokens' outputs (T, D) from the entries' contributions (T*k, D)
    in sorted order (entry ``sort_idx[i]`` of the flat (token, slot)
    order): each token's k contributions added in ascending expert id
    from zero, rounding to their dtype after each add, which is the order
    and the rounding of the reference's scatter-add over the sorted
    entries.  Gathers, no atomics."""
    t, k = idx.shape
    flat = torch.empty_like(contrib)
    flat[sort_idx] = contrib
    flat = flat.view(t, k, -1)
    order = torch.argsort(idx, dim=1)                           # by expert id
    rows = torch.arange(t, device=idx.device)
    y = torch.zeros((t, flat.shape[-1]), dtype=contrib.dtype,
                    device=contrib.device)
    for r in range(k):
        y = y + flat[rows, order[:, r]]
    return y


def moe_ffn(params, x, cfg: ModelConfig):
    """Returns (y, aux_loss): the reference's sorted dispatch with per-expert
    capacity ``cap = max(1, int(cf * T * k / E))``; an entry past its
    expert's capacity is dropped (it writes nowhere and adds nothing, and
    the token's residual stream passes through), the Switch aux loss.

    Every expert computes its (cap, D) buffer (the reference's dense
    dispatch), so a decode step reads every expert's weights.  The combine
    adds each token's k contributions in a fixed order, ascending expert
    id, rounding to x's dtype after each add, as the reference's
    scatter-add visits them (its stable sort puts one token's entries in
    that order): no atomics, so the bits do not depend on the run."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_tok, cfg.n_experts
    xf = x.reshape(t, d)
    probs, gates, idx = _route(params, xf, k)

    # load-balancing auxiliary loss (Switch eq. 4)
    first = torch.zeros_like(probs).scatter_(1, idx[:, :1], 1.0)
    aux = e * torch.sum(probs.mean(dim=0) * first.mean(dim=0))

    cap = max(1, int(cfg.moe_capacity_factor * t * k / e))
    flat_e = idx.reshape(-1)                                    # (T*k,)
    sort_idx = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sort_idx]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - seg_start[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)     # e*cap: drop
    token_of = sort_idx // k

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[token_of]
    buf = buf[:e * cap].view(e, cap, d)
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wu"])
    out = torch.bmm(h, params["wd"]).reshape(e * cap, d)

    gate_of = gates.reshape(-1)[sort_idx].to(x.dtype)
    contrib = out[torch.where(keep, dest, 0)] * (gate_of * keep)[:, None]
    y = _combine(contrib, sort_idx, idx).view(b, s, d)
    if "shared" in params:
        y = y + mlp(params["shared"], x)
    return y, aux


def moe_ffn_reference(params, x, cfg: ModelConfig):
    """O(E*T) dense oracle for tests: every expert computes every token."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    _, gates, idx = _route(params, xf, cfg.experts_per_tok)
    h = F.silu(torch.einsum("td,edf->etf", xf, params["wg"])) \
        * torch.einsum("td,edf->etf", xf, params["wu"])
    oute = torch.einsum("etf,efd->etd", h, params["wd"])        # (E, T, D)
    sel = F.one_hot(idx, cfg.n_experts).float()                 # (T, k, E)
    w = torch.einsum("tke,tk->et", sel, gates).to(x.dtype)
    y = torch.einsum("etd,et->td", oute, w).reshape(b, s, d)
    if "shared" in params:
        y = y + mlp(params["shared"], x)
    return y
