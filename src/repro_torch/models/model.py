"""Models of the port: params, forward, and serving steps.

Counterpart of ``repro/models/model.py`` for the dense family, the pure
SSM family (mamba2), the hybrid family (zamba2: mamba2 blocks with one
weight-shared attention+MLP block applied before every
``hybrid_attn_every``-th of them), the cross-attention VLM (llama-3.2-
vision: groups of ``cross_attn_every`` self blocks and one block that
attends to the vision embeddings), the encoder-decoder (whisper: a
non-causal encoder over frame embeddings, and decoder blocks of causal
self-attention, cross-attention to the encoder output and an MLP) and the
MoE family (groups of ``moe_interleave - 1`` dense blocks and one MoE
block: llama4-maverick's interleave 2 with GQA attention, deepseek-v3's
interleave 1 with MLA and its multi-token-prediction weights, which
serving never runs).  Params keep the reference's tree layout, with the
blocks stacked on a leading layer axis (``blocks/attn/wq`` is (L, D,
H*hd), ``blocks/in_proj`` (L, D, ...), the VLM's ``groups/self/attn/wq``
(G, k, D, H*hd) and ``groups/cross/xattn/wq`` (G, D, H*hd), the MoE
family's ``groups/moe/moe/wg`` (G, E, D, F) and ``groups/dense/attn/wq``
(G, il - 1, D, H*hd)) and the hybrid's ``shared_attn`` unstacked, so
``models.bridge`` and the checkpoint map leaf for leaf.  The layer loop is
a Python loop over views of the stacked tensors, and the serving cache is
updated in place.

The VLM's and the encoder-decoder's serving caches are ``{"self": ...,
"cross": {"k", "v"}}``: the self-attention caches stacked like the
blocks, and one cross-attention k/v per cross block, filled once per
request at prefill (from the vision embeddings, or from the encoder
output) and read whole by every decode step.  The MoE family's is
``{"moe": ..., "dense": ...}``: the MoE blocks' attention caches stacked by
group (MLA's compressed ``ckv`` and ``krope``, or GQA's k/v), and for an
interleave above 1 the dense blocks' stacked (groups, il - 1).

  init_params(cfg, generator, device=)                    -> params
  forward(cfg, params, batch)                             -> (logits, (h, aux))
  loss_fn(cfg, params, batch)                             -> (loss, metrics)
  init_serve_cache(cfg, batch_size, max_len, batch=, device=) -> cache
  prefill(cfg, params, batch, cache)                      -> (last logits, cache)
  decode_step(cfg, params, tokens, cache, kv_bucket=)     -> (logits, cache)

``batch`` holds ``tokens`` (B, S) and, by family, ``vision`` (B,
vision_tokens, D) or ``frames`` (B, S_enc, D); a forward of the
encoder-decoder may pass ``enc_out`` in place of ``frames``.

Training (``loss_fn``) is ported for every family but the MoE one: the
next-token cross-entropy of the reference, differentiated by autograd
through the kernels' autograd wrappers (flash attention, causal and the
encoder's non-causal, the norms, the SSD scan and the mamba block's conv
pass have backwards; cross-attention over a prompt is plain torch, as the
reference's ``_sdpa``), with each block recomputed in the backward when
``cfg.remat`` is set, as ``jax.checkpoint`` does in the reference (the
hybrid's shared block inside the mamba block it precedes, the VLM a group
at a time, the decoder's cross k/v inside its block, the encoder not at
all).  The blocks are taken apart with ``unbind`` (:func:`unstack`), so
that their gradients gather into one stacked gradient per leaf.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels.decode.ops import residual_rms_norm_rows

from .config import ModelConfig
from .layers import (attention, cache_offset, cross_attention, dtype_of,
                     init_attention, init_cache, init_mla, init_mla_cache,
                     init_mlp, init_moe, linear, mla_attention, mlp, moe_ffn,
                     ninit, rms_norm)
from .ssm import init_mamba_block, init_mamba_cache, mamba_block

FAMILIES = ("dense", "ssm", "hybrid", "vlm", "encdec", "moe")


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


def unstack(tree):
    """Every layer of a stacked tree, as views: ``layer_view`` of each
    layer, through one ``unbind`` a leaf.  Under autograd that is one
    backward node a leaf, which stacks the layers' gradients once, where
    indexing a layer at a time adds a zero-filled copy of the whole stack
    for each layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


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

    def mixer(n_blocks):
        return (init_mla(gen, cfg, n_blocks) if cfg.use_mla
                else init_attention(gen, cfg, n_blocks))

    def dense_blocks(n_blocks):
        return {"ln1": ones(n_blocks, d), "attn": mixer(n_blocks),
                "ln2": ones(n_blocks, d),
                "mlp": init_mlp(gen, cfg, n_blocks)}

    p = {"embed": ninit(gen, (cfg.vocab, d), dt), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ninit(gen, (d, cfg.vocab), dt, fan_in=d)
    if fam == "dense":
        p["blocks"] = dense_blocks(n)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        g = n // (k + 1)
        p["groups"] = {
            "self": tree_map(lambda a: a.view(g, k, *a.shape[1:]),
                             dense_blocks(g * k)),
            "cross": {"lnq": ones(g, d), "xattn": init_attention(gen, cfg, g),
                      "lnf": ones(g, d), "xmlp": init_mlp(gen, cfg, g)}}
    elif fam == "encdec":
        # the conv frontend's stub: one projection of the frame embeddings
        p["frontend"] = ninit(gen, (d, d), dt, fan_in=d)
        p["enc_blocks"] = dense_blocks(cfg.n_enc_layers)
        p["enc_norm"] = ones(d)
        p["dec_blocks"] = {"ln1": ones(n, d),
                           "attn": init_attention(gen, cfg, n),
                           "lnq": ones(n, d),
                           "xattn": init_attention(gen, cfg, n),
                           "ln2": ones(n, d), "mlp": init_mlp(gen, cfg, n)}
    elif fam == "moe":
        il = cfg.moe_interleave
        g = n // il
        p["groups"] = {"moe": {"ln1": ones(g, d), "attn": mixer(g),
                               "ln2": ones(g, d),
                               "moe": init_moe(gen, cfg, g)}}
        if il > 1:
            p["groups"]["dense"] = tree_map(
                lambda a: a.view(g, il - 1, *a.shape[1:]),
                dense_blocks(g * (il - 1)))
        if cfg.mtp_depth:
            p["mtp_proj"] = ninit(gen, (2 * d, d), dt, fan_in=2 * d)
            p["mtp_block"] = layer_view(dense_blocks(1), 0)
    else:
        p["blocks"] = init_mamba_block(gen, cfg, n)
    if fam == "hybrid":
        # one block, unstacked (the reference's init_dense_block)
        p["shared_attn"] = layer_view(dense_blocks(1), 0)
    return p


# ---------------------------------------------------------------------------
# blocks / embeddings / head
# ---------------------------------------------------------------------------

def _self_attend(p, x, cfg: ModelConfig, positions, cache, kv_bucket, offset,
                 causal=True):
    """The block's self-attention: MLA (causal; ``kv_bucket`` bounds only
    a row's length, the whole cache is read) or GQA."""
    if cfg.use_mla:
        return mla_attention(p, x, cfg, positions, cache=cache,
                             kv_bucket=kv_bucket, offset=offset)
    return attention(p, x, cfg, positions, causal=causal, cache=cache,
                     kv_bucket=kv_bucket, offset=offset)


def apply_dense_block(p, h, cfg: ModelConfig, positions, cache=None,
                      kv_bucket=None, offset=None, causal=True):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, _self_attend(p["attn"], x, cfg, positions, cache, kv_bucket,
                        offset, causal), p["ln2"], cfg.norm_eps)
    return h + mlp(p["mlp"], x)


def apply_moe_block(p, h, cfg: ModelConfig, positions, cache=None,
                    kv_bucket=None, offset=None):
    """The MoE block: self-attention (MLA or GQA), then the routed experts
    and the shared one (pre-norm, residual).  Returns (h, aux loss)."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, _self_attend(p["attn"], x, cfg, positions, cache, kv_bucket,
                        offset), p["ln2"], cfg.norm_eps)
    f, aux = moe_ffn(p["moe"], x, cfg)
    return h + f, aux


def apply_cross_block(p, h, cfg: ModelConfig, kv, kv_len=None):
    """The VLM's cross block: cross-attention to the vision embeddings'
    keys and values ``kv`` (its filled cross cache, or ``cross_kv``'s),
    then its own MLP (pre-norm, residual)."""
    x = rms_norm(h, p["lnq"], cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, cross_attention(p["xattn"], x, cfg, kv, kv_len), p["lnf"],
        cfg.norm_eps)
    return h + mlp(p["xmlp"], x)


def apply_decoder_block(p, h, cfg: ModelConfig, positions, kv, cache=None,
                        kv_len=None, kv_bucket=None, offset=None):
    """The encoder-decoder's decoder block: causal self-attention, then
    cross-attention to the encoder output's keys and values ``kv`` (the
    block's filled cross cache, or ``cross_kv``'s), then the MLP."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, attention(p["attn"], x, cfg, positions, cache=cache,
                     kv_bucket=kv_bucket, offset=offset), p["lnq"],
        cfg.norm_eps)
    h, x = residual_rms_norm_rows(
        h, cross_attention(p["xattn"], x, cfg, kv, kv_len), p["ln2"],
        cfg.norm_eps)
    return h + mlp(p["mlp"], x)


def cross_kv(p, cfg: ModelConfig, kv_x):
    """The cross-attention k/v of block ``p`` (its ``xattn``) over
    ``kv_x`` (B, S_kv, D)."""
    b, skv, _ = kv_x.shape
    hd = cfg.resolved_head_dim
    k = linear(kv_x, p["xattn"]["wk"]).reshape(b, skv, cfg.n_kv_heads, hd)
    v = linear(kv_x, p["xattn"]["wv"]).reshape(b, skv, cfg.n_kv_heads, hd)
    return {"k": k, "v": v}


def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens]


def lm_logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return linear(h, w).float()


def _dense_apply(cfg, params, h, positions, cache=None, kv_bucket=None):
    """The stacked blocks of ``params`` over ``h``; ``cache`` (stacked like
    the blocks) is updated in place.  With ``cfg.remat`` a cacheless pass
    under grad (training) recomputes each block's activations in the
    backward instead of keeping them.  Returns (h, cache)."""
    offset = _write_offset(h, cache)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, bp in enumerate(unstack(params["blocks"])):
        if remat:
            # the block holds no randomness: no RNG state to stash
            h = checkpoint(apply_dense_block, bp, h, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        c = None if cache is None else layer_view(cache, i)
        h = apply_dense_block(bp, h, cfg, positions, cache=c,
                              kv_bucket=kv_bucket, offset=offset)
    return h, cache


def _write_offset(h, attn_cache):
    """Where a multi-token pass writes its k/v: the rows' common length in
    the (stacked) attention cache, read on the host once a pass rather
    than once a layer.  None for a decode step or without a cache."""
    if attn_cache is None or h.shape[1] == 1:
        return None
    return cache_offset(attn_cache["len"])


def _moe_apply(cfg, params, h, positions, cache=None, kv_bucket=None):
    """The MoE family's groups over ``h``: ``moe_interleave - 1`` dense
    blocks, then the MoE block.  Returns (h, cache, the groups' aux loss
    summed)."""
    groups = params["groups"]
    offset = None if cache is None else _write_offset(h, cache["moe"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(groups["moe"]["ln1"].shape[0]):
        gp = layer_view(groups, g)
        if "dense" in gp:
            for i in range(gp["dense"]["ln1"].shape[0]):
                c = (None if cache is None
                     else layer_view(layer_view(cache["dense"], g), i))
                h = apply_dense_block(layer_view(gp["dense"], i), h, cfg,
                                      positions, cache=c,
                                      kv_bucket=kv_bucket, offset=offset)
        c = None if cache is None else layer_view(cache["moe"], g)
        h, a = apply_moe_block(gp["moe"], h, cfg, positions, cache=c,
                               kv_bucket=kv_bucket, offset=offset)
        aux = aux + a
    return h, cache, aux


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
    remat = cfg.remat and torch.is_grad_enabled()
    for i, bp in enumerate(unstack(blocks)):
        idx = layer_offset + i
        app = bool(every) and idx % every == 0
        if cache is None:
            args = (bp, shared if app else None, h, cfg, positions)
            # with remat the shared block is recomputed inside the block,
            # as the reference's jax.checkpoint(body) does; no RNG state
            h = (checkpoint(_ssm_layer, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else _ssm_layer(*args))
            continue
        if app:
            sc = layer_view(cache["shared"], idx // every - app_offset)
            h = apply_dense_block(shared, h, cfg, positions, cache=sc,
                                  kv_bucket=kv_bucket, offset=offset)
        h = h + mamba_block(bp, rms_norm(h, bp["pre_norm"], cfg.norm_eps),
                            cfg, cache=layer_view(cache["mamba"], i))
    return h, cache


def _ssm_layer(bp, shared, h, cfg, positions):
    """One cacheless layer of the SSM family: the hybrid's shared block
    first where ``shared`` is given, then the mamba block (pre-norm,
    residual)."""
    if shared is not None:
        h = apply_dense_block(shared, h, cfg, positions)
    return h + mamba_block(bp, rms_norm(h, bp["pre_norm"], cfg.norm_eps), cfg)


def _cross_len(h, cache):
    """A decode step's cross-attention lengths: the cross cache's length for
    every row, int32 (B,) on the device (made once a pass); None for a
    multi-token pass or without a cache."""
    if cache is None or h.shape[1] != 1:
        return None
    xk = cache["cross"]["k"]
    return torch.full((h.shape[0],), xk.shape[2], dtype=torch.int32,
                      device=xk.device)


def _vlm_group(gp, h, cfg, positions, vision):
    """One cacheless VLM group: its self blocks, then the cross block over
    ``vision``'s k/v, computed here (inside the recomputed group under
    remat, as the reference's ``jax.checkpoint(body)``)."""
    for bp in unstack(gp["self"]):
        h = apply_dense_block(bp, h, cfg, positions)
    return apply_cross_block(gp["cross"], h, cfg,
                             cross_kv(gp["cross"], cfg, vision))


def _vlm_apply(cfg, params, h, positions, cache=None, kv_bucket=None,
               vision=None):
    """The VLM's groups over ``h``: ``cross_attn_every`` self blocks, then
    the cross block, which reads the group's filled cross cache or, without
    a cache, attends to ``vision``.  With ``cfg.remat`` a cacheless pass
    under grad recomputes each group in the backward.  Returns (h,
    cache)."""
    groups = params["groups"]
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        for gp in unstack(groups):
            h = (checkpoint(_vlm_group, gp, h, cfg, positions, vision,
                            use_reentrant=False, preserve_rng_state=False)
                 if remat else _vlm_group(gp, h, cfg, positions, vision))
        return h, cache
    offset = _write_offset(h, cache["self"])
    kv_len = _cross_len(h, cache)
    for g in range(groups["cross"]["lnq"].shape[0]):
        gp = layer_view(groups, g)
        sc = layer_view(cache["self"], g)
        for i in range(gp["self"]["ln1"].shape[0]):
            h = apply_dense_block(layer_view(gp["self"], i), h, cfg,
                                  positions, cache=layer_view(sc, i),
                                  kv_bucket=kv_bucket, offset=offset)
        h = apply_cross_block(gp["cross"], h, cfg,
                              layer_view(cache["cross"], g), kv_len)
    return h, cache


def encode(cfg: ModelConfig, params, frames):
    """The encoder over frame embeddings (B, S_enc, D): the frontend's
    projection, non-causal dense blocks with RoPE over the frame positions,
    and ``enc_norm``.  No remat, as the reference's."""
    h = linear(frames.to(params["frontend"].dtype), params["frontend"])
    b, s = frames.shape[:2]
    pos = _positions(b, s, frames.device)
    for bp in unstack(params["enc_blocks"]):
        h = apply_dense_block(bp, h, cfg, pos, causal=False)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _decoder_layer(bp, h, cfg, positions, enc_out):
    """One cacheless decoder block, its cross k/v over ``enc_out``
    computed here (inside the recomputed block under remat, as the
    reference's ``jax.checkpoint(body)``)."""
    return apply_decoder_block(bp, h, cfg, positions,
                               cross_kv(bp, cfg, enc_out))


def _encdec_apply(cfg, params, h, positions, cache=None, kv_bucket=None,
                  enc_out=None):
    """The decoder blocks over ``h``: each cross-attends to its filled
    cross cache or, without a cache, to ``enc_out``.  With ``cfg.remat`` a
    cacheless pass under grad recomputes each block in the backward.
    Returns (h, cache)."""
    blocks = params["dec_blocks"]
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        for bp in unstack(blocks):
            h = (checkpoint(_decoder_layer, bp, h, cfg, positions, enc_out,
                            use_reentrant=False, preserve_rng_state=False)
                 if remat else _decoder_layer(bp, h, cfg, positions, enc_out))
        return h, cache
    offset = _write_offset(h, cache["self"])
    kv_len = _cross_len(h, cache)
    for i in range(blocks["ln1"].shape[0]):
        h = apply_decoder_block(layer_view(blocks, i), h, cfg, positions,
                                layer_view(cache["cross"], i),
                                cache=layer_view(cache["self"], i),
                                kv_len=kv_len, kv_bucket=kv_bucket,
                                offset=offset)
    return h, cache


def _backbone(cfg, params, h, positions, cache=None, kv_bucket=None,
              layer_offset=0, app_offset=0, side=None):
    """The family's stacked blocks over ``h``.  ``kv_bucket`` bounds decode
    GQA self-attention (dense, the VLM's, the decoder's and llama4's
    blocks, and the hybrid's shared block; MLA reads the whole cache); the
    offsets place a stage's blocks in the hybrid's call-site order
    (``_ssm_apply``); ``side`` holds a cacheless pass's cross-attention
    source (``vision`` or ``enc_out``)."""
    fam = family(cfg)
    side = side or {}
    if fam == "moe":
        h, cache, _ = _moe_apply(cfg, params, h, positions, cache, kv_bucket)
        return h, cache
    if fam == "dense":
        return _dense_apply(cfg, params, h, positions, cache, kv_bucket)
    if fam == "vlm":
        return _vlm_apply(cfg, params, h, positions, cache, kv_bucket,
                          side.get("vision"))
    if fam == "encdec":
        return _encdec_apply(cfg, params, h, positions, cache, kv_bucket,
                             side.get("enc_out"))
    return _ssm_apply(cfg, params, h, positions, cache, kv_bucket,
                      layer_offset, app_offset)


def _positions(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(cfg: ModelConfig, params, batch):
    """Full-sequence causal forward -> (logits, (h, aux)), aux the MoE
    blocks' load-balancing loss over ``n_layers`` (0.0 for the other
    families), as the reference's.  The VLM attends to
    ``batch["vision"]``; the encoder-decoder to ``batch["enc_out"]`` or,
    without it, to the encoding of ``batch["frames"]``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = embed_tokens(params, cfg, tokens)
    positions = _positions(b, s, tokens.device)
    if family(cfg) == "moe":
        h, _, aux = _moe_apply(cfg, params, h, positions)
        return lm_logits(params, cfg, h), (h, aux / cfg.n_layers)
    h, _ = _backbone(cfg, params, h, positions,
                     side=_side_inputs(cfg, params, batch))
    return lm_logits(params, cfg, h), (h, 0.0)


def token_ce(logits, targets):
    """Mean next-token cross-entropy; logits (B,S,V) float32, targets
    (B,S)."""
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, targets[..., None].long())[..., 0]
    return nll.mean()


TRAIN_FAMILIES = ("dense", "ssm", "hybrid", "vlm", "encdec")


def loss_fn(cfg: ModelConfig, params, batch):
    """(loss, metrics) of the reference's ``loss_fn``: the next-token
    cross-entropy of ``forward`` (each block, or the VLM's each group,
    rematerialised when ``cfg.remat``), metrics ``ce`` and ``loss``.  The
    families of ``TRAIN_FAMILIES``; the batch holds the VLM's ``vision``
    (B, vision_tokens, D) or the encoder-decoder's ``frames`` (B, S, D)
    beside ``tokens``.  The MoE family's training (its aux loss and
    multi-token prediction) is ROADMAP Queue 1 item 10.2, and raises here
    on every device."""
    if family(cfg) not in TRAIN_FAMILIES:
        raise NotImplementedError(
            f"loss_fn: training is ported for the {TRAIN_FAMILIES} "
            f"families; {cfg.name} ({cfg.family}) waits for ROADMAP Queue 1 "
            "item 10.2 (the MoE family's training: its aux loss and "
            "multi-token prediction)")
    logits, _ = forward(cfg, params, batch)
    targets = batch["tokens"]
    loss = token_ce(logits[:, :-1], targets[:, 1:])
    return loss, {"ce": loss, "loss": loss}


def _side_inputs(cfg: ModelConfig, params, batch):
    """A request batch's cross-attention source: the VLM's ``vision``, or
    the encoder-decoder's ``enc_out`` (the batch's, else the encoding of
    its ``frames``); empty for the other families."""
    if family(cfg) == "vlm":
        return {"vision": batch["vision"].to(dtype_of(cfg))}
    if cfg.family == "encdec":
        enc_out = batch.get("enc_out")
        if enc_out is None:
            enc_out = encode(cfg, params, batch["frames"])
        return {"enc_out": enc_out}
    return {}


# ---- serving ---------------------------------------------------------------

def init_serve_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
                     batch=None, device=None):
    """An empty decode cache (zeros); prefill fills it in place.  The SSM
    cache has a fixed size: ``max_len`` only bounds attention caches.  The
    encoder-decoder's cross caches hold ``batch["frames"].shape[1]`` rows
    (``max_len`` without a batch), the VLM's ``cfg.vision_tokens``."""
    enc_len = (batch["frames"].shape[1] if batch and "frames" in batch
               else max_len)
    return _init_cache(cfg, 0, cfg.n_layers, batch_size, max_len,
                       resolve_device(device), enc_len)


def hybrid_apps(cfg: ModelConfig, lo: int, hi: int) -> tuple[int, int]:
    """(call sites before ``lo``, call sites inside ``[lo, hi)``) of the
    hybrid's shared attention block; (0, 0) without one."""
    every = cfg.hybrid_attn_every
    if not every:
        return 0, 0
    before = -(-lo // every)
    return before, -(-hi // every) - before


def _cross_cache(cfg, n, batch_size, kv_len, device):
    """``n`` empty cross-attention caches of ``kv_len`` rows, bf16 as the
    reference's."""
    shape = (n, batch_size, kv_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _init_cache(cfg, lo, hi, batch_size, max_len, device, enc_len=None):
    """The family's empty cache for blocks ``[lo, hi)``: the hybrid's
    ``shared`` holds one attention cache per call site inside the range,
    and is left out where there is none; the VLM's ``self`` is stacked
    (groups, self blocks), its ``cross`` by group; the encoder-decoder's
    cross caches hold ``enc_len`` rows."""
    n_layers = hi - lo
    fam = family(cfg)
    if fam == "dense":
        return init_cache(cfg, n_layers, batch_size, max_len, device=device)
    if fam == "vlm":
        k = cfg.cross_attn_every
        g = n_layers // (k + 1)
        sc = init_cache(cfg, g * k, batch_size, max_len, device=device)
        return {"self": tree_map(lambda a: a.view(g, k, *a.shape[1:]), sc),
                "cross": _cross_cache(cfg, g, batch_size, cfg.vision_tokens,
                                      device)}
    if fam == "moe":
        il = cfg.moe_interleave
        g = n_layers // il
        mk = init_mla_cache if cfg.use_mla else init_cache
        out = {"moe": mk(cfg, g, batch_size, max_len, device=device)}
        if il > 1:
            out["dense"] = tree_map(
                lambda a: a.view(g, il - 1, *a.shape[1:]),
                mk(cfg, g * (il - 1), batch_size, max_len, device=device))
        return out
    if fam == "encdec":
        return {"self": init_cache(cfg, n_layers, batch_size, max_len,
                                   device=device),
                "cross": _cross_cache(cfg, n_layers, batch_size,
                                      max_len if enc_len is None else enc_len,
                                      device)}
    out = {"mamba": init_mamba_cache(cfg, n_layers, batch_size,
                                     device=device)}
    apps = hybrid_apps(cfg, lo, hi)[1]
    if apps:
        out["shared"] = init_cache(cfg, apps, batch_size, max_len,
                                   device=device)
    return out


def fill_cross(cfg: ModelConfig, blocks, cross, src):
    """Fill the cross caches ``cross`` ({k, v}, one per block) in place
    with the k/v of the stacked ``blocks`` (their ``xattn``) over ``src``
    (B, S_kv, D): the vision embeddings (the VLM's cross blocks) or the
    encoder output (the decoder blocks).  Any contiguous slice of the
    blocks and its caches will do (a pipeline stage passes its own)."""
    src = src.to(blocks["xattn"]["wk"].dtype)
    for i in range(cross["k"].shape[0]):
        new = cross_kv(layer_view(blocks, i), cfg, src)
        cross["k"][i].copy_(new["k"])
        cross["v"][i].copy_(new["v"])
    return cross


def fill_cross_caches(cfg: ModelConfig, params, cache, side):
    """Compute a request's cross-attention k/v once, at prefill: the VLM's
    from ``side["vision"]``, the encoder-decoder's from ``side["enc_out"]``.
    A cache without cross caches (another family, a block-free stage) is
    left as it is."""
    if not cache or "cross" not in cache:
        return cache
    if cfg.family == "vlm":
        fill_cross(cfg, params["groups"]["cross"], cache["cross"],
                   side["vision"])
    else:
        fill_cross(cfg, params["dec_blocks"], cache["cross"],
                   side["enc_out"])
    return cache


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt through the model, writing its k/v at the cache's
    length (0 for a fresh cache; positions start at 0, as the reference's)
    and, for the VLM and the encoder-decoder, filling the cross caches
    first.  Returns (last-token logits (B, 1, V) float32, cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = fill_cross_caches(cfg, params, cache,
                              _side_inputs(cfg, params, batch))
    h = embed_tokens(params, cfg, tokens)
    h, cache = _backbone(cfg, params, h, _positions(b, s, tokens.device),
                         cache)
    return lm_logits(params, cfg, h[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, tokens, cache,
                kv_bucket: int | None = None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    kv_bucket: self-attention reads only rows [0, kv_bucket) of the cache;
    callers guarantee max(len) + 1 <= kv_bucket.  None reads all rows.
    Cross-attention and MLA always read the whole cache.  The pure SSM
    family has no attention and ignores it."""
    b = tokens.shape[0]
    h = embed_tokens(params, cfg, tokens)
    positions = _cache_len(cfg, cache)[:, None].expand(b, 1)
    h, cache = _backbone(cfg, params, h, positions, cache, kv_bucket)
    return lm_logits(params, cfg, h), cache


def _cache_len(cfg, cache):
    """Current per-row sequence length (layer 0's counter), as a copy: the
    layers advance the counters in place."""
    fam = family(cfg)
    if fam == "dense":
        return cache["len"][0].clone()
    if fam == "vlm":
        return cache["self"]["len"][0, 0].clone()
    if fam == "encdec":
        return cache["self"]["len"][0].clone()
    if fam == "moe":
        return cache["moe"]["len"][0].clone()
    return cache["mamba"]["len"][0].clone()
