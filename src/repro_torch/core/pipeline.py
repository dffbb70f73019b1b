"""The LM block graph the SEIFER planner partitions: one ``Layer`` per
transformer block, sized from a ``ModelConfig`` and a serve/train shape.

Copied from the reference planner's ``core/pipeline.py`` (``_block_params``
and ``lm_block_graph`` only): plans must stay bit-identical to the
reference's, so the arithmetic is unchanged.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeConfig

from .graph import Layer, LayerGraph


# ---------------------------------------------------------------------------
# LM block graph export (models/graphdef counterpart, kept here with the
# paper machinery so the partitioner sees every assigned architecture)
# ---------------------------------------------------------------------------

def _block_params(cfg: ModelConfig) -> dict:
    """Per-block parameter counts by block kind."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    if cfg.use_mla:
        qkv = (d * cfg.q_lora_rank
               + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
               + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
               + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
               + cfg.n_heads * cfg.v_head_dim * d)
    out = {
        "dense": qkv + 3 * d * cfg.d_ff,
        "moe": qkv + (cfg.n_experts + cfg.n_shared_experts) * 3 * d * cfg.moe_d_ff
               + d * cfg.n_experts,
        "ssm": cfg._ssm_block_params(),
        "cross": qkv + 3 * d * cfg.d_ff,
        "embed": cfg.vocab * d * (1 if cfg.tie_embeddings else 2),
    }
    return out


def lm_block_graph(cfg: ModelConfig, shape: ShapeConfig,
                   bytes_per_param: float = 2.0) -> LayerGraph:
    """Block-granularity LayerGraph for an assigned architecture.

    out_bytes = residual-stream activation crossing each block boundary
    (bf16, microbatch of the given shape); side inputs (vision embeds /
    encoder output) are charged per DESIGN.md §4."""
    g = LayerGraph()
    p = _block_params(cfg)
    act = shape.global_batch * shape.seq_len * cfg.d_model * 2.0
    if shape.kind == "decode":
        act = shape.global_batch * cfg.d_model * 2.0
    work = 4 * act
    flops_dense = 2.0 * p["dense"] * shape.tokens_per_step

    g.add(Layer("input", out_bytes=shape.tokens_per_step * 4.0))
    g.add(Layer("embed", out_bytes=act, param_bytes=p["embed"] * bytes_per_param,
                work_bytes=work), ["input"])
    prev = "embed"
    side = 0.0
    if cfg.family == "vlm":
        side = shape.global_batch * cfg.vision_tokens * cfg.d_model * 2.0
    if cfg.family == "encdec":
        enc_act = shape.global_batch * shape.seq_len * cfg.d_model * 2.0
        for i in range(cfg.n_enc_layers):
            g.add(Layer(f"enc{i}", out_bytes=enc_act,
                        param_bytes=p["dense"] * bytes_per_param,
                        work_bytes=work, flops=flops_dense), [prev])
            prev = f"enc{i}"
        side = enc_act

    for i in range(cfg.n_layers):
        kind = "dense"
        shared = None
        if cfg.family in ("ssm", "hybrid"):
            kind = "ssm"
        if cfg.n_experts and (i % cfg.moe_interleave == cfg.moe_interleave - 1):
            kind = "moe"
        name = f"block{i}"
        extra = {}
        if cfg.family == "hybrid" and cfg.hybrid_attn_every \
                and i % cfg.hybrid_attn_every == 0:
            # shared attention block rides along at this depth; weights are
            # shared across call sites (omega counts them once per stage)
            g.add(Layer(f"shared_attn@{i}", out_bytes=act,
                        param_bytes=p["dense"] * bytes_per_param,
                        work_bytes=work, flops=flops_dense,
                        shared_group="zamba_shared"), [prev])
            prev = f"shared_attn@{i}"
        if cfg.family == "vlm" and cfg.cross_attn_every \
                and (i + 1) % (cfg.cross_attn_every + 1) == 0:
            kind = "cross"
            extra["side_in_bytes"] = side
        if cfg.family == "encdec":
            kind = "cross"
            extra["side_in_bytes"] = side
        g.add(Layer(name, out_bytes=act,
                    param_bytes=p[kind] * bytes_per_param,
                    work_bytes=work,
                    flops=2.0 * p[kind] * shape.tokens_per_step, **extra),
              [prev])
        prev = name
    # result returned to the dispatcher is tiny (paper §5.2.2)
    g.add(Layer("head", out_bytes=4.0 * shape.global_batch,
                param_bytes=(0 if cfg.tie_embeddings else
                             cfg.vocab * cfg.d_model * bytes_per_param),
                work_bytes=work), [prev])
    return g
