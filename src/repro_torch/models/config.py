"""Model configuration (a copy of the reference's; importing it pulls in
neither torch nor jax)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_interleave: int = 1     # every k-th block is MoE (1 = all)
    moe_capacity_factor: float = 1.25
    moe_impl: str = "gspmd"     # "gspmd" | "ep" (shard_map all_to_all)
    moe_a2a_bits: int = 0       # int8-compress EP dispatch payloads (lambda)

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0          # multi-token-prediction heads

    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    hybrid_attn_every: int = 0  # shared attention block every k ssm blocks

    # --- VLM (llama-3.2-vision) ----------------------------------------------
    cross_attn_every: int = 0   # one cross-attn block per k self-attn blocks
    vision_tokens: int = 0      # stub patch-embedding count

    # --- enc-dec (whisper) -----------------------------------------------------
    n_enc_layers: int = 0

    # --- common -----------------------------------------------------------
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # schedule hint consumed by repro.optim (minicpm uses WSD)
    lr_schedule: str = "cosine"
    # attention implementation: "xla" (jnp reference) or "flash" (Pallas)
    attn_impl: str = "xla"
    # use blocked (online-softmax) attention at/above this seq len; lowering
    # it below the training seq keeps (S,S) scores from materializing
    attn_block_threshold: int = 8192
    # constrain q/k/v heads over the model axis (keeps attention local per
    # head shard instead of GSPMD replicating the head dim)
    attn_head_shard: bool = False
    # unroll the layer loop for decode (static cache slices; larger HLO)
    serve_unroll: bool = False
    # dtype names (resolved lazily to avoid importing jax at config time)
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    # "full" = recompute everything per layer; "save_moe" = keep EP-MoE
    # outputs (skips replaying the all_to_all dispatch in the backward pass)
    remat_policy: str = "full"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ---- parameter counting (used for roofline MODEL_FLOPS = 6*N*D) -------
    def param_count(self, active_only: bool = False) -> float:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.use_mla:
            qkv = (d * self.q_lora_rank
                   + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                   + d * (self.kv_lora_rank + self.qk_rope_dim)
                   + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                   + self.n_heads * self.v_head_dim * d)
        dense_mlp = 3 * d * ff
        expert_mlp = 3 * d * self.moe_d_ff
        total = 2 * v * d if not self.tie_embeddings else v * d
        if self.family == "ssm":
            total += self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            total += self.n_layers * self._ssm_block_params()
            total += qkv + dense_mlp            # one shared attention block
        else:
            n_moe = 0
            if self.n_experts:
                n_moe = self.n_layers // self.moe_interleave
            n_dense = self.n_layers - n_moe
            total += self.n_layers * qkv + n_dense * dense_mlp
            if n_moe:
                routed = self.n_experts if not active_only else self.experts_per_tok
                total += n_moe * (routed + self.n_shared_experts) * expert_mlp
                total += n_moe * d * self.n_experts          # router
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = self.n_layers // (self.cross_attn_every + 1)
                # replace that many self blocks' counting error is negligible
            if self.family == "encdec":
                total += self.n_enc_layers * (qkv + dense_mlp)
                total += self.n_layers * qkv                 # cross attention
        return float(total)

    def _ssm_block_params(self) -> float:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)     # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * n)
        out = di * d
        return in_proj + conv + out + 2 * h    # A_log, D skip


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input-shape cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs that may run the 500k-decode cell (sub-quadratic token mixing)
LONG_CONTEXT_OK = {"mamba2-1.3b", "zamba2-7b"}
