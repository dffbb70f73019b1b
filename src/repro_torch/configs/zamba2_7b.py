"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

81 mamba2 blocks (d_model 3584, state 64); one *weight-shared* full
attention+MLP block (32H, d_ff 14336) applied every 6th layer — 14
application points, each with its own KV cache (weights shared, activations
not).  The partitioner's omega() charges shared-weight duplication when a
cut separates two application sites (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        hybrid_attn_every=6, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        hybrid_attn_every=2, remat=False)
