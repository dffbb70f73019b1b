"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD."""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,  # unused (no attn)
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, remat=False)
