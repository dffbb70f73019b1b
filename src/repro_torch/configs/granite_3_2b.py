"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base] — dense, GQA kv=8."""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155,
        tie_embeddings=True, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, remat=False)
