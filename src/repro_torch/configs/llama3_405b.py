"""Llama-3.1-405B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab."""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256,
        rope_theta=500000.0, opt_state_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="llama3-405b-smoke", n_layers=3, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=416, vocab=512, remat=False)
