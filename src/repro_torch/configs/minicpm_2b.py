"""MiniCPM-2B [arXiv:2404.06395] — dense llama-like, WSD schedule."""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753,
        tie_embeddings=True, rope_theta=10000.0, lr_schedule="wsd",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="minicpm-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=256, remat=False)
