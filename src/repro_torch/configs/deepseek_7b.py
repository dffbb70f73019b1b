"""DeepSeek-7B [arXiv:2401.02954] — dense llama-arch."""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102400, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=176, vocab=256, remat=False)
