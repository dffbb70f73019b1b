"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-Vision] — cross-attn VLM.

100 layers = 20 groups of (4 self-attn blocks + 1 cross-attn block to image
embeddings).  The ViT frontend is a stub per the brief: input_specs()
provides precomputed patch embeddings (B, 6400, d_model).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256,
        cross_attn_every=4, vision_tokens=6400,
        rope_theta=500000.0, opt_state_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="llama-vision-smoke", n_layers=5, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, cross_attn_every=4,
        vision_tokens=16, remat=False)
