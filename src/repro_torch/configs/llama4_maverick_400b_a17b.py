"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4 family] — MoE.

128 routed experts, top-1, one shared expert, MoE layers interleaved every
2nd block (matches the ~400B total / ~17B active split).  'Early fusion'
multimodality is out of scope for the LM backbone cells (text shapes only).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=16384, vocab=202048,
        n_experts=128, experts_per_tok=1, n_shared_experts=1,
        moe_d_ff=8192, moe_interleave=2,
        rope_theta=500000.0, opt_state_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=256, n_experts=8, moe_d_ff=96,
        remat=False)
