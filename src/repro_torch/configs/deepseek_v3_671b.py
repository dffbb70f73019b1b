"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA + 256-expert top-8 MoE + MTP.

MLA dims follow the paper: q_lora 1536, kv_lora 512, qk nope/rope 128/64,
v_head 128.  Every block is MoE (1 shared + 256 routed, expert d_ff=2048);
d_ff=18432 is used by the MTP block (the paper's dense-first-3-layers detail
is folded into the uniform scan — noted in DESIGN.md §8).
"""

from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280,
        n_experts=256, experts_per_tok=8, n_shared_experts=1,
        moe_d_ff=2048, moe_interleave=1,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        mtp_depth=1,
        rope_theta=10000.0, opt_state_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return full_config().replace(
        name="deepseek-v3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, n_experts=8, experts_per_tok=2,
        moe_d_ff=48, q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
        qk_nope_dim=16, v_head_dim=16, remat=False)
