"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + DENSE RESIDUAL (the Arctic hybrid-dense trick)
[hf:Snowflake/snowflake-arctic-base; hf]. bf16 Adam moments (400B-class)."""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab_size=32000, d_head=128, rope_theta=1e4,
        moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True),
        opt_moment_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=512, d_head=16,
        moe=MoEConfig(n_experts=4, top_k=2, dense_residual=True, capacity_factor=8.0),
    )
