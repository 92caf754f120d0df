"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768, d_head=128, rope_theta=1e6,
        sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16, sliding_window=8,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0),
    )
