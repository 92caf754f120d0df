"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch: data-dependent decay [arXiv:2404.05892; unverified].
Head size 64 (RWKV convention) -> 32 heads."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536, d_head=64, rope=False,
        ssm="rwkv6",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, d_head=16, rope=False,
        ssm="rwkv6",
    )
