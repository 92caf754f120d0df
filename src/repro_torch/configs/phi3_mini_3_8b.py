"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064, d_head=96, rope_theta=1e4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, d_head=16, rope_theta=1e4,
    )
