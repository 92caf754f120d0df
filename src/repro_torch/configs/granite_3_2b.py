"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA, tied embeddings
[hf:ibm-granite/granite-3.0-2b-base; hf]. Vocab 49155 is padded to 49408
(multiple of 256) for even sharding; loss masks the pad rows."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155, d_head=64, rope_theta=1e4,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=500, d_head=16, tie_embeddings=True,
    )
