"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596; hf].
Backbone only: the speech frontend is a stub; input_specs provides
precomputed frame embeddings [B, S/4, D] for the encoder."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206, d_head=64, rope=False,
        enc_dec=True, n_enc_layers=24, enc_len_ratio=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, d_head=16, rope=False,
        enc_dec=True, n_enc_layers=2, enc_len_ratio=4,
    )
