"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave
(attention at position 3 of each 8-layer Jamba block), MoE every 2nd layer
[arXiv:2403.19887; hf]. bf16 Adam moments (400B-class)."""
from .base import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab_size=65536, d_head=128, rope=False,
        moe=MoEConfig(n_experts=16, top_k=2, every_k_layers=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_period=8, attn_offset=3,
        opt_moment_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16, rope=False,
        moe=MoEConfig(n_experts=4, top_k=2, every_k_layers=2, capacity_factor=8.0),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
        attn_period=8, attn_offset=3,
    )
