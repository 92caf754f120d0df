"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (temporal/height/width rotary sections), dynamic
resolution [arXiv:2409.12191; hf]. Backbone only: the vision frontend is a
stub; input_specs provides precomputed patch embeddings for the first S/8
positions plus 3-stream M-RoPE position ids."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, d_head=128, rope_theta=1e6,
        mrope_sections=(16, 24, 24), vision_len_ratio=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16,
        mrope_sections=(2, 3, 3), vision_len_ratio=8,
    )
