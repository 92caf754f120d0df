from .adamw import AdamW, clip_by_global_norm, cosine_schedule, global_norm
from .compression import compress_int8, decompress_int8

__all__ = [
    "AdamW", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "compress_int8", "decompress_int8",
]
