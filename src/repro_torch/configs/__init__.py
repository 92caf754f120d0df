"""Architecture registry of the port: every architecture of the JAX package.

``get(name)`` returns the full-size config, ``get_smoke(name)`` the reduced
same-family config of the CPU tests; both are copies of the JAX package's.
An unknown name raises KeyError.

The shape grid of the dry-run (``SHAPES``) and its skip rule
(``cell_runnable``: long_500k only for a sub-quadratic architecture) are
copies of the JAX package's too.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from .base import LayerKind, MambaConfig, ModelConfig, MoEConfig

ARCH_IDS = ["qwen3_0_6b", "rwkv6_1_6b", "jamba_1_5_large_398b",
            "internlm2_20b", "phi3_mini_3_8b", "granite_3_2b",
            "seamless_m4t_large_v2", "qwen2_vl_7b", "mixtral_8x22b", "arctic_480b"]


def _module(name: str):
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; the port runs {ARCH_IDS}")
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if decoding at 500k context doesn't need a full-size KV cache."""
    return cfg.ssm is not None or cfg.attn_period > 0 or cfg.sliding_window is not None


def cell_runnable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """The skip rule of an (arch x shape) cell."""
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, (
            "long_500k skipped: pure full-attention architecture (O(S) KV "
            "cache at 524288 ctx; assignment mandates sub-quadratic only)"
        )
    return True, ""


__all__ = [
    "ARCH_IDS", "SHAPES", "Shape", "LayerKind", "MambaConfig", "ModelConfig", "MoEConfig", "get",
    "get_smoke", "cell_runnable", "is_subquadratic",
]
