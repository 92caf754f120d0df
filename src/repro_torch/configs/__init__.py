"""Architecture registry of the port: every architecture of the JAX package.

``get(name)`` returns the full-size config, ``get_smoke(name)`` the reduced
same-family config of the CPU tests; both are copies of the JAX package's.
An unknown name raises KeyError.
"""
from __future__ import annotations

import importlib

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


__all__ = [
    "ARCH_IDS", "LayerKind", "MambaConfig", "ModelConfig", "MoEConfig", "get", "get_smoke",
]
