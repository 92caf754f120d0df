"""Architecture registry of the port: only the architectures the port runs.

``get(name)`` returns the full-size config, ``get_smoke(name)`` the reduced
same-family config of the CPU tests; both are copies of the JAX package's.
Asking for an architecture the port does not run yet raises and names the
``ROADMAP.md`` §A item that will add it.
"""
from __future__ import annotations

import importlib

from .base import LayerKind, MambaConfig, ModelConfig, MoEConfig

ARCH_IDS = ["qwen3_0_6b", "rwkv6_1_6b", "jamba_1_5_large_398b",
            "internlm2_20b", "phi3_mini_3_8b", "granite_3_2b",
            "seamless_m4t_large_v2", "qwen2_vl_7b", "mixtral_8x22b"]

# Architectures of the JAX package that the port does not run yet, with the
# ROADMAP.md §A item that brings each one.
NOT_PORTED = {
    "arctic_480b": "item 6 (MoE)",
}


def _module(name: str):
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        where = NOT_PORTED.get(name)
        if where is None:
            raise KeyError(f"unknown architecture {name!r}; the port runs {ARCH_IDS}")
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: ROADMAP.md §A {where}"
        )
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = [
    "ARCH_IDS", "NOT_PORTED", "LayerKind", "MambaConfig", "ModelConfig",
    "MoEConfig", "get", "get_smoke",
]
