"""Parameter trees from the JAX package into the port, leaf by leaf.

A JAX tree, turned into numpy arrays (``jax.tree.map(np.asarray, params)``),
becomes a tree of torch tensors with the same nested keys. bf16 arrives as
an ``ml_dtypes`` bfloat16 array; it crosses as its uint16 bit pattern, so
every value arrives bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def bf16_tensor_from_bits(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """A bf16 tensor whose bit patterns are the 16-bit array ``bits``."""
    bits = np.array(bits, order="C")  # own, writable copy: JAX hands out read-only views
    return torch.from_numpy(bits.view(np.uint16)).view(torch.bfloat16).to(device)


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes, detected without importing it
        return bf16_tensor_from_bits(arr.view(np.uint16), device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        return {
            k: walk(v) if isinstance(v, dict) else tensor_from_numpy(np.asarray(v), dev)
            for k, v in node.items()
        }

    return walk(tree)
