"""Parameter trees from the JAX package into the port, leaf by leaf.

A JAX tree, turned into numpy arrays (``jax.tree.map(np.asarray, params)``),
becomes a tree of torch tensors with the same nested keys. bf16 arrives as
an ``ml_dtypes`` bfloat16 array; it crosses as its uint16 bit pattern, so
every value arrives bit for bit. With sharding rules, each leaf arrives as a
DTensor placed by ``param_defs(cfg, rules)``'s spec, every rank keeping its
own shard of the whole array it was given.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .distributed.sharding import distribute_local, placements
from .models import transformer as T
from .models.params import param_specs


def bf16_tensor_from_bits(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """A bf16 tensor whose bit patterns are the 16-bit array ``bits``."""
    bits = np.array(bits, order="C")  # own, writable copy: JAX hands out read-only views
    return torch.from_numpy(bits.view(np.uint16)).view(torch.bfloat16).to(device)


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes, detected without importing it
        return bf16_tensor_from_bits(arr.view(np.uint16), device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda", rules=None, cfg=None) -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``;
    with ``rules`` (and the model's ``cfg``), DTensors placed by
    ``param_defs(cfg, rules)``."""
    dev = resolve_device(device)
    if rules is None:
        specs = None
    elif cfg is None:
        raise ValueError("params_from_numpy: rules need the model's cfg to place the weights")
    else:
        specs = param_specs(T.param_defs(cfg, rules))

    def one(v, spec):
        t = tensor_from_numpy(np.asarray(v), dev)
        return t if spec is None else distribute_local(t, rules.mesh, placements(spec, rules.mesh))

    def walk(node, spec_node):
        return {k: walk(v, None if spec_node is None else spec_node[k]) if isinstance(v, dict)
                else one(v, None if spec_node is None else spec_node[k])
                for k, v in node.items()}

    return walk(tree, specs)
