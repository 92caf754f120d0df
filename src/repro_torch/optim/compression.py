"""Opt-in int8 gradient compression with error feedback (port of
``repro.optim.compression``).

Each gradient leaf is quantised to int8 per row with a per-row scale and
dequantised again, as the values a compressed all-reduce would deliver; the
error feedback residual carries the quantisation error into the next step
and lives in the optimizer state as ``ef_residual``.
"""
from __future__ import annotations

import torch

from ..tree import leaves, tree_map, unflatten


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation (rows along the first axis). Returns (q, scale)."""
    x32 = x.float()
    flat = x32.reshape(x32.shape[0] if x32.ndim > 1 else 1, -1)
    amax = flat.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its reciprocal, which rounds some
    # values otherwise than the division, so the card's codes would differ from the CPU's
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.float() * scale).reshape(shape)


def ef_compress_tree(grads, residual):
    """(dequantised grads in their own dtypes, new fp32 residual) for the
    gradient tree ``grads`` and the previous ``residual`` (None: zeros)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    new_g, new_r = [], []
    for g, r in zip(leaves(grads), leaves(residual)):
        g32 = g.float() + r
        q, s = compress_int8(g32)
        deq = decompress_int8(q, s, g32.shape)
        new_g.append(deq.to(g.dtype))
        new_r.append(g32 - deq)
    return unflatten(grads, new_g), unflatten(grads, new_r)
