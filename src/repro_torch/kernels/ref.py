"""Plain PyTorch versions of the hand-written kernels.

They are the ground truth the kernels are held against on the card, and what
a kernel's wrapper computes for tensors that lie on the CPU. Each mirrors
its counterpart in ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KV, Dh]
    v: torch.Tensor,  # [B, Sk, KV, Dh]
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Direct softmax attention with GQA head repetition; fp32 softmax and
    PV product, output in q's dtype."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if kv != h:
        rep = h // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = cols <= rows
        if window is not None:
            mask &= cols > rows - window
        scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
