"""Attention in plain PyTorch (port of ``repro.models.attention``): blockwise
GQA with causal / sliding-window masking, and one-token decode attention
against a KV cache.

GQA is computed in grouped form [B, KV, G, ...], so repeated K/V heads are
never materialised. Scores are fp32; probabilities are cast to v's dtype
before the PV product, as in the reference.
"""
from __future__ import annotations

import torch

# The reference's mask value here; the kernels use -1e30 (kernels/ref.py).
NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, H, Dh] -> [B, S, KV, G, Dh]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _attn_chunk(
    q: torch.Tensor,  # [B, qc, KV, G, Dh]
    k: torch.Tensor,  # [B, Sk, KV, Dh]
    v: torch.Tensor,  # [B, Sk, KV, Dh]
    q_pos: torch.Tensor | None,  # [qc] global query positions (None = no mask)
    k_pos: torch.Tensor | None,  # [Sk]
    window: int | None,
) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    # fp32 scores from the working-dtype inputs (preferred_element_type=f32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if q_pos is not None:
        valid = k_pos[None, :] <= q_pos[:, None]  # causal
        if window is not None:
            valid &= k_pos[None, :] > (q_pos[:, None] - window)
        scores = torch.where(valid[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KV, Dh]
    v: torch.Tensor,  # [B, Sk, KV, Dh]
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Full-sequence attention, query-chunked when Sq > q_chunk (live score
    memory O(Sq_chunk * Sk) instead of O(Sq * Sk))."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = _grouped(q, kv)
    q_pos = torch.arange(sq, dtype=torch.int32, device=q.device) if causal else None
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device) if causal else None
    if sq <= q_chunk or sq % q_chunk != 0:
        return _attn_chunk(qg, k, v, q_pos, k_pos, window).reshape(b, sq, h, d)
    outs = [
        _attn_chunk(qg[:, i : i + q_chunk], k, v,
                    q_pos[i : i + q_chunk] if causal else None, k_pos, window)
        for i in range(0, sq, q_chunk)
    ]
    return torch.cat(outs, dim=1).reshape(b, sq, h, d)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, S_cache, KV, Dh]
    v_cache: torch.Tensor,  # [B, S_cache, KV, Dh]
    pos: int,  # position of the new token
    *,
    ring: bool = False,
) -> torch.Tensor:
    """One-token attention against a cache. ``ring=True`` marks a sliding-
    window ring buffer (every slot is valid once the buffer wrapped)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    s = k_cache.shape[1]
    qg = _grouped(q, kv)  # [B, 1, KV, G, Dh]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * d**-0.5
    n_valid = min(pos + 1, s) if ring else pos + 1
    valid = torch.arange(s, device=q.device) < n_valid
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, d)


def cache_insert(
    k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V at ``pos`` (mod cache length = ring semantics).

    Writes IN PLACE into ``k_cache`` and ``v_cache`` and returns them: the
    reference's serving loop donates the cache to the step, so nothing reads
    the old one afterwards."""
    slot = pos % k_cache.shape[1]
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
