"""Attention in plain PyTorch (port of ``repro.models.attention``): blockwise
GQA with causal / sliding-window masking, and one-token decode attention
against a KV cache, whole or, for a cache split along its slots, one slice
at a time (``decode_attention_part``, whose parts ``combine_decode_parts``
merges).

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


def decode_attention_part(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_part: torch.Tensor,  # [B, S_part, KV, Dh]: slots offset .. offset + S_part - 1 of the cache
    v_part: torch.Tensor,  # [B, S_part, KV, Dh]
    pos: int,  # position of the new token
    offset: int,  # the global index of the part's first slot
    n_slots: int,  # S_cache, the whole cache's length
    *,
    ring: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One part of ``decode_attention`` over a slice of the cache's slots,
    masked by the global slot index as ``decode_attention`` masks it.
    Returns, all fp32, the part's largest score m [B, 1, H], its sum of
    exponentials l = sum exp(s - m) [B, 1, H] and its unnormalised weighted
    sum of v, o = sum exp(s - m) v [B, 1, H, Dh]. o is computed as the part's
    softmax, cast to v's dtype and applied to v as ``decode_attention``
    applies its probabilities, times l: so a cache in one part gives
    ``decode_attention``'s output bit for bit where v is bf16 or fp16 (the
    combine's l o / l, within an fp32 ulp of o, rounds back to it; fp32
    keeps that ulp). A part with no slot has m = NEG_INF and
    l = o = 0; a part whose slots are all masked has m = NEG_INF, and the
    combine weighs it by exp(NEG_INF - max) = 0."""
    b, _, h, d = q.shape
    kv = k_part.shape[2]
    s = k_part.shape[1]
    if s == 0:
        m = torch.full((b, 1, h), NEG_INF, dtype=torch.float32, device=q.device)
        return m, torch.zeros_like(m), torch.zeros((b, 1, h, d), dtype=torch.float32, device=q.device)
    qg = _grouped(q, kv)  # [B, 1, KV, G, Dh]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_part.float()) * d**-0.5
    n_valid = min(pos + 1, n_slots) if ring else pos + 1
    valid = torch.arange(offset, offset + s, device=q.device) < n_valid
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)  # [B, KV, G, 1, 1]
    l = torch.exp(scores - m).sum(dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1).to(v_part.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v_part).float() * l.permute(0, 3, 1, 2, 4)
    return m.reshape(b, h, 1).transpose(1, 2), l.reshape(b, h, 1).transpose(1, 2), o.reshape(b, 1, h, d)


def rescale_decode_part(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                        m_max: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A part's (l, o) at the maximum ``m_max`` over every part (>= m):
    both times exp(m - m_max)."""
    c = torch.exp(m - m_max)
    return l * c, o * c[..., None]


def finish_decode(l: torch.Tensor, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The attention output [B, 1, H, Dh] from the sums over every part, in
    ``dtype`` (v's, as ``decode_attention`` returns it)."""
    return (o / l[..., None]).to(dtype)


def combine_decode_parts(parts: list, dtype: torch.dtype) -> torch.Tensor:
    """``decode_attention`` from the ``decode_attention_part`` of each slice
    of the cache, in one process: the largest m, each part rescaled to it,
    the sums added, divided and cast to ``dtype``. A sharded decode does the
    same with an all-reduce (max) of m and an all-reduce (sum) of l and o."""
    m_max = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    scaled = [rescale_decode_part(m, l, o, m_max) for m, l, o in parts]
    return finish_decode(sum(l for l, _ in scaled), sum(o for _, o in scaled), dtype)


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
