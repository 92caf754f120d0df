"""Shared neural building blocks (port of ``repro.models.layers``).

Norm statistics accumulate in fp32; matmuls run in the model compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import distribute_local


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary half-dims: [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] (int)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary half-dims are split into sections
    (temporal / height / width), each rotated by its own position stream.

    x: [B, S, H, Dh]; positions3: [3, B, S] (int); sum(sections) == Dh // 2.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not add up to half the head dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    # each section's frequencies turn by its own stream: the streams are
    # expanded over their sections rather than gathered by a [half] index of
    # stream ids, which would be a tensor to copy to the device (and
    # repeat_interleave's output size one to read back) on every call
    pos = torch.cat([positions3[i, :, :, None].expand(-1, -1, n) for i, n in enumerate(sections)], dim=-1)
    angles = pos.float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- loss
def _lse_sharded(logits: DTensor) -> DTensor:
    """logsumexp over the last dim of DTensor logits from each rank's vocab
    shard: a max and a sum reduced across ranks ([B, S] each), where
    ``torch.logsumexp`` on a vocab-sharded DTensor all-gathers the logits."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    return (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))).squeeze(-1)


def _gold_sharded(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """The gold logit of DTensor logits by the reference's one-hot
    contraction (``repro/models/layers.py:74-75``): each rank multiplies its
    own vocab shard and the sum over the vocab reduces partial sums, so
    vocab-sharded logits are never gathered. (DTensor's gather on a sharded
    dim gives a masked partial sum, which fails on a second call.) The
    labels take the logits' placements of their leading dims."""
    mesh = logits.device_mesh
    place = [p if isinstance(p, Shard) and p.dim < labels.ndim else Replicate() for p in logits.placements]
    labels = (labels.redistribute(mesh, place) if isinstance(labels, DTensor)
              else distribute_local(labels, mesh, place))
    return (logits * F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32. The gold logit is gathered rather
    than picked by the reference's one-hot product (a [B*S, V] fp32 one-hot
    is 2.5 GB at B=8, S=512, V=152064); the value is the same, since that
    product's sum has one nonzero term."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        lse, gold = _lse_sharded(logits), _gold_sharded(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
