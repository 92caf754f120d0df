"""Public wrappers around the hand-written kernels, in the model layout.

Each takes its kernel's plain version (``ref.py``) for tensors that lie on
the CPU, and launches the kernel for CUDA tensors, or raises: a CUDA tensor
never falls back to the plain version. Forward only for now; the backward
through the plain version comes with the training slice.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd
from .mamba import mamba_scan_fwd
from .rwkv6 import rwkv6_fwd


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """q [B,Sq,H,Dh]; k/v [B,Sk,KV,Dh] -> [B,Sq,H,Dh]."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)


def rwkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw [B,S,H,Dh]; u [H,Dh]; state0 [B,H,Dh,Dh] fp32 or None
    (zeros). Returns (out [B,S,H,Dh] in r's dtype, state [B,H,Dh,Dh] fp32)."""
    if r.device.type == "cpu":
        return ref.rwkv6_ref(r, k, v, logw, u, state0)
    return rwkv6_fwd(r, k, v, logw, u, state0)


def mamba_scan(
    u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt [B,S,Di]; A [Di,St] fp32; B_, C_ [B,S,St] in u's dtype; h0
    [B,Di,St] fp32 or None (zeros). Returns (y [B,S,Di] in u's dtype, h
    [B,Di,St] fp32)."""
    if u.device.type == "cpu":
        return ref.mamba_ref(u, dt, A, B_, C_, h0)
    return mamba_scan_fwd(u, dt, A, B_, C_, h0)
