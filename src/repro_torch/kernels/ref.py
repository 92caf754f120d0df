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


def rwkv6_ref(
    r: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # [B, S, H, Dh] (negative log decays)
    u: torch.Tensor,  # [H, Dh]
    state0: torch.Tensor | None = None,  # [B, H, Dh, Dh] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV recurrence in fp32:
    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ); S_t = diag(w_t) S_{t-1} + k_t v_tᵀ.
    Returns (out [B, S, H, Dh] in r's dtype, final S [B, H, Dh, Dh] fp32)."""
    b, s, h, dh = r.shape
    S = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device) if state0 is None
         else state0.float())
    r32, k32, v32, lw32 = (t.float() for t in (r, k, v, logw))
    u32 = u.float()[None, :, :, None]
    out = []
    for t in range(s):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        out.append(torch.einsum("bhd,bhde->bhe", r32[:, t], S + u32 * kv))
        S = torch.exp(lw32[:, t])[..., None] * S + kv
    return torch.stack(out, dim=1).to(r.dtype), S


def mamba_ref(
    u: torch.Tensor,  # [B, S, Di]
    dt: torch.Tensor,  # [B, S, Di]
    A: torch.Tensor,  # [Di, St]
    B_: torch.Tensor,  # [B, S, St]
    C_: torch.Tensor,  # [B, S, St]
    h0: torch.Tensor | None = None,  # [B, Di, St] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan in fp32:
    h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t; y_t = h_t · C_t.
    Returns (y [B, S, Di] in u's dtype, final h [B, Di, St] fp32)."""
    b, s, di = u.shape
    st = A.shape[-1]
    h = (torch.zeros((b, di, st), dtype=torch.float32, device=u.device) if h0 is None
         else h0.float())
    u32, dt32, b32, c32 = (t.float() for t in (u, dt, B_, C_))
    a32 = A.float()[None]
    ys = []
    for t in range(s):
        a = torch.exp(dt32[:, t, :, None] * a32)
        h = a * h + (dt32[:, t] * u32[:, t])[..., None] * b32[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c32[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h
