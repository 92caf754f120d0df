"""Attention-free mixers (port of ``repro.models.ssm``): RWKV6 and Mamba.

Three paths for the RWKV6 (Finch) WKV recurrence, as in the reference:
  - ``rwkv6_naive``  : step by step over time — the oracle, which is the
                       kernel's plain version ``kernels.ref.rwkv6_ref``;
  - ``rwkv6_chunked``: the chunk-parallel form of train and prefill when the
                       kernel is off (falls back to naive when S % 16 != 0);
  - ``rwkv6_step``   : the single-token decode update.

Numerics: the per-channel log-decay is clamped to ``-MAX_DECAY`` per step
and chunks are short (16), so ``exp(±Σ log w)`` stays inside fp32 range.

And for the Mamba selective scan:
  - ``mamba_conv``        : the depthwise causal conv, K shifted adds;
  - ``mamba_scan_naive``  : the sequential scan — the oracle, which is the
                            kernel's plain version ``kernels.ref.mamba_ref``;
  - ``mamba_scan_chunked``: train and prefill when the kernel is off, chunk
                            by chunk (falls back to naive unless S is a
                            multiple of the chunk above one chunk);
  - ``mamba_step``        : the single-token decode update.

While autograd records, both chunked forms run each chunk under
``torch.utils.checkpoint``, as the reference wraps its chunk body in
``jax.checkpoint``: the forward keeps each chunk's inputs and the carried
state, and the backward recomputes one chunk at a time, so the residuals
held are one chunk's, not the whole sequence's. Values and gradients are
those of the same loop without it, bit for bit.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ref import mamba_ref as mamba_scan_naive
from ..kernels.ref import rwkv6_ref as rwkv6_naive

MAX_DECAY = 4.0  # clamp on exp(w_raw): decay factor >= exp(-4) per step
RWKV_CHUNK = 16
MAMBA_CHUNK = 256


def rwkv6_decay(w_raw: torch.Tensor) -> torch.Tensor:
    """Raw decay projection -> log decay in [-MAX_DECAY, 0), in fp32."""
    return -torch.exp(w_raw.float()).clamp(max=MAX_DECAY)


def _remat(fn, *args):
    """``fn(*args)``, under ``checkpoint`` while autograd records (the chunk
    draws no random numbers, so no RNG state is kept)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _wkv_chunk(r_c, k_c, v_c, lw_c, u32, state, tri, eye):
    """One chunk of :func:`rwkv6_chunked`: inputs [B, L, H, Dh] fp32, state
    [B, H, Dh, Dh] fp32. Returns (out [B, L, H, Dh] fp32, state)."""
    la = torch.cumsum(lw_c, dim=1)  # inclusive log-decay products
    q_ = r_c * torch.exp(la - lw_c)  # r_t * A_{t-1}
    k_ = k_c * torch.exp(-la)  # k_s / A_s
    scores = torch.einsum("blhd,bmhd->bhlm", q_, k_) * tri
    diag = torch.einsum("blhd,hd,blhd->bhl", r_c, u32, k_c)
    scores = scores + torch.einsum("bhl,lm->bhlm", diag, eye)
    intra = torch.einsum("bhlm,bmhd->blhd", scores, v_c)
    cross = torch.einsum("blhd,bhde->blhe", q_, state)
    la_last = la[:, -1]  # [B, H, Dh]
    kd = k_c * torch.exp(la_last[:, None] - la)
    state = state * torch.exp(la_last)[..., None] + torch.einsum("blhd,blhe->bhde", kd, v_c)
    return intra + cross, state


def rwkv6_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state0: torch.Tensor | None = None, chunk: int = RWKV_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV: intra-chunk via a masked score matrix, cross-chunk
    via the carried state. Matches :func:`rwkv6_naive` to fp32 tolerance."""
    b, s, h, dh = r.shape
    if s % chunk != 0:  # fall back (decode tails etc.)
        return rwkv6_naive(r, k, v, logw, u, state0)
    state = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
             if state0 is None else state0)
    n = s // chunk
    rs, ks, vs, lws = (t.float().reshape(b, n, chunk, h, dh) for t in (r, k, v, logw))
    u32 = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device), diagonal=-1)  # s < t strictly
    eye = torch.eye(chunk, device=r.device)
    outs = []
    for c in range(n):
        out, state = _remat(_wkv_chunk, rs[:, c], ks[:, c], vs[:, c], lws[:, c], u32, state, tri, eye)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(b, s, h, dh)
    return out.to(r.dtype), state


def rwkv6_step(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode. Inputs [B, H, Dh]; state [B, H, Dh, Dh] fp32.
    Returns (out [B, H, Dh] fp32, new state)."""
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhd,bhde->bhe", r, state + u.float()[None, :, :, None] * kv)
    new_state = torch.exp(logw)[..., :, None] * state + kv
    return out, new_state


# ====================================================================== Mamba
def mamba_conv(
    x: torch.Tensor,  # [B, S, Di]
    conv_w: torch.Tensor,  # [Di, K]
    conv_b: torch.Tensor,  # [Di]
    conv_state: torch.Tensor | None = None,  # [B, K-1, Di] trailing context
) -> torch.Tensor:
    """Depthwise causal conv along time via K shifted adds."""
    k = conv_w.shape[-1]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # [B, S+K-1, Di]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i : i + x.shape[1], :] * conv_w[:, i]
    return out + conv_b


def mamba_scan_chunked(
    u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
    h0: torch.Tensor | None = None, chunk: int = MAMBA_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked scan: a loop over chunks, each a sequential
    scan from the carried state, the same steps in the same order as
    :func:`mamba_scan_naive`. Under autograd each chunk is rematerialised,
    which keeps the backward's residuals at one chunk's steps (the
    reference's O(S/chunk · state)); only A's gradient, summed per chunk,
    may differ from the naive scan's in rounding."""
    s = u.shape[1]
    if s % chunk != 0 or s <= chunk:
        return mamba_scan_naive(u, dt, A, B_, C_, h0)
    h, ys = h0, []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        y, h = _remat(mamba_scan_naive, u[:, sl], dt[:, sl], A, B_[:, sl], C_[:, sl], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_step(
    u_t: torch.Tensor,  # [B, Di]
    dt_t: torch.Tensor,  # [B, Di]
    A: torch.Tensor,  # [Di, St]
    b_t: torch.Tensor,  # [B, St]
    c_t: torch.Tensor,  # [B, St]
    h: torch.Tensor,  # [B, Di, St]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode. Returns (y [B, Di] fp32, new h [B, Di, St]): as
    in the reference, y is fp32 whatever the inputs' dtype; the mixer casts
    it to the model dtype."""
    u_t, dt_t, b_t, c_t = (t.float() for t in (u_t, dt_t, b_t, c_t))
    a = torch.exp(dt_t[..., None] * A[None])
    h = a * h + (dt_t * u_t)[..., None] * b_t[:, None, :]
    return torch.einsum("bds,bs->bd", h, c_t), h
