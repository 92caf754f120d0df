"""Mamba selective scan forward: the wrapper around the CUDA kernel in
``csrc/mamba.cu``.

It replaces ``repro.kernels.mamba.mamba_scan_bsd`` (the Pallas TPU kernel
``_mamba_kernel``). The kernel reads u, dt, B and C in the model layout
[B, S, Di] / [B, S, St] from their strides, so the wrapper makes no copies,
and takes any sequence length and any channel count. The kernel library is
built with nvcc on first use.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

STATE_SIZES = (4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("mamba").mamba_scan_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i, p, p, p, i, i, i, i] + [i64] * 10 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(u, dt, A, B_, C_, h0) -> None:
    named = {"u": u, "dt": dt, "A": A, "B": B_, "C": C_}
    if h0 is not None:
        named["h0"] = h0
    if u.device.type != "cuda" or any(t.device != u.device for t in named.values()):
        raise ValueError("mamba_scan_fwd needs all its tensors on one CUDA device, got "
                         + ", ".join(f"{n} on {t.device}" for n, t in named.items()))
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (dt, B_, C_)):
        raise ValueError(f"mamba_scan_fwd takes u, dt, B, C as float32 or bfloat16 alike, got "
                         f"{u.dtype}, {dt.dtype}, {B_.dtype}, {C_.dtype}")
    if u.dim() != 3 or dt.shape != u.shape or A.dim() != 2:
        raise ValueError(f"expected u, dt [B,S,Di] alike and A [Di,St], got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}")
    b, s, di = u.shape
    st = A.shape[1]
    if A.shape[0] != di or A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError(f"A must be a contiguous float32 [{di},{st}], got {A.dtype} {tuple(A.shape)}")
    if tuple(B_.shape) != (b, s, st) or tuple(C_.shape) != (b, s, st):
        raise ValueError(f"B and C must be [{b},{s},{st}], got {tuple(B_.shape)}, {tuple(C_.shape)}")
    if h0 is not None and (h0.dtype != torch.float32 or tuple(h0.shape) != (b, di, st)
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous float32 [{b},{di},{st}], got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if st not in STATE_SIZES:
        raise ValueError(f"state size {st} not in {STATE_SIZES}")
    if min(b, s, di) == 0 or b > 65535:
        raise ValueError(f"unsupported sizes B={b} S={s} Di={di}")
    if any(t.stride(2) != 1 for t in (u, dt, B_, C_)):
        raise ValueError("the last axis of u, dt, B and C must be contiguous")


def mamba_scan_fwd(
    u: torch.Tensor,  # [B, S, Di]
    dt: torch.Tensor,  # [B, S, Di]
    A: torch.Tensor,  # [Di, St] fp32
    B_: torch.Tensor,  # [B, S, St] in u's dtype
    C_: torch.Tensor,  # [B, S, St] in u's dtype
    h0: torch.Tensor | None = None,  # [B, Di, St] fp32; None: zeros
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; returns (y [B,S,Di] in
    u's dtype, final h [B,Di,St] fp32). Counts each launch in
    ``mamba_scan_fwd.launches``."""
    _check(u, dt, A, B_, C_, h0)
    fn = _kernel()
    b, s, di = u.shape
    st = A.shape[1]
    y = torch.empty((b, s, di), dtype=u.dtype, device=u.device)
    h = torch.empty((b, di, st), dtype=torch.float32, device=u.device)
    strides = [st_ for t in (u, dt, B_, C_, y) for st_ in t.stride()[:2]]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            _DTYPES[u.dtype], None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            b, s, di, st, *strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd: CUDA launch failed with cudaError_t {err}")
    mamba_scan_fwd.launches += 1
    return y, h


mamba_scan_fwd.launches = 0
