"""RWKV6 WKV recurrence forward: the wrapper around the CUDA kernel in
``csrc/rwkv6.cu``.

It replaces ``repro.kernels.rwkv6.rwkv6_bhsd`` (the Pallas TPU kernel
``_rwkv6_kernel``). The kernel reads r, k, v and logw in the model layout
[B, S, H, Dh] from their strides, so the wrapper makes no transposed copies,
and takes any sequence length. The kernel library is built with nvcc on
first use.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("rwkv6").rwkv6_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i, p, i, p, p, p, i, i, i, i] + [i64] * 15 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(r, k, v, logw, u, state0) -> None:
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    if state0 is not None:
        named["state0"] = state0
    if r.device.type != "cuda" or any(t.device != r.device for t in named.values()):
        raise ValueError("rwkv6_fwd needs all its tensors on one CUDA device, got "
                         + ", ".join(f"{n} on {t.device}" for n, t in named.items()))
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, logw)):
        raise ValueError(f"rwkv6_fwd takes r, k, v, logw as float32 or bfloat16 alike, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}, {logw.dtype}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"u must be float32 or bfloat16, got {u.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"expected r, k, v, logw alike [B,S,H,Dh], got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(logw.shape)}")
    b, s, h, d = r.shape
    if tuple(u.shape) != (h, d) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous [{h},{d}], got {tuple(u.shape)}")
    if state0 is not None and (state0.dtype != torch.float32 or tuple(state0.shape) != (b, h, d, d)
                               or not state0.is_contiguous()):
        raise ValueError(f"state0 must be a contiguous float32 [{b},{h},{d},{d}], got "
                         f"{state0.dtype} {tuple(state0.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(b, s, h) == 0 or 2 * b * h >= 2**31:  # up to two blocks per (b, h)
        raise ValueError(f"unsupported sizes B={b} S={s} H={h}")
    if any(t.stride(3) != 1 for t in (r, k, v, logw)):
        raise ValueError("the head dim of r, k, v and logw must be contiguous")


def rwkv6_fwd(
    r: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # [B, S, H, Dh] log decays, in r's dtype
    u: torch.Tensor,  # [H, Dh]
    state0: torch.Tensor | None = None,  # [B, H, Dh, Dh] fp32; None: zeros
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; returns (out [B,S,H,Dh]
    in r's dtype, final state [B,H,Dh,Dh] fp32). Counts each launch in
    ``rwkv6_fwd.launches``."""
    _check(r, k, v, logw, u, state0)
    fn = _kernel()
    b, s, h, d = r.shape
    out = torch.empty((b, s, h, d), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    strides = [st for t in (r, k, v, logw, out) for st in t.stride()[:3]]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), _DTYPES[r.dtype],
            u.data_ptr(), _DTYPES[u.dtype], None if state0 is None else state0.data_ptr(),
            out.data_ptr(), state.data_ptr(), b, s, h, d, *strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_fwd: CUDA launch failed with cudaError_t {err}")
    rwkv6_fwd.launches += 1
    return out, state


rwkv6_fwd.launches = 0
