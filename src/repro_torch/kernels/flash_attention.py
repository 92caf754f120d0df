"""Flash attention forward: the wrapper around the CUDA kernel in
``csrc/flash_attention.cu``.

It replaces ``repro.kernels.flash_attention.flash_attention_bhsd`` (the
Pallas TPU kernel ``_flash_fwd_kernel``). The kernel reads q, k and v in the
model layout [B, S, heads, Dh] from their strides, so the wrapper makes no
transposed copies. bfloat16 runs on the tensor cores with TMA loads, which
need q, k and v to start on 16 bytes and their strides to be multiples of 16
bytes; float32 runs on the CUDA cores. The kernel library is built with nvcc
on first use.
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
        fn = build.load("flash_attention").flash_attention_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i] + [i64] * 12 + [i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd takes float32 or bfloat16 alike, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,Dh] and k, v [B,Sk,KV,Dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match as GQA")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(b, sq, sk) == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes B={b} Sq={sq} Sk={sk} H={h}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)):
                raise ValueError(f"bfloat16 {name} must start on 16 bytes and have strides that are "
                                 f"multiples of 8 elements (TMA), got strides {t.stride()}")


def flash_attention_fwd(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KV, Dh]
    v: torch.Tensor,  # [B, Sk, KV, Dh]
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns [B, Sq, H, Dh]
    in q's dtype. Counts each launch in ``flash_attention_fwd.launches``."""
    _check(q, k, v, window)
    fn = _kernel()
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            b, sq, sk, h, kv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            int(causal), window or 0, d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed with cudaError_t {err}")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
