"""Public wrappers around the hand-written kernels, in the model layout.

Each takes its kernel's plain version (``ref.py``) for tensors that lie on
the CPU, and for CUDA tensors runs an ``autograd.Function`` whose forward
launches the kernel, once, or raises: a CUDA tensor never falls back to the
plain version. Its backward recomputes through the plain version and
returns that version's vector-Jacobian product, as the reference's
``custom_vjp``s do (``repro/kernels/ops.py``); there is no backward kernel.
Each backward runs inside a profiler range (``BACKWARD_RANGES``).
Under ``torch.inference_mode()`` or ``no_grad`` nothing is recorded, and the
forward is the one launch.

A wrapper refuses a DTensor (TypeError) rather than hand it to the plain
version or to a kernel's raw pointers: a sharded run calls it inside
``local_map``, on each rank's local shard (``models/transformer.py``).

Each kernel's forward is a ``torch.library.custom_op``
(``repro_torch::flash_attention_fwd``, ``::rwkv6_fwd``, ``::mamba_scan_fwd``)
that the ``autograd.Function`` calls. Its CUDA implementation is the kernel
wrapper (one launch, or it raises); it has no CPU implementation. Its fake
implementation returns empty outputs of the kernel's shapes and types, and
is the path only a meta or fake tensor takes, as the dry-run's stand-ins
do (``launch/dryrun.py``); its FLOP formula (``costs.py``) is registered
with ``torch.utils.flop_counter``, so ``FlopCounterMode`` counts the op.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from . import costs, ref
from .flash_attention import flash_attention_fwd as launch_flash_attention
from .mamba import mamba_scan_fwd as launch_mamba_scan
from .rwkv6 import rwkv6_fwd as launch_rwkv6

BACKWARD_RANGE = "flash_attention backward (attention_ref)"
RWKV6_BACKWARD_RANGE = "rwkv6 backward (rwkv6_ref)"
MAMBA_BACKWARD_RANGE = "mamba_scan backward (mamba_ref)"
BACKWARD_RANGES = (BACKWARD_RANGE, RWKV6_BACKWARD_RANGE, MAMBA_BACKWARD_RANGE)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(), device_types="cuda")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        window: int | None) -> torch.Tensor:
    return launch_flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_fwd.register_fake
def _(q, k, v, *, causal, window):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, *, causal, window, out_shape=None, **kwargs) -> int:
    b, sq, h, d = q_shape
    return costs.attention_flops(b, sq, k_shape[1], h, d, causal, window)


@torch.library.custom_op("repro_torch::rwkv6_fwd", mutates_args=(), device_types="cuda")
def rwkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
              state0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    return launch_rwkv6(r, k, v, logw, u, state0)


@rwkv6_fwd.register_fake
def _(r, k, v, logw, u, state0):
    b, _, h, d = r.shape
    return r.new_empty(r.shape), r.new_empty((b, h, d, d), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.rwkv6_fwd)
def _(r_shape, *args, out_shape=None, **kwargs) -> int:
    return costs.rwkv6_flops(*r_shape)


@torch.library.custom_op("repro_torch::mamba_scan_fwd", mutates_args=(), device_types="cuda")
def mamba_scan_fwd(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                   h0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    return launch_mamba_scan(u, dt, A, B_, C_, h0)


@mamba_scan_fwd.register_fake
def _(u, dt, A, B_, C_, h0):
    b, _, di = u.shape
    return u.new_empty(u.shape), u.new_empty((b, di, A.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.mamba_scan_fwd)
def _(u_shape, dt_shape, A_shape, *args, out_shape=None, **kwargs) -> int:
    return costs.mamba_flops(*u_shape, A_shape[1])


def _recompute_vjp(ctx, plain, n_diff: int, grads_out):
    """Gradients of ``plain(*saved, *ctx.static)`` with respect to the first
    ``n_diff`` saved inputs, for the output gradients ``grads_out``; None for
    an input that needs none or is None."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:n_diff]
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(saved, needs)]
        outputs = plain(*inputs, *ctx.static)
        outputs = outputs if isinstance(outputs, tuple) else (outputs,)
        # an output may depend on none of the inputs asked for (rwkv6's state on r)
        pairs = [(o, g) for o, g in zip(outputs, grads_out) if o.requires_grad]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if wrt and pairs else ())
    return tuple(next(got) if t is not None and t.requires_grad else None for t in inputs)


def _local_only(name: str, *tensors) -> None:
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, not DTensors: call it inside local_map on each "
                        "rank's shard")


class FlashAttention(torch.autograd.Function):
    """``flash_attention_fwd`` forward; backward through ``ref.attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.static = (causal, window)
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(BACKWARD_RANGE):  # names the recompute in a profile
            return _recompute_vjp(ctx, ref.attention_ref, 3, (g,)) + (None, None)


class RWKV6(torch.autograd.Function):
    """``rwkv6_fwd`` forward; backward through ``ref.rwkv6_ref``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        ctx.static = ()
        return rwkv6_fwd(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, g_out, g_state):
        with torch.profiler.record_function(RWKV6_BACKWARD_RANGE):
            return _recompute_vjp(ctx, ref.rwkv6_ref, 6, (g_out, g_state))


class MambaScan(torch.autograd.Function):
    """``mamba_scan_fwd`` forward; backward through ``ref.mamba_ref``. (Through
    ``models.ssm.mamba_scan_chunked``, whose remat would keep one 256-step
    chunk of residuals, A's gradient sums over the chunks in another order:
    on the card at jamba's width that is outside the 1e-5 the ops are held
    to, PERF.md §6.)"""

    @staticmethod
    def forward(ctx, u, dt, A, B_, C_, h0):
        ctx.save_for_backward(u, dt, A, B_, C_, h0)
        ctx.static = ()
        return mamba_scan_fwd(u, dt, A, B_, C_, h0)

    @staticmethod
    def backward(ctx, g_y, g_h):
        with torch.profiler.record_function(MAMBA_BACKWARD_RANGE):
            return _recompute_vjp(ctx, ref.mamba_ref, 6, (g_y, g_h))


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """q [B,Sq,H,Dh]; k/v [B,Sk,KV,Dh] -> [B,Sq,H,Dh]."""
    _local_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal, window)
    return FlashAttention.apply(q, k, v, causal, window)


def rwkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw [B,S,H,Dh]; u [H,Dh]; state0 [B,H,Dh,Dh] fp32 or None
    (zeros). Returns (out [B,S,H,Dh] in r's dtype, state [B,H,Dh,Dh] fp32)."""
    _local_only("rwkv6", r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return ref.rwkv6_ref(r, k, v, logw, u, state0)
    return RWKV6.apply(r, k, v, logw, u, state0)


def mamba_scan(
    u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt [B,S,Di]; A [Di,St] fp32; B_, C_ [B,S,St] in u's dtype; h0
    [B,Di,St] fp32 or None (zeros). Returns (y [B,S,Di] in u's dtype, h
    [B,Di,St] fp32)."""
    _local_only("mamba_scan", u, dt, A, B_, C_, h0)
    if u.device.type == "cpu":
        return ref.mamba_ref(u, dt, A, B_, C_, h0)
    return MambaScan.apply(u, dt, A, B_, C_, h0)
