"""AdamW (port of ``repro.optim.adamw``).

The update runs in fp32 over parameters of any dtype and writes the new
values back in place under ``torch.no_grad()`` (the counterpart of the
reference's ``donate_argnums``); the moments are kept in ``moment_dtype``.
The step is a 0-d int32 tensor, and the bias corrections and the schedule
are computed from it in fp32, as the reference computes them, so the update
is the reference's to fp32 rounding. The state has the reference's tree
paths (``m``, ``v``, ``step``), so a checkpoint's leaf paths and annex keys
match across the packages.

So that the state of a model that all but fills the card still fits, the
clipping scales each gradient in place and the update walks each leaf in
flat slices of ``SLICE`` elements: the fp32 temporaries are a slice's, not
a leaf's, and every element gets the same fp32 arithmetic as a whole-leaf
update, so the results are the same bits.

Sharded (DTensor) parameters: the moments are made with ``zeros_like`` and
so carry their parameters' placements, as the reference's moments inherit
their parameters' shardings; each gradient is first redistributed to its
parameter's placements (a gradient may come back ``Partial``), and the
global norm reduces over the DTensors to one replicated scalar.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from ..tree import leaves, tree_map

SLICE = 1 << 24  # elements a step of the update or the clipping takes at once: 64 MiB in fp32


def _slices(*tensors) -> list[tuple]:
    """Aligned flat slices of at most ``SLICE`` elements of tensors of one
    shape; the tensors whole where one is a DTensor or not contiguous."""
    if any(isinstance(t, DTensor) or not t.is_contiguous() for t in tensors):
        return [tensors]
    flat = [t.view(-1) for t in tensors]
    return [tuple(f[i : i + SLICE] for f in flat) for i in range(0, flat[0].numel(), SLICE)]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to at most ``max_norm`` in global norm, each leaf rounded
    back to its own dtype; the norm before clipping). A plain tensor's leaf
    is scaled in place, slice by slice, to the values ``(g.float() *
    scale).to(g.dtype)`` gives; a DTensor's leaf is a new tensor."""
    norm = global_norm(tree)
    # full_like: a Python number over a tensor would multiply by its reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9), max=1.0)
    seen = set()

    def own(g):  # autograd may hand one storage to two leaves: each is scaled once
        if isinstance(g, DTensor):
            return g
        if g.untyped_storage()._cdata in seen:
            g = g.clone()
        seen.add(g.untyped_storage()._cdata)
        return g

    def scaled(g):
        if isinstance(g, DTensor):
            return (g.float() * scale).to(g.dtype)
        for (part,) in _slices(g):
            part.copy_(part.float() * scale)
        return g

    return tree_map(scaled, tree_map(own, tree)), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    moment_dtype: str = "float32"

    def _mdt(self) -> torch.dtype:
        return torch.bfloat16 if self.moment_dtype == "bfloat16" else torch.float32

    def init(self, params) -> dict:
        mdt = self._mdt()
        device = leaves(params)[0].device

        def zeros(p):
            if isinstance(p, DTensor):
                return torch.zeros_like(p, dtype=mdt)
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """Clip ``grads``, then update ``params`` and the moments of ``state``
        in place. Returns (params, {"m", "v", "step"}, {"grad_norm", "lr"})."""
        grads = tree_map(_placed_like, grads, params)
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        t = step.float()
        bc1, bc2 = 1 - self.b1**t, 1 - self.b2**t
        b1, b2 = self.b1, self.b2
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), leaves(params)):
            wd = self.weight_decay if p.ndim >= 2 else 0.0  # the stacked norms [R, D] get decay, as there
            for gs, ms, vs, ps in _slices(g, m, v, p):
                g32 = gs.float()
                m32 = b1 * ms.float() + (1 - b1) * g32
                v32 = b2 * vs.float() + (1 - b2) * g32.square()
                mhat = m32 / bc1
                vhat = v32 / bc2
                p32 = ps.float()
                ps.copy_(p32 - lr * (mhat / (vhat.sqrt() + self.eps) + wd * p32))
                ms.copy_(m32)
                vs.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": torch.as_tensor(lr, dtype=torch.float32, device=step.device),
        }
