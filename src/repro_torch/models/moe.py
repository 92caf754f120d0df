"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing with
capacity-based einsum dispatch.

The reference's dispatch/combine-tensor formulation, kept as it is: each
(token, slot) choice takes the next place in its expert's queue, counted over
the flattened (S, k) order of its batch row; choices past an expert's
capacity are dropped; the expert GEMMs run on a dense [E, B, C, D] buffer.
The auxiliary load-balancing loss (Switch-style, on the top-1 assignment)
keeps the router spread out.

Where torch and jax differ, the port computes what the reference does:

- Top-k order. ``jax.lax.top_k`` puts the lower expert index first among
  equal probabilities; ``torch.topk`` promises no order. The port takes the
  first k of a stable descending ``torch.sort``. The order of the k slots
  sets each choice's place in its queue, so it decides drops, not only ties.
- Dropped choices. ``jax.nn.one_hot`` gives a zero row for index -1;
  ``torch.nn.functional.one_hot`` raises on it. The dispatch compares the
  queue position (0 where dropped) with the capacity slots and masks the
  result by ``within``.
- Capacity is ``max(1, int(cf * s * k / e))`` in Python floats, in the
  reference's operand order; queue positions come from an fp32 cumsum.

``moe_ffn`` names its three parts as profiler ranges (``RANGES``): the
router and the dispatch and combine tensors with the gather into the expert
buffer (two ranges of that name a layer: the router's, then
``expert_ffn``'s), the expert GEMMs, and the combine back to tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..configs.base import MoEConfig

DISPATCH, EXPERTS, COMBINE = "moe dispatch", "moe experts", "moe combine"
RANGES = (DISPATCH, EXPERTS, COMBINE)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """Returns (gates [B,S,k] fp32, expert_idx [B,S,k], aux_loss fp32 scalar)."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ranked[..., : cfg.top_k], order[..., : cfg.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balancing loss (Switch-style): E * sum_e f_e * p_e
    e = w_router.shape[-1]
    assign = F.one_hot(idx[..., 0], e).float()  # top-1 assignment
    f = assign.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f * p)
    return gates, idx, aux


def moe_ffn(
    x: torch.Tensor,  # [B, S, D]
    w_router: torch.Tensor,  # [D, E]
    w1: torch.Tensor,  # [E, D, F]
    w3: torch.Tensor,  # [E, D, F]
    w2: torch.Tensor,  # [E, F, D]
    cfg: MoEConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D] in x's dtype, aux_loss fp32)."""
    with record_function(DISPATCH):
        gates, idx, aux = router_topk(x, w_router, cfg)
    return expert_ffn(x, gates, idx, w1, w3, w2, cfg), aux.float()


def expert_ffn(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """``moe_ffn`` after the router: each batch row's capacity queue, the
    dispatch, the expert GEMMs and the combine. Returns [B,S,D] in x's
    dtype. Every batch row is computed on its own, so a sharded run calls it
    on each rank's batch shard (``models/transformer.py``)."""
    b, s, d = x.shape
    e, k = w1.shape[0], cfg.top_k
    with record_function(DISPATCH):
        capacity = max(1, int(cfg.capacity_factor * s * k / e))
        # expert one-hot per (token, k-slot), flattened to the (S, k) order: [B, S*k, E]
        mask_flat = F.one_hot(idx, e).float().reshape(b, s * k, e)
        pos_in_expert = torch.cumsum(mask_flat, dim=1) * mask_flat - 1.0
        within = (pos_in_expert < capacity) & (pos_in_expert >= 0)
        # dispatch one-hot over capacity slots: [B, S*k, E, C]
        slot = torch.where(within, pos_in_expert, 0.0).long()
        slots = torch.arange(capacity, device=x.device)
        dispatch = ((slot[..., None] == slots) & within[..., None]).to(x.dtype)
        dispatch = dispatch.reshape(b, s, k, e, capacity)
        combine = torch.einsum("bskec,bsk->bsec", dispatch.float(), gates).to(x.dtype)
        dispatch = dispatch.sum(dim=2)  # [B, S, E, C]
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)  # [E, B, C, D]

    with record_function(EXPERTS):
        gate_h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, w1))
        lin_h = torch.einsum("ebcd,edf->ebcf", expert_in, w3)
        y = torch.einsum("ebcf,efd->ebcd", gate_h * lin_h, w2)  # [E, B, C, D]
    with record_function(COMBINE):
        return torch.einsum("bsec,ebcd->bsd", combine, y)
