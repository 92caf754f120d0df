"""Plain fp32 reference of a decoder whose FFN is a top-k mixture of experts
(Mixtral's family): ``dense.py``'s attention, norms and head, and in each
layer the expert FFN as the published config and the configuration file's
``capacity_factor`` describe it.

Routing: softmax over the router's logits (fp32), the top-k experts with
the lower index first among equal probabilities, their gates renormalised
to sum to 1. Capacity: each expert takes at most ``max(1, int(cf * S * k /
E))`` choices of a sequence; the choices queue in the order of the
flattened (S, k) grid, token by token and, within a token, best expert
first, and a choice past its expert's capacity is dropped (its gate's
share is lost, not handed on). Each kept choice adds gate x SwiGLU_e(x).
The queue positions are counted with an integer cumsum; the experts run
one at a time on the rows routed to them, so an 8,192-token prompt fits.

It imports torch and ``dense.py`` alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dense


def route(h2d: torch.Tensor, router: torch.Tensor, conf: dict, arith: dense.Arith):
    """(gates [N, k] fp32, experts [N, k]) of N tokens."""
    probs = torch.softmax(arith.mm(h2d, router.float()), dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = conf["num_experts_per_tok"]
    gates = ranked[:, :k]
    return gates / gates.sum(dim=-1, keepdim=True), order[:, :k]


def expert_ffn(h: torch.Tensor, w: dict, conf: dict, arith: dense.Arith) -> torch.Tensor:
    """The expert FFN of h [B, S, D], each sequence with its own queues."""
    b, s, d = h.shape
    e, k = conf["num_local_experts"], conf["num_experts_per_tok"]
    capacity = max(1, int(conf["capacity_factor"] * s * k / e))
    out = torch.zeros_like(h)
    for row in range(b):
        gates, experts = route(h[row], w["router"], conf, arith)
        flat = experts.reshape(-1)  # (S, k) order
        onehot = F.one_hot(flat, e)
        place = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        kept = place < capacity
        token = torch.arange(s, device=h.device).repeat_interleave(k)
        gate = gates.reshape(-1)
        for ex in range(e):
            sel = kept & (flat == ex)
            rows = token[sel]
            if rows.numel() == 0:
                continue
            y = dense.swiglu(h[row, rows], w["e_w1"][ex], w["e_w3"][ex], w["e_w2"][ex], arith)
            out[row].index_add_(0, rows, y * gate[sel, None])
    return out


def ffn_sublayer(x, w: dict, n: dict, conf: dict, arith: dense.Arith):
    return x + expert_ffn(dense.rmsnorm(x, w["ln2"], n["eps"]), w, conf, arith)


def prefill(weights: dict, tokens: torch.Tensor, conf: dict, precision: str = "fp32") -> dict:
    return dense.prefill(weights, tokens, conf, precision, ffn=ffn_sublayer)


def train(*args, **kwargs):
    raise NotImplementedError("no MoE training cell: the MoE reference follows the prompt phase only "
                              "(the router's load-balancing loss is not in it)")
