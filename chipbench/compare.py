"""The numbers ``correct`` compares, each against the cell's limit
(``limits/<workload>.json``), and the lines that show them.

Prompt phase, over the sampled batches, against the fp32 reference:

- ``kv_err``: the worst layer's relative error of the KV cache,
  ||cache - ref|| / ||ref|| over the batch, of K (after RoPE) or V;
- ``kv_tok_med``: the worst layer's median over tokens of each token's
  relative error of K or V (steady where a few tokens take another expert:
  a route that flips on rounding moves its token's state whole);
- ``logit_err``: the worst row's relative error of the last position's
  logits over the real vocabulary; ``logit_med``: the median row's (the
  lower median), over every row of every sampled batch (steady where a
  route that flips on rounding moves a few rows' last state whole);
- ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position (the last: the one
  position a prompt phase serves);
- ``served_gap``: the widest gap by which a served token's logit lies below
  the best of the program's own logits at that position (0 where the
  served token is their argmax; an exact comparison).

Training, over the checked first steps, against the reference's steps:

- ``loss_gap``: the largest |loss - ref loss| of a step (nats);
- ``grad_gap``: the worst leaf's |norm - ref norm| of the first step's
  clipped gradient, read from AdamW's first moment after one step (m / (1 -
  b1)), over the larger of the leaf's ref norm and the median leaf's;
- ``change_gap``: the same of each leaf's change of weights over the
  checked steps, leaving out the leaves whose ref gradient is under a
  thousandth of the median leaf's (a gradient that is nought to rounding
  moves a weight under Adam by round-off alone).
"""
from __future__ import annotations

import math
import statistics
import sys

import torch

NOUGHT = 1e-3  # a leaf whose first gradient is under this share of the median leaf's is nought


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def cache_at(cache: torch.Tensor, s: int, window: int | None) -> torch.Tensor:
    """The cache's entries of positions 0..S-1 in position order ([B, S',
    KV, Dh], S' = the positions it holds): a ring of L slots holds token t at
    slot t % L for the last L tokens."""
    slots = cache.shape[1]
    if window is None or s <= slots:
        return cache[:, :s]
    pos = torch.arange(s - slots, s, device=cache.device)
    return cache[:, pos % slots]


def prompt_numbers(cache_k: list, cache_v: list, last_logits: torch.Tensor, served: torch.Tensor,
                   ref: dict, vocab: int, window: int | None) -> dict:
    """The numbers of one batch, with each row's logit error under
    ``logit_rows`` for ``merge_prompt``. ``cache_k``/``cache_v``: each
    layer's cache [B, L, KV, Dh]; ``last_logits`` [B, >= V]; ``served``
    [B, 1], the tokens served at the last position."""
    s = ref["k"][0].shape[1]
    kv = med = out = 0.0
    for ck, cv, rk, rv in zip(cache_k, cache_v, ref["k"], ref["v"], strict=True):
        for c, r in ((ck, rk), (cv, rv)):
            c = cache_at(c, s, window)
            r = r[:, s - c.shape[1]:]
            kv = max(kv, rel_err(c, r))
            tok = ((c.float() - r).flatten(2).norm(dim=-1) / r.flatten(2).norm(dim=-1).clamp(min=1e-30)).flatten()
            m = tok.median().item()
            med, out = max(med, m), max(out, (tok > 10 * m).float().mean().item())
    rows = [rel_err(last_logits[b, :vocab], ref["last_logits"][b]) for b in range(last_logits.shape[0])]
    at = ref["last_logits"]
    gap = (at.amax(dim=-1) - at.gather(-1, served.long()).squeeze(-1)).amax().item()
    own = last_logits[:, :vocab].float()
    served_gap = (own.amax(dim=-1) - own.gather(-1, served.long()).squeeze(-1)).amax().item()
    # kv_outliers (not compared): the largest share of a layer's tokens more than 10x its median error
    return {"kv_err": kv, "kv_tok_med": med, "kv_outliers": out, "token_gap": gap, "served_gap": served_gap,
            "logit_rows": rows}


def merge_prompt(numbers: list[dict]) -> dict:
    """The numbers of several batches: the worst of each batch's, and of the
    rows' logit errors the worst (``logit_err``) and the lower median
    (``logit_med``)."""
    rows = [x for n in numbers for x in n["logit_rows"]]
    scalars = merge([{k: v for k, v in n.items() if k != "logit_rows"} for n in numbers])
    return {**scalars, "logit_err": max(rows), "logit_med": statistics.median_low(rows)}


def worst_leaf(prog: dict, ref: dict, leaves=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref); a leaf the
    program lacks raises."""
    med = statistics.median(ref.values())
    names = ref if leaves is None else leaves
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad1"].values())
    moving = [n for n, g in ref["grad1"].items() if g >= NOUGHT * med]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"], strict=True)),
        "grad_gap": worst_leaf(prog["grad1"], ref["grad1"]),
        "change_gap": worst_leaf(prog["change"], ref["change"], moving),
    }


def merge(numbers: list[dict]) -> dict:
    """The worst of each number over several batches."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at most its limit; every limit needs its number."""
    shown = {name: {"value": numbers.get(name, math.nan), "limit": lim} for name, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


def print_checks(shown: dict) -> None:
    for name, v in shown.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
