"""Training, prefill and decode step functions (port of ``repro.train.steps``).

``make_train_step`` is the next-token objective with the vocabulary's pad
columns masked, plus the MoE layers' load-balancing loss weighted by
``cfg.moe.router_aux_weight`` (0 for a model without MoE layers), optional microbatch accumulation, optional int8 error-feedback
compression of the gradients, clipping and the AdamW update, which writes
the parameters in place. The serving steps run under
``torch.inference_mode()``. Every step hands the whole batch to the model:
the tokens and, for encoder-decoder and VLM configs, the stub frontends'
``encoder_embeds``, ``vision_embeds`` and ``positions3``.

Every step takes ``rules=None`` as a keyword. With sharding rules the params
and optimizer state are DTensors placed by ``param_defs(cfg, rules)``; the
forward and the backward run inside ``sharded_region(rules)``, and the
serving steps under ``torch.no_grad()`` rather than ``inference_mode()``,
whose tensors DTensor's views refuse.

Each microbatch's forward and loss run in the ``train forward`` span and
``AdamW.update`` in ``adamw update`` (``spans.py``), while a profiler runs.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import sharded_region
from ..models import transformer as T
from ..models.layers import cross_entropy
from ..optim.adamw import AdamW
from ..optim.compression import ef_compress_tree
from ..spans import TRAIN_FORWARD, span
from ..tree import leaves, unflatten


def masked_loss(logits: torch.Tensor, tokens: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """Shifted next-token cross-entropy; the pad columns past ``real_vocab``
    are set to -1e9 (in the logits' dtype) so they drop out of the lse."""
    vp = logits.shape[-1]
    if vp != real_vocab:
        col = torch.arange(vp, device=logits.device)
        logits = torch.where(col < real_vocab, logits, -1e9)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


def _split_microbatches(batch: dict, n: int) -> dict:
    """Every input reshaped on its batch axis to [n, B/n, ...]: ``positions3``
    carries the batch on axis 1, everything else on axis 0."""
    out = {}
    for k, v in batch.items():
        ax = 1 if k == "positions3" else 0
        b = v.shape[ax]
        if b % n:
            raise ValueError(f"{k}: batch {b} does not split into {n} microbatches")
        out[k] = torch.movedim(v.reshape(v.shape[:ax] + (n, b // n) + v.shape[ax + 1 :]), ax, 0)
    return out


def accumulate_grads(gsum: list, grads) -> None:
    """Add one microbatch's gradient leaves into the fp32 accumulators ``gsum``."""
    for a, g in zip(gsum, grads):
        a.add_(g.float())


def mean_grads_bf16(gsum: list, n: int):
    """Yields each leaf of the mean of ``n`` microbatches' accumulated
    gradients ``gsum``, cast to bf16."""
    scale = 1.0 / n
    return ((g * scale).to(torch.bfloat16) for g in gsum)


def make_grad_fn(cfg: ModelConfig, *, rules=None):
    """``grads_of(params, batch) -> (loss, aux, grads)``: the loss and aux
    loss as fp32 scalars and the gradient tree of the weighted loss. Each
    parameter is marked as needing a gradient. With ``cfg.microbatches > 1``
    the batch runs in microbatches whose gradients add up in fp32; the mean
    is then cast to bf16, whatever the parameters' dtype, as the reference
    casts it."""
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    n_mb = max(1, cfg.microbatches)

    def one(params, batch):
        flat = [p.requires_grad_() for p in leaves(params)]
        with sharded_region(rules):
            with span(TRAIN_FORWARD):  # the backward runs on autograd's own thread: no span holds it
                logits, aux = T.forward_train(cfg, params, batch, rules=rules)
                loss = masked_loss(logits, batch["tokens"], cfg.vocab_size)
                objective = loss + aux_w * aux
            grads = torch.autograd.grad(objective, flat)
        return loss.detach(), aux.detach(), grads

    def grads_of(params, batch):
        if n_mb == 1:
            loss, aux, grads = one(params, batch)
            return loss, aux, unflatten(params, grads)
        mbs = _split_microbatches(batch, n_mb)
        loss_sum = aux_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)]
        for i in range(n_mb):
            loss, aux, grads = one(params, {k: v[i] for k, v in mbs.items()})
            accumulate_grads(gsum, grads)
            loss_sum, aux_sum = loss_sum + loss, aux_sum + aux
        scale = 1.0 / n_mb
        return loss_sum * scale, aux_sum * scale, unflatten(params, mean_grads_bf16(gsum, n_mb))

    return grads_of


def make_train_step(cfg: ModelConfig, optimizer: AdamW, compress_grads: bool = False, *, rules=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``params`` and the moments are updated in place. With ``compress_grads``
    the gradients pass through int8 error-feedback compression first, and
    its residual rides in ``opt_state["ef_residual"]``."""
    grads_of = make_grad_fn(cfg, rules=rules)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grads_of(params, batch)
        if compress_grads:
            grads, new_resid = ef_compress_tree(grads, opt_state.get("ef_residual"))
        new_params, new_opt, stats = optimizer.update(grads, opt_state, params)
        if compress_grads:
            new_opt["ef_residual"] = new_resid
        return new_params, new_opt, {"loss": loss, "aux_loss": aux, **stats}

    return train_step


def _serving_mode(rules):
    return torch.inference_mode() if rules is None else torch.no_grad()


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, rules=None):
    def prefill_step(params, batch):
        with _serving_mode(rules):
            return T.prefill(cfg, params, batch, cache_len=cache_len, rules=rules)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, rules=None):
    def decode_step(params, caches, token, pos):
        with _serving_mode(rules):
            return T.decode_step(cfg, params, caches, token, pos, rules=rules)

    return decode_step


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocabulary (pad columns excluded): [B, 1]."""
    return logits[:, : cfg.vocab_size].argmax(dim=-1, keepdim=True)


def greedy_decode(cfg: ModelConfig, params, batch, n_tokens: int, cache_len: int, *,
                  rules=None) -> torch.Tensor:
    """Batched greedy generation on prefill + decode_step: [B, n_tokens]."""
    prefill_fn = make_prefill_step(cfg, cache_len, rules=rules)
    step_fn = make_decode_step(cfg, rules=rules)
    caches, logits = prefill_fn(params, batch)
    prompt_len = batch["tokens"].shape[1]
    tok = greedy_token(cfg, logits)
    out = [tok]
    for i in range(n_tokens - 1):
        logits, caches = step_fn(params, caches, tok, prompt_len + i)
        tok = greedy_token(cfg, logits)
        out.append(tok)
    return torch.cat(out, dim=1)
