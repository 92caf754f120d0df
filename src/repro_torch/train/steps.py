"""Serving step functions (port of the serving half of ``repro.train.steps``).

The steps run under ``torch.inference_mode()``. The training step, its
loss and the optimizer come with the training slice (ROADMAP.md §A item 3).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return T.prefill(cfg, params, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(params, caches, token, pos):
        return T.decode_step(cfg, params, caches, token, pos)

    return decode_step


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocabulary (pad columns excluded): [B, 1]."""
    return logits[:, : cfg.vocab_size].argmax(dim=-1, keepdim=True)


def greedy_decode(cfg: ModelConfig, params, batch, n_tokens: int, cache_len: int) -> torch.Tensor:
    """Batched greedy generation on prefill + decode_step: [B, n_tokens]."""
    prefill_fn = make_prefill_step(cfg, cache_len)
    step_fn = make_decode_step(cfg)
    caches, logits = prefill_fn(params, batch)
    prompt_len = batch["tokens"].shape[1]
    tok = greedy_token(cfg, logits)
    out = [tok]
    for i in range(n_tokens - 1):
        logits, caches = step_fn(params, caches, tok, prompt_len + i)
        tok = greedy_token(cfg, logits)
        out.append(tok)
    return torch.cat(out, dim=1)
