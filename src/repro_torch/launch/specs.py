"""Stand-ins for every input of a dry-run cell (port of ``repro.launch.specs``).

Where the reference builds a ``jax.ShapeDtypeStruct`` with a
``NamedSharding``, the port builds a tensor on the ``meta`` device (shape,
type and strides, no storage), or with sharding rules a DTensor on the
rules' mesh whose local tensor is the first rank's meta shard
(``models.params.stand_in``). The mesh is the rules' own. The modality
frontends are stubs as in the reference: ``[audio]`` provides precomputed
frame embeddings (S/4 encoder positions), ``[vlm]`` precomputed patch
embeddings (the first S/8 positions) and the 3-stream M-RoPE position ids.
"""
from __future__ import annotations

import torch

from ..configs import Shape
from ..configs.base import ModelConfig
from ..distributed.sharding import P, ShardingRules, axis_size
from ..models import transformer as T
from ..models.params import ParamDef, stand_in, stand_ins
from ..optim.adamw import AdamW


def _dp_axes(rules: ShardingRules | None, batch: int):
    if rules is None:
        return None
    total_dp = axis_size(rules.mesh, rules.dp)
    if batch % total_dp != 0 or batch < total_dp:
        return None  # tiny batch (long_500k): replicate batch dim
    return rules._dp()


def batch_specs(cfg: ModelConfig, shape: Shape, rules) -> dict:
    """Inputs for the train and prefill entry points."""
    B, S = shape.global_batch, shape.seq_len
    dp = _dp_axes(rules, B)
    out = {"tokens": stand_in((B, S), torch.int32, P(dp, None), rules)}
    if cfg.enc_dec:
        out["encoder_embeds"] = stand_in((B, S // cfg.enc_len_ratio, cfg.d_model), torch.bfloat16,
                                         P(dp, None, None), rules)
    if cfg.vision_len_ratio:
        out["vision_embeds"] = stand_in((B, S // cfg.vision_len_ratio, cfg.d_model), torch.bfloat16,
                                        P(dp, None, None), rules)
        out["positions3"] = stand_in((3, B, S), torch.int32, P(None, dp, None), rules)
    return out


def decode_specs(cfg: ModelConfig, shape: Shape, rules, *, cache_len: int | None = None,
                 pos: int | None = None) -> tuple:
    """(caches, token, pos) for the decode entry point. The KV cache and SSM
    state stand-ins hold a context of ``shape.seq_len`` tokens (or
    ``cache_len``); ``pos`` is a Python int, as the port's ``decode_step``
    takes it, by default the cache's last position."""
    B, S = shape.global_batch, shape.seq_len
    cache_len = cache_len or S
    dp = _dp_axes(rules, B)
    enc_len = S // cfg.enc_len_ratio if cfg.enc_dec else 0
    caches = T.abstract_cache(cfg, rules, batch=B, cache_len=cache_len, enc_len=enc_len)
    token = stand_in((B, 1), torch.int32, P(dp, None), rules)
    return caches, token, cache_len - 1 if pos is None else pos


def _zero1_defs(defs, rules):
    """ZeRO-1: Adam moments additionally sharded over 'data' on their first
    replicated, divisible dim. Params stay as laid out (no weight regather;
    only the optimizer update communicates)."""
    data_size = axis_size(rules.mesh, "data") if "data" in rules.mesh.mesh_dim_names else 1

    def one(d):
        if not isinstance(d, ParamDef):
            return {k: one(v) for k, v in d.items()}
        spec = tuple(d.spec)
        for i, s in enumerate(d.shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None and s % data_size == 0 and s >= data_size:
                new = list(spec) + [None] * (len(d.shape) - len(spec))
                new[i] = "data"
                return ParamDef(d.shape, d.init, d.scale, P(*new))
        return d

    return one(defs)


def model_state_specs(cfg: ModelConfig, rules, with_opt: bool, compress_grads: bool = False) -> tuple:
    """(params, opt_state) stand-ins: bf16 params, moments in the config's
    moment dtype, the step a 0-d int32; with ``compress_grads`` also the
    int8 error feedback's ``ef_residual``, fp32 and placed as the params."""
    defs = T.param_defs(cfg, rules)
    params = stand_ins(defs, torch.bfloat16, rules)
    if not with_opt:
        return params, None
    mdt = torch.bfloat16 if cfg.opt_moment_dtype == "bfloat16" else torch.float32
    mdefs = defs
    if getattr(cfg, "zero1_moments", False) and rules is not None:
        mdefs = _zero1_defs(defs, rules)
    opt_state = {
        "m": stand_ins(mdefs, mdt, rules),
        "v": stand_ins(mdefs, mdt, rules),
        "step": stand_in((), torch.int32, P(), rules),
    }
    if compress_grads:
        opt_state["ef_residual"] = stand_ins(defs, torch.float32, rules)
    return params, opt_state


def make_optimizer(cfg: ModelConfig) -> AdamW:
    return AdamW(lr=3e-4, moment_dtype=cfg.opt_moment_dtype)


def input_specs(cfg: ModelConfig, shape: Shape, rules=None):
    """Stand-ins for every model input of a cell: a dict for the train and
    prefill steps, or the (caches, token, pos) tuple for decode."""
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape, rules)
    return decode_specs(cfg, shape, rules)
