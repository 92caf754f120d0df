"""The dense attention, MoE, RWKV6, Mamba/attention hybrid, encoder-decoder
and M-RoPE stacks of ``repro.models.transformer``, in PyTorch.

Layers of ``LayerKind("attn")`` (dense GQA, optional qk-norm, RoPE or
M-RoPE, optional sliding window, then SwiGLU or, with ``moe=True``, the
top-k expert FFN of ``models/moe.py``, plus a dense SwiGLU on the same
normed input where ``cfg.moe.dense_residual`` is set (arctic); tied or
separate LM head), ``LayerKind("rwkv6")`` (time mix with token shift, LoRA
decay and the WKV recurrence, then channel mix) and ``LayerKind("mamba")``
(the Mamba mixer, then SwiGLU or, with ``moe=True``, the expert FFN), in the
pattern the config gives: a hybrid puts attention at ``attn_offset`` of
every ``attn_period`` layers and Mamba elsewhere, and experts on every
``moe.every_k_layers``-th layer of either kind (jamba).

A sliding-window model (``cfg.sliding_window``) keeps a ring KV cache of
``min(cache_len, window)`` slots: token s lives in slot s % L, so prefill
writes the prompt's last L tokens there and decode overwrites the oldest.

Encoder-decoder configs (``cfg.enc_dec``) run a stack of ``n_enc_layers``
non-causal attention layers over ``batch["encoder_embeds"]`` [B, S_enc, D]
(the stub speech frontend's frames), closed by ``enc_final_norm``; every
decoder layer adds cross-attention to that memory after its self-attention.
Cross-attention always takes the plain blockwise ``attention``, as the
reference computes it outside its kernel. VLM configs put
``batch["vision_embeds"]`` [B, S_v, D] in place of the first S_v token
embeddings and rotate q and k by M-RoPE over ``batch["positions3"]``
[3, B, S] (temporal, height and width streams).

Weights keep the reference layout: ``[in, out]`` matrices applied as
``x @ W``, stacked along a leading ``n_repeats`` axis per pattern position,
under the same nested keys; the stack runs as a Python loop over the repeats.

Three entry points: ``forward_train`` (full causal sequence; differentiable;
returns the MoE layers' aux loss summed over the layers, 0 without MoE),
``prefill`` (returns the decode state and the last position's logits) and
``decode_step`` (one token against the state). Decode state per pattern
position, stacked along a leading ``n_repeats`` axis:
  attn  : ``{"k", "v"}`` caches [B, S_cache, KV, Dh]; with an encoder also
          ``{"xk", "xv"}`` [B, S_enc, KV, Dh], the projected memory
  rwkv6 : ``{"wkv"}`` state [B, H, Dh, Dh] fp32 and token-shift carries
          ``{"shift_t", "shift_c"}`` [B, D]
  mamba : ``{"h"}`` state [B, Di, St] fp32 and ``{"conv"}`` tail
          [B, K-1, Di], the last K-1 conv inputs

While a profiler runs, the self-attention and feed-forward sub-layers run
in the program spans ``block attention`` and ``block feed-forward``
(``spans.py``), in every mode. Prefill's cache build runs in ``prefill kv
cache`` inside ``block attention``, and the stack of each pattern
position's decode state after the last block in ``prefill kv cache`` too,
outside every block.

In train mode each stacked leaf is split once into its repeats
(``torch.unbind``, whose backward is one stack), and with ``cfg.remat`` each
repeat runs under ``torch.utils.checkpoint`` while autograd records, as the
reference wraps its scan body in ``jax.checkpoint``: the backward recomputes
the repeat's forward, kernels included.

Prefill and train self-attention (the encoder's too) go through the
flash-attention kernel when ``use_pallas`` selects it, else through the
plain blockwise ``attention``. The reference also needs the sequence
length to be a multiple of 64, for its Pallas tiling; the CUDA kernel masks
ragged tiles, so the port takes the kernel at any length. Unlike the reference, whose kernel branch returns
no KV cache (ROADMAP.md §C), both branches build the prefill cache.

Prefill and train WKV recurrences go through the RWKV6 kernel when
``use_pallas`` selects it, with logw cast to the model dtype as the reference
does, else through ``ssm.rwkv6_chunked`` (logw in fp32). The reference takes
its kernel only when the length is a multiple of its chunk (16); the CUDA
kernel loops over time steps and stops at S, so the port takes the kernel at
any length. Decode runs ``ssm.rwkv6_step``.

Prefill and train selective scans go through the Mamba kernel when
``use_pallas`` selects it, with B and C in u's dtype as the reference casts
them, else through ``ssm.mamba_scan_chunked``. The reference takes its
kernel only when S and Di are multiples of 64 (its Pallas tiling); the CUDA
kernel stops at S and masks the channels past Di, so the port takes the
kernel at any S and Di. Decode runs ``ssm.mamba_step``.

``param_defs(cfg, rules)`` gives every leaf the reference's partition spec
and ``cache_defs`` the decode state's. The entry points take ``rules=None``
as a keyword: with sharding rules (``distributed/sharding.py``) the params,
inputs, activations and caches are DTensors on the rules' mesh, placed as
the "placements" section below says, and the outputs are DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
# torch.utils.checkpoint imports torch._dynamo on its first call. Made there, inside the first
# train step, that import keeps the step's frames, and so its gradients and activations, alive
# until a full garbage collection; made here, it holds nothing.
import torch._dynamo  # noqa: F401
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerKind, ModelConfig
from ..kernels.ops import flash_attention, mamba_scan, rwkv6
from . import ssm
from . import moe
from .attention import (NEG_INF, _grouped, attention, cache_insert, decode_attention, decode_attention_part,
                        finish_decode, rescale_decode_part)
from .layers import apply_mrope, apply_rope, rmsnorm, swiglu
from ..distributed.sharding import P, axis_size, distribute_local, placements, sharded_region
from .params import ParamDef, stand_ins
from ..spans import BLOCK_ATTENTION, BLOCK_FFN, PREFILL_KV_CACHE, span


def _use_kernels(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """'on' forces the kernels' wrappers (which take the plain versions on
    CPU tensors); 'off' keeps the plain paths; 'auto' means on for CUDA,
    and for the meta tensors that stand in for CUDA tensors in the dry-run
    (``launch/dryrun.py``), where the kernel ops take their fake
    implementations."""
    if cfg.use_pallas == "on":
        return True
    if cfg.use_pallas == "off":
        return False
    return x.is_cuda or x.is_meta


ENC_KIND = LayerKind("attn")  # every encoder layer: self-attention (non-causal) and SwiGLU


# ===================================================================== specs
def _null_spec(*_args) -> P:
    return P()


class _NullRules:
    """Spec provider for unsharded runs: every spec is P()."""

    def __getattr__(self, name):
        return P()

    kv_cache = staticmethod(_null_spec)
    ssm_state = staticmethod(_null_spec)
    w_expert_in = staticmethod(_null_spec)
    w_expert_out = staticmethod(_null_spec)


# ================================================================ param defs
def _attn_defs(cfg: ModelConfig, r) -> dict:
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    d = {
        "wq": ParamDef((D, H * Dh), spec=r.w_in),
        "wk": ParamDef((D, KV * Dh), spec=r.w_in),
        "wv": ParamDef((D, KV * Dh), spec=r.w_in),
        "wo": ParamDef((H * Dh, D), spec=r.w_out),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((Dh,), "ones")
        d["k_norm"] = ParamDef((Dh,), "ones")
    return d


def _rwkv_defs(cfg: ModelConfig, r) -> dict:
    H, Dh, D, F = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "tm_mu": ParamDef((5, D), "zeros"),
        "tm_wr": ParamDef((D, H * Dh), spec=r.w_in),
        "tm_wk": ParamDef((D, H * Dh), spec=r.w_in),
        "tm_wv": ParamDef((D, H * Dh), spec=r.w_in),
        "tm_wg": ParamDef((D, H * Dh), spec=r.w_in),
        "tm_wo": ParamDef((H * Dh, D), spec=r.w_out),
        "tm_w0": ParamDef((D,), "normal", 1.0),
        "tm_w1": ParamDef((D, lora), "zeros"),
        "tm_w2": ParamDef((lora, D), "zeros"),
        "tm_u": ParamDef((H, Dh), "normal", 0.5),
        "tm_ln": ParamDef((H * Dh,), "ones"),
        "cm_mu": ParamDef((2, D), "zeros"),
        "cm_k": ParamDef((D, F), spec=r.w_in),
        "cm_v": ParamDef((F, D), spec=r.w_out),
        "cm_r": ParamDef((D, D)),
    }


def _mamba_defs(cfg: ModelConfig, r) -> dict:
    D = cfg.d_model
    Di, St, K = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
    Rdt = max(1, Di // 16)
    tp_name = None if isinstance(r, _NullRules) else r.tp
    tp, tp0 = P(tp_name), P(tp_name, None)  # Di-leading shardings
    return {
        "in_proj": ParamDef((D, 2 * Di), spec=r.w_in),
        "conv_w": ParamDef((Di, K), "normal", 0.5, tp0),
        "conv_b": ParamDef((Di,), "zeros", spec=tp),
        "x_proj": ParamDef((Di, Rdt + 2 * St), spec=tp0),
        "dt_proj": ParamDef((Rdt, Di), spec=P(None, tp_name)),
        "dt_bias": ParamDef((Di,), "zeros", spec=tp),
        "a_log": ParamDef((Di, St), "mamba_a", spec=tp0),
        "d_skip": ParamDef((Di,), "ones", spec=tp),
        "out_proj": ParamDef((Di, D), spec=r.w_out),
    }


def _ffn_defs(cfg: ModelConfig, r) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w1": ParamDef((D, F), spec=r.w_in), "w3": ParamDef((D, F), spec=r.w_in),
            "w2": ParamDef((F, D), spec=r.w_out)}


def _moe_defs(cfg: ModelConfig, r) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    d = {
        "router": ParamDef((D, E)),
        "e_w1": ParamDef((E, D, F), spec=r.w_expert_in(E)),
        "e_w3": ParamDef((E, D, F), spec=r.w_expert_in(E)),
        "e_w2": ParamDef((E, F, D), spec=r.w_expert_out(E)),
    }
    if cfg.moe.dense_residual:
        d["dense"] = _ffn_defs(cfg, r)
    return d


def _block_defs(cfg: ModelConfig, r, kind: LayerKind, cross_attn: bool = False) -> dict:
    D = cfg.d_model
    if kind.mixer == "rwkv6":  # time mix + channel mix, no swiglu
        return {"ln1": ParamDef((D,), "ones"), "rwkv": _rwkv_defs(cfg, r),
                "ln2": ParamDef((D,), "ones")}
    mixer = {"mamba": _mamba_defs(cfg, r)} if kind.mixer == "mamba" else {"attn": _attn_defs(cfg, r)}
    xattn = {"ln_x": ParamDef((D,), "ones"), "xattn": _attn_defs(cfg, r)} if cross_attn else {}
    ffn = {"moe": _moe_defs(cfg, r)} if kind.moe else {"ffn": _ffn_defs(cfg, r)}
    return {
        "ln1": ParamDef((D,), "ones"),
        **mixer,
        **xattn,
        "ln2": ParamDef((D,), "ones"),
        **ffn,
    }


def _stack(defs: dict, n: int) -> dict:
    return {
        k: ParamDef((n,) + v.shape, v.init, v.scale, P(None, *v.spec)) if isinstance(v, ParamDef)
        else _stack(v, n)
        for k, v in defs.items()
    }


def param_defs(cfg: ModelConfig, rules=None) -> dict:
    r = rules if rules is not None else _NullRules()
    D, Vp = cfg.d_model, cfg.padded_vocab
    defs: dict = {
        "embed": ParamDef((Vp, D), "normal", 0.02, r.embed),
        "final_norm": ParamDef((D,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, Vp), "normal", 0.02, r.lm_head)
    blocks = {f"p{i}": _block_defs(cfg, r, kind, cross_attn=cfg.enc_dec)
              for i, kind in enumerate(cfg.pattern)}
    defs["blocks"] = _stack(blocks, cfg.n_repeats)
    if cfg.enc_dec:
        defs["enc_blocks"] = _stack({"p0": _block_defs(cfg, r, ENC_KIND)}, cfg.n_enc_layers)
        defs["enc_final_norm"] = ParamDef((D,), "ones")
    return defs


def cache_defs(cfg: ModelConfig, rules, batch: int, cache_len: int, enc_len: int = 0) -> dict:
    """ParamDef tree of the decode state that ``prefill`` returns, with the
    reference's specs (no allocation). The SSM states are fp32
    (``init="fp32"``); the rest take the model dtype."""
    r = rules if rules is not None else _NullRules()
    shardable = batch >= 8
    kv = r.kv_cache(shardable) if rules is not None else P()
    st_spec = r.ssm_state(shardable) if rules is not None else P()
    dp = r._dp() if (rules is not None and batch >= 8) else None
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    Di, St, K = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
    eff_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    out = {}
    for i, kind in enumerate(cfg.pattern):
        d: dict = {}
        if kind.mixer == "attn":
            d["k"] = ParamDef((batch, eff_len, KV, Dh), spec=kv)
            d["v"] = ParamDef((batch, eff_len, KV, Dh), spec=kv)
            if cfg.enc_dec:
                d["xk"] = ParamDef((batch, enc_len, KV, Dh), spec=kv)
                d["xv"] = ParamDef((batch, enc_len, KV, Dh), spec=kv)
        elif kind.mixer == "rwkv6":
            d["wkv"] = ParamDef((batch, H, Dh, Dh), "fp32",
                                spec=P(*st_spec, None, None) if rules is not None else P())
            d["shift_t"] = ParamDef((batch, D), spec=P(dp, None) if rules else P())
            d["shift_c"] = ParamDef((batch, D), spec=P(dp, None) if rules else P())
        else:  # mamba
            d["h"] = ParamDef((batch, Di, St), "fp32",
                              spec=P(*st_spec, None) if rules is not None else P())
            d["conv"] = ParamDef((batch, K - 1, Di), spec=P(dp, None, r.tp) if rules is not None else P())
        out[f"p{i}"] = d
    return _stack(out, cfg.n_repeats)


def abstract_cache(cfg: ModelConfig, rules, batch: int, cache_len: int, enc_len: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode state of ``cache_defs`` as stand-ins (``params.stand_in``):
    meta tensors, or with ``rules`` DTensors placed by the cache specs. SSM
    states are float32, the rest ``dtype``."""
    return stand_ins(cache_defs(cfg, rules, batch, cache_len, enc_len), dtype, rules)


# ================================================================== context
@dataclass
class Ctx:
    mode: str  # 'train' | 'prefill' | 'decode'
    positions: torch.Tensor | None = None  # [B, S]
    positions3: torch.Tensor | None = None  # [3, B, S] (M-RoPE)
    pos: int | None = None  # decode: position of the new token
    enc_memory: torch.Tensor | None = None  # [B, S_enc, D]
    cache_len: int = 0
    causal: bool = True
    rules: object = None  # ShardingRules of a sharded run, else None
    batch_shardable: bool = True  # prefill and decode: B >= 8, as the reference decides


# ================================================================ placements
# A sharded run (``rules`` given) holds every parameter, input, activation and
# cache as a DTensor. The projections, norms, gates and the loss run on
# DTensor's own op strategies; these placements are chosen here instead:
#   - the rules' constraints where the reference puts them: the embedded
#     input and the residual after each block (``_constrain_residual``), the
#     prefill KV cache (and an encoder-decoder's xk/xv, as ``cache_defs``);
#   - sequence parallelism gathers the sequence after each norm
#     (``_seq_whole``), and a sub-layer's output is placed as the residual
#     before it is added (``_add``);
#   - every mixer runs on each rank's local shard through ``local_map``
#     (``_on_shards``): attention, kernel or plain, on query heads; decode
#     attention on the cache's head_dim slice with the scores summed over
#     tp, or on its slice of slots with the softmax's parts combined over
#     tp (``kv_shard="seq"``; the owner of the new token's slot writes it);
#     the WKV recurrence on heads; the selective scan on Di; the expert
#     FFN after the router on batch rows; the embedding lookup on batch rows.
#     A kernel's wrapper never sees a DTensor;
#   - tensors the model builds itself (causal masks, positions, RoPE
#     frequencies, capacity slots) are the same on every rank and enter
#     DTensor ops as replicated (``sharded_region``).


def _splits(n: int, k: int) -> bool:
    """Whether a dim of size ``n`` is sharded over ``k`` ranks: where it splits
    evenly, and never a dim of size 1, which DTensor then refuses to squeeze
    or merge (decode's single position, even over one rank)."""
    return n > 1 and n % k == 0


def _batch_axis(ctx: Ctx, b: int):
    """The rules' dp axes for an activation's batch dim of size ``b``, where
    the batch is shardable and splits over them; else None."""
    r = ctx.rules
    return r._dp() if ctx.batch_shardable and r.dp and _splits(b, axis_size(r.mesh, r._dp())) else None


def _tp_axis(ctx: Ctx, n: int):
    """The tp axis for a dim of size ``n`` where it splits, else None."""
    r = ctx.rules
    return r.tp if r.tp and _splits(n, axis_size(r.mesh, r.tp)) else None


def _constrain_residual(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """``rules.residual`` for x [B, S, D], with its batch and sequence dims
    sharded only where they split (``_splits``): DTensor refuses a matmul
    over an uneven shard (decode's single position over 2 ranks; B=2 over
    4), which GSPMD pads."""
    r = ctx.rules
    if r is None:
        return x
    b, s = x.shape[:2]
    return r.constrain(x, P(_batch_axis(ctx, b), _tp_axis(ctx, s) if r.seq_shard_residual else None, None))


def _add(ctx: Ctx, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual ``x`` plus a sub-layer's output ``y``; sharded, ``y`` is
    first redistributed to ``x``'s placements as a step of its own, so that
    the backward hands ``y``'s matmul a gradient in the placement that
    matmul gave (torch 2.11's DTensor cannot view a sequence-sharded
    gradient back to the matmul's [B*S, D])."""
    if ctx.rules is None:
        return x + y
    return x + y.redistribute(x.device_mesh, x.placements)


def _seq_whole(ctx: Ctx | None, h: torch.Tensor) -> torch.Tensor:
    """A normed residual [B, S, D] with its sequence dim whole on each rank,
    before the matmuls of a sub-layer: sequence parallelism gathers the
    sequence after the norm, as Megatron's does. (DTensor in torch 2.11
    also refuses a matmul's flatten of a sequence-sharded [B, S, D].)"""
    if ctx is None or ctx.rules is None:
        return h
    return ctx.rules.constrain(h, P(_batch_axis(ctx, h.shape[0]), None, None))


def _on_shards(ctx: Ctx, fn, args: tuple, in_specs: tuple, out_specs: tuple):
    """``fn`` on each rank's shards (``local_map``): every DTensor argument is
    redistributed to its spec, ``fn`` gets the local tensors (a kernel's
    wrapper never sees a DTensor) and its outputs become DTensors placed by
    ``out_specs``. A None argument passes through."""
    r = ctx.rules
    args = tuple(None if a is None else r.constrain(a, spec) for a, spec in zip(args, in_specs))
    # local_map reads a tuple as one entry per value and a list as one value's placements
    in_pl = tuple(None if a is None else list(placements(spec, r.mesh)) for a, spec in zip(args, in_specs))
    out_pl = tuple(list(placements(spec, r.mesh)) for spec in out_specs)
    # An argument whole over a mesh dim that another argument splits (the
    # expert weights over the batch's dp, mamba's B and C over tp) is used by
    # each rank for its part only: its gradient is a partial sum there.
    split = {i for pl in in_pl if pl for i, p in enumerate(pl) if isinstance(p, Shard)}
    grad_pl = tuple(None if pl is None else [Partial() if i in split and isinstance(p, Replicate) else p
                                             for i, p in enumerate(pl)] for pl in in_pl)
    return local_map(fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0], in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=r.mesh)(*args)


def _attend(ctx: Ctx, fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)``, an attention of q [B,S,H,Dh] over k/v [B,Sk,KV,Dh];
    sharded, on each rank's query heads (``rules.heads``, the batch on dp
    where it splits). Where the KV heads do not split over tp, k/v stay
    whole on each rank and the rank slices the KV heads of its query heads'
    groups."""
    if ctx.rules is None:
        return fn(q, k, v)
    b, _, h, _ = q.shape
    kv = k.shape[2]
    tp = _tp_axis(ctx, h)
    heads = P(_batch_axis(ctx, b), None, tp, None)
    if tp is None or kv % axis_size(ctx.rules.mesh, tp) == 0:
        return _on_shards(ctx, fn, (q, k, v), (heads, heads, heads), (heads,))
    n_tp, rank = axis_size(ctx.rules.mesh, tp), ctx.rules.mesh.get_local_rank(tp)
    h_loc, g = h // n_tp, h // kv
    lo, hi = rank * h_loc // g, ((rank + 1) * h_loc - 1) // g + 1
    if h_loc % (hi - lo) or any((rank * h_loc + j) // g - lo != j // (h_loc // (hi - lo)) for j in range(h_loc)):
        raise NotImplementedError(f"{h} query heads over {n_tp} ranks do not keep whole GQA groups of {g}")
    whole = P(_batch_axis(ctx, b), None, None, None)
    return _on_shards(ctx, lambda q, k, v: fn(q, k[:, :, lo:hi], v[:, :, lo:hi]),
                      (q, k, v), (heads, whole, whole), (heads,))


def _slot_offset(ctx: Ctx, n_slots: int) -> int:
    """The global index of this rank's first slot of a cache of ``n_slots``
    slots split over tp (``kv_shard="seq"``), as DTensor splits a dim
    (``torch.chunk``: ceil(n / tp) slots a rank, the last ranks' fewer or
    none), so that any length splits."""
    r = ctx.rules
    per = -(-n_slots // axis_size(r.mesh, r.tp))
    return min(r.mesh.get_local_rank(r.tp) * per, n_slots)


def _cache_insert(ctx: Ctx, kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``cache_insert`` of the new token's k/v [B, 1, KV, Dh]; sharded, into
    the cache as ``rules.kv_cache`` places it. With head_dim over tp the new
    token takes the cache's spec. With the slots over tp (``kv_shard="seq"``)
    its dim 1 of size 1 cannot: it stays whole over tp and only the rank
    that owns slot ``pos % S_cache`` writes it, in place."""
    r = ctx.rules
    if r is None:
        return cache_insert(kc, vc, k, v, pos)
    spec = r.kv_cache(ctx.batch_shardable)
    if r.kv_shard != "seq" or r.tp is None:
        return cache_insert(kc, vc, r.constrain(k, spec), r.constrain(v, spec), pos)
    if any(tuple(c.placements) != placements(spec, r.mesh) for c in (kc, vc)):
        raise ValueError(f"a KV cache placed {kc.placements}, not as rules.kv_cache places it: {spec}")
    n_slots = kc.shape[1]
    slot = pos % n_slots - _slot_offset(ctx, n_slots)

    def write(kc, vc, k, v):  # kc, vc [B, S/tp, KV, Dh] (this rank's slots); k, v [B, 1, KV, Dh]
        if 0 <= slot < kc.shape[1]:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
        return kc

    # the caches' local tensors are written in place (their placements are the spec, so
    # local_map hands over their own storage); the caches are returned, not local_map's
    # output, whose global shape it infers from the local one (wrong for an uneven split)
    new = P(spec[0], None, None, None)
    _on_shards(ctx, write, (kc, vc, k, v), (spec, spec, new, new), (spec,))
    return kc, vc


def _decode_attend(ctx: Ctx, q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, pos: int,
                   ring: bool = False) -> torch.Tensor:
    """``decode_attention``; sharded, on each rank's shard of the cache as
    ``rules.kv_cache`` places it. With head_dim over tp, each rank scores its
    head_dim slice and the scores are summed over tp (the reference's score
    all-reduce), then each rank weights its slice of v. With the slots over
    tp (``kv_shard="seq"``), q is whole on each rank, each rank takes
    ``decode_attention_part`` of its slots, and three all-reduces over tp
    combine the parts: the max of their maxima, then the sums of their
    rescaled exponential sums and weighted v. Either way the output is whole
    over tp (one token: [B, 1, H, Dh])."""
    r = ctx.rules
    if r is None:
        return decode_attention(q, kc, vc, pos, ring=ring)
    spec = r.kv_cache(ctx.batch_shardable)
    whole = P(spec[0], None, None, None)
    dh = q.shape[-1]
    if r.kv_shard == "seq" and r.tp:
        n_slots, offset, group = kc.shape[1], _slot_offset(ctx, kc.shape[1]), r.mesh.get_group(r.tp)

        def parts(q, k, v):  # q [B, 1, H, Dh]; k, v [B, S/tp, KV, Dh]
            m, l, o = decode_attention_part(q, k, v, pos, offset, n_slots, ring=ring)
            m_max = m.clone()
            torch.distributed.all_reduce(m_max, op=torch.distributed.ReduceOp.MAX, group=group)
            l, o = rescale_decode_part(m, l, o, m_max)
            torch.distributed.all_reduce(l, group=group)
            torch.distributed.all_reduce(o, group=group)
            return finish_decode(l, o, v.dtype)

        return _on_shards(ctx, parts, (q, kc, vc), (whole, spec, spec), (whole,))
    if not (r.tp and _splits(dh, axis_size(r.mesh, r.tp))):  # the cache's head_dim gathered
        return _on_shards(ctx, lambda q, k, v: decode_attention(q, k, v, pos, ring=ring),
                          (q, kc, vc), (whole, whole, whole), (whole,))
    group = r.mesh.get_group(r.tp)

    def local(q, k, v):  # q [B, 1, H, Dh/tp]; k, v [B, S, KV, Dh/tp]
        b, _, h, d = q.shape
        s = k.shape[1]
        scores = torch.einsum("bqkgd,bskd->bkgqs", _grouped(q, k.shape[2]).float(), k.float())
        torch.distributed.all_reduce(scores, group=group)
        scores = scores * dh**-0.5
        n_valid = min(pos + 1, s) if ring else pos + 1
        scores = torch.where(torch.arange(s, device=q.device) < n_valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, 1, h, d)

    q_spec = P(spec[0], None, None, r.tp)
    return r.constrain(_on_shards(ctx, local, (q, kc, vc), (q_spec, spec, spec), (q_spec,)), whole)


def _on_heads_wkv(ctx: Ctx, fn, r, k, v, logw, u, state0):
    """``fn``, the WKV recurrence (the kernel's op or the chunked plain
    form); sharded, on each rank's heads."""
    if ctx.rules is None:
        return fn(r, k, v, logw, u, state0)
    b, _, h, _ = r.shape
    ba, tp = _batch_axis(ctx, b), _tp_axis(ctx, h)
    heads, state = P(ba, None, tp, None), P(ba, tp, None, None)
    return _on_shards(ctx, fn, (r, k, v, logw, u, state0),
                      (heads, heads, heads, heads, P(tp, None), state), (heads, state))


def _wkv_step(ctx: Ctx, r, k, v, logw, u, state):
    """``ssm.rwkv6_step`` ([B, H, Dh] inputs); sharded, on each rank's heads."""
    if ctx.rules is None:
        return ssm.rwkv6_step(r, k, v, logw, u, state)
    b, h, _ = r.shape
    ba, tp = _batch_axis(ctx, b), _tp_axis(ctx, h)
    heads = P(ba, tp, None)
    return _on_shards(ctx, ssm.rwkv6_step, (r, k, v, logw, u, state),
                      (heads, heads, heads, heads, P(tp, None), P(ba, tp, None, None)),
                      (heads, P(ba, tp, None, None)))


def _on_channels_scan(ctx: Ctx, fn, u, dt, A, B_, C_, h0):
    """``fn``, the selective scan (the kernel's op or the chunked plain
    form); sharded, on each rank's inner channels (Di)."""
    if ctx.rules is None:
        return fn(u, dt, A, B_, C_, h0)
    b, _, di = u.shape
    ba, tp = _batch_axis(ctx, b), _tp_axis(ctx, di)
    chans, state, bc = P(ba, None, tp), P(ba, tp, None), P(ba, None, None)
    return _on_shards(ctx, fn, (u, dt, A, B_, C_, h0),
                      (chans, chans, P(tp, None), bc, bc, state), (chans, state))


def _scan_step(ctx: Ctx, u, dt, A, b_, c_, h):
    """``ssm.mamba_step`` ([B, Di] inputs); sharded, on each rank's channels."""
    if ctx.rules is None:
        return ssm.mamba_step(u, dt, A, b_, c_, h)
    b, di = u.shape
    ba, tp = _batch_axis(ctx, b), _tp_axis(ctx, di)
    chans = P(ba, tp)
    return _on_shards(ctx, ssm.mamba_step, (u, dt, A, b_, c_, h),
                      (chans, chans, P(tp, None), P(ba, None), P(ba, None), P(ba, tp, None)),
                      (chans, P(ba, tp, None)))


def _experts(ctx: Ctx, cfg: ModelConfig, pm: dict, h: torch.Tensor):
    """The expert FFN. Sharded, the router runs on the DTensors (its aux loss
    is a mean over the whole batch) and the capacity queue, dispatch, expert
    GEMMs and combine on each rank's batch shard, with the expert weights
    gathered at use (the reference's ZeRO-style placement of experts)."""
    if ctx is None or ctx.rules is None:
        return moe.moe_ffn(h, pm["router"], pm["e_w1"], pm["e_w3"], pm["e_w2"], cfg.moe)
    gates, idx, aux = moe.router_topk(h, pm["router"], cfg.moe)
    rows = P(_batch_axis(ctx, h.shape[0]), None, None)
    out = _on_shards(ctx, lambda *a: moe.expert_ffn(*a, cfg.moe),
                     (h, gates, idx, pm["e_w1"], pm["e_w3"], pm["e_w2"]), (rows, rows, rows, P(), P(), P()),
                     (rows,))
    return out, aux.float()


# ================================================================ sub-layers
def _heads(ctx: Ctx | None, y: torch.Tensor, n: int) -> torch.Tensor:
    """A fused projection [B, S, n * Dh] as [B, S, n, Dh]. Sharded, where the
    n heads do not split over tp the fused dim is first gathered: a shard
    boundary would fall inside a head (qwen3's 2 KV heads over 4 ranks)."""
    b, s, f = y.shape
    if ctx is not None and ctx.rules is not None and _tp_axis(ctx, n) is None:
        y = ctx.rules.constrain(y, P(_batch_axis(ctx, b), None, None))
    return y.reshape(b, s, n, f // n)


def _merge_heads(ctx: Ctx, out: torch.Tensor) -> torch.Tensor:
    """An attention output [B, S, H, Dh] as [B, S, H * Dh], the input of its
    output projection. Sharded, where the H heads do not split over tp (so
    the output is whole over tp), the flattened output is redistributed to
    its own placements as a step of its own, a no-op forward as in ``_add``:
    its backward hands the reshape a gradient whole over tp. The matmul with
    the tp-sharded ``wo`` gives one sharded over the fused dim, which DTensor
    cannot view back to [B, S, H, Dh] (arctic's 56 heads over 16 ranks)."""
    b, s, h, dh = out.shape
    out = out.reshape(b, s, h * dh)
    if ctx.rules is not None and _tp_axis(ctx, h) is None:
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def _project_qkv(cfg: ModelConfig, p_attn: dict, h: torch.Tensor, ctx: Ctx | None = None):
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = _heads(ctx, h @ p_attn["wq"], H)
    k = _heads(ctx, h @ p_attn["wk"], KV)
    v = _heads(ctx, h @ p_attn["wv"], KV)
    if cfg.qk_norm:
        q = rmsnorm(q, p_attn["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p_attn["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope(cfg: ModelConfig, ctx: Ctx, q: torch.Tensor, k: torch.Tensor):
    if not cfg.rope:
        return q, k
    if cfg.mrope_sections:
        pos3 = ctx.positions3
        if pos3 is None:
            if ctx.pos is None:
                raise ValueError(f"{cfg.name} rotates by M-RoPE: train and prefill need "
                                 "batch['positions3'] [3, B, S]")
            # decode: the same position on all three streams
            pos3 = torch.full((3,) + q.shape[:2], ctx.pos, dtype=torch.int32, device=q.device)
        return (apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    pos = ctx.positions
    if pos is None:
        pos = torch.full(q.shape[:2], ctx.pos, dtype=torch.int32, device=q.device)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)


def _self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """Returns (mixer_out, new_cache_entries)."""
    with span(BLOCK_ATTENTION):
        h = _seq_whole(ctx, rmsnorm(x, p["ln1"], cfg.norm_eps))
        q, k, v = _project_qkv(cfg, p["attn"], h, ctx)
        q, k = _rope(cfg, ctx, q, k)
        new_cache = {}
        if ctx.mode == "decode":
            kc, vc = _cache_insert(ctx, cache["k"], cache["v"], k, v, ctx.pos)
            out = _decode_attend(ctx, q, kc, vc, ctx.pos, ring=cfg.sliding_window is not None)
            new_cache = {"k": kc, "v": vc}
        else:
            if _use_kernels(cfg, q):
                out = _attend(ctx, lambda q, k, v: flash_attention(q, k, v, ctx.causal, cfg.sliding_window), q, k, v)
            else:
                out = _attend(ctx, lambda q, k, v: attention(q, k, v, causal=ctx.causal, window=cfg.sliding_window,
                                                             q_chunk=cfg.attn_q_chunk), q, k, v)
            if ctx.mode == "prefill":
                new_cache = _prefill_kv_cache(cfg, ctx, k, v)
        return _merge_heads(ctx, out) @ p["attn"]["wo"], new_cache


def _prefill_kv_cache(cfg: ModelConfig, ctx: Ctx, k: torch.Tensor, v: torch.Tensor) -> dict:
    B, S, KV, Dh = k.shape
    L = ctx.cache_len

    def build(t):
        if cfg.sliding_window is not None and S > L:
            # ring discipline: token s lives at slot s % L, so the cache is the last L tokens
            # rotated by S % L; built of slices and a cat, as torch 2.11's DTensor has no
            # strategy for writing at an index tensor (index_put_)
            tail, s0 = t[:, S - L :], S % L
            buf = torch.cat([tail[:, L - s0 :], tail[:, : L - s0]], dim=1) if s0 else tail.clone()
        else:
            buf = t.new_zeros((B, L, KV, Dh))
            n = min(S, L)
            buf[:, :n] = t[:, :n]
        if ctx.rules is not None:
            buf = ctx.rules.constrain(buf, ctx.rules.kv_cache(ctx.batch_shardable))
        return buf

    with span(PREFILL_KV_CACHE):
        return {"k": build(k), "v": build(v)}


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """Attention of the decoder's queries over the encoder memory, plain and
    non-causal. Train and prefill project the memory (prefill returns the
    projections as the ``xk``/``xv`` cache); decode reads them from the cache
    and returns the cache's own tensors, so the decode loop copies nothing.
    Returns (mixer_out, new_cache_entries)."""
    h = _seq_whole(ctx, rmsnorm(x, p["ln_x"], cfg.norm_eps))
    H, KV = cfg.n_heads, cfg.n_kv_heads
    px = p["xattn"]
    q = _heads(ctx, h @ px["wq"], H)
    new_cache = {}
    if ctx.mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        out = _decode_attend(ctx, q, xk, xv, xk.shape[1] - 1)
        new_cache = {"xk": xk, "xv": xv}
    else:
        mem = ctx.enc_memory
        xk = _heads(ctx, mem @ px["wk"], KV)
        xv = _heads(ctx, mem @ px["wv"], KV)
        out = _attend(ctx, lambda q, k, v: attention(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk), q, xk, xv)
        if ctx.mode == "prefill":
            if ctx.rules is not None:  # placed as cache_defs places them: the KV cache's spec
                spec = ctx.rules.kv_cache(ctx.batch_shardable)
                xk, xv = ctx.rules.constrain(xk, spec), ctx.rules.constrain(xv, spec)
            new_cache = {"xk": xk, "xv": xv}
    return _merge_heads(ctx, out) @ px["wo"], new_cache


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1} with ``prev`` as the t=0 predecessor."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_block(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """RWKV6 layer: time mix + channel mix (its own FFN form). Returns
    (x, new_cache)."""
    pr = p["rwkv"]
    H, Dh = cfg.n_heads, cfg.head_dim
    B, S, _ = x.shape
    # ---- time mix
    h = _seq_whole(ctx, rmsnorm(x, p["ln1"], cfg.norm_eps))
    dh = _shift(h, cache["shift_t"][:, None, :] if cache else None) - h
    mu = pr["tm_mu"]

    def lerp(i):
        return h + dh * mu[i]

    r = _heads(ctx, lerp(0) @ pr["tm_wr"], H)
    k = _heads(ctx, lerp(1) @ pr["tm_wk"], H)
    v = _heads(ctx, lerp(2) @ pr["tm_wv"], H)
    w_raw = pr["tm_w0"] + torch.tanh(lerp(3) @ pr["tm_w1"]) @ pr["tm_w2"]
    logw = _heads(ctx, ssm.rwkv6_decay(w_raw), H)
    g = torch.nn.functional.silu(lerp(4) @ pr["tm_wg"])
    state0 = cache["wkv"] if cache else None
    if ctx.mode == "decode":
        out1, wkv = _wkv_step(ctx, r[:, 0], k[:, 0], v[:, 0], logw[:, 0], pr["tm_u"], state0)
        out = out1[:, None].to(x.dtype)
    elif _use_kernels(cfg, r):
        out, wkv = _on_heads_wkv(ctx, rwkv6, r, k, v, logw.to(r.dtype), pr["tm_u"], state0)
    else:
        out, wkv = _on_heads_wkv(ctx, ssm.rwkv6_chunked, r, k, v, logw, pr["tm_u"], state0)
    out = rmsnorm(out.reshape(B, S, H * Dh), pr["tm_ln"], cfg.norm_eps) * g
    x = _add(ctx, x, out @ pr["tm_wo"])
    # ---- channel mix
    h2 = _seq_whole(ctx, rmsnorm(x, p["ln2"], cfg.norm_eps))
    dh2 = _shift(h2, cache["shift_c"][:, None, :] if cache else None) - h2
    cmu = pr["cm_mu"]
    xk = h2 + dh2 * cmu[0]
    xr = h2 + dh2 * cmu[1]
    kk = torch.square(torch.relu(xk @ pr["cm_k"]))
    x = _add(ctx, x, torch.sigmoid(xr @ pr["cm_r"]) * (kk @ pr["cm_v"]))
    new_cache = {}
    if ctx.mode in ("prefill", "decode"):
        new_cache = {"wkv": wkv, "shift_t": h[:, -1, :], "shift_c": h2[:, -1, :]}
    return x, new_cache


def _mamba_mixer(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """Mamba mixer: in_proj, causal conv, selective scan, gates, out_proj.
    Returns (mixer_out, new_cache)."""
    pm = p["mamba"]
    Di, St, K = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
    Rdt = max(1, Di // 16)
    B, S, _ = x.shape
    h = _seq_whole(ctx, rmsnorm(x, p["ln1"], cfg.norm_eps))
    xr, z = torch.chunk(h @ pm["in_proj"], 2, dim=-1)  # [B, S, Di] each
    u = torch.nn.functional.silu(
        ssm.mamba_conv(xr, pm["conv_w"], pm["conv_b"], cache["conv"] if cache else None))
    dbl = u @ pm["x_proj"]  # [B, S, Rdt + 2 St]
    # B and C stay views in u's dtype: the reference casts them to fp32 and,
    # for its kernel, back to u's dtype, which is exact; every path below
    # computes in fp32.
    B_, C_ = dbl[..., Rdt : Rdt + St], dbl[..., Rdt + St :]
    dt = torch.nn.functional.softplus(dbl[..., :Rdt] @ pm["dt_proj"] + pm["dt_bias"])
    A = -torch.exp(pm["a_log"].float())
    h0 = cache["h"] if cache else None
    if ctx.mode == "decode":
        y1, hs = _scan_step(ctx, u[:, 0], dt[:, 0], A, B_[:, 0], C_[:, 0], h0)
        y = y1[:, None].to(x.dtype)
    elif _use_kernels(cfg, u):
        y, hs = _on_channels_scan(ctx, mamba_scan, u, dt, A, B_, C_, h0)
    else:
        y, hs = _on_channels_scan(ctx, ssm.mamba_scan_chunked, u, dt, A, B_, C_, h0)
    y = (y + pm["d_skip"] * u) * torch.nn.functional.silu(z)
    out = y @ pm["out_proj"]
    new_cache = {}
    if ctx.mode == "decode":
        new_cache = {"h": hs, "conv": torch.cat([cache["conv"][:, 1:],
                                                 xr[:, -1:].to(cache["conv"].dtype)], dim=1)}
    elif ctx.mode == "prefill":  # the last K-1 inputs, zero-padded in front when S < K-1
        pad = xr.new_zeros((B, max(0, K - 1 - S), Di))
        new_cache = {"h": hs, "conv": torch.cat([pad, xr[:, -(K - 1):]], dim=1)}
    return out, new_cache


def _ffn_or_moe(cfg: ModelConfig, kind: LayerKind, p: dict, x: torch.Tensor, ctx: Ctx | None = None):
    """The feed-forward sub-layer on rmsnorm(x): SwiGLU, or the expert FFN
    plus, with a dense residual, a SwiGLU on the same normed input (every
    token gets it, the capacity queue's drops included). Returns (out, aux):
    aux is the MoE layer's load-balancing loss (fp32 scalar), else None."""
    with span(BLOCK_FFN):
        h = _seq_whole(ctx, rmsnorm(x, p["ln2"], cfg.norm_eps))
        if not kind.moe:
            f = p["ffn"]
            return swiglu(h, f["w1"], f["w3"], f["w2"]), None
        pm = p["moe"]
        out, aux = _experts(ctx, cfg, pm, h)
        if cfg.moe.dense_residual:
            d = pm["dense"]
            out = out + swiglu(h, d["w1"], d["w3"], d["w2"])
        return out, aux


def apply_block(cfg: ModelConfig, kind: LayerKind, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """One pattern-position layer. Returns (x, new_cache, aux): aux is an MoE
    layer's load-balancing loss (fp32 scalar), None for any other layer."""
    if kind.mixer == "rwkv6":
        x, new_cache = _rwkv_block(cfg, p, x, ctx, cache)
        return _constrain_residual(ctx, x), new_cache, None
    mixer = _mamba_mixer if kind.mixer == "mamba" else _self_attention
    mix, new_cache = mixer(cfg, p, x, ctx, cache)
    x = _add(ctx, x, mix)
    if "xattn" in p:  # a decoder layer of an encoder-decoder model
        xmix, xcache = _cross_attention(cfg, p, x, ctx, cache)
        x = _add(ctx, x, xmix)
        new_cache = {**new_cache, **xcache}
    out, aux = _ffn_or_moe(cfg, kind, p, x, ctx)
    return _constrain_residual(ctx, _add(ctx, x, out)), new_cache, aux


# ================================================================ stacks
def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _repeats(tree: dict, n: int) -> list[dict]:
    """``[_at(tree, i) for i in range(n)]``, each stacked leaf split once by
    ``torch.unbind``. Indexing a leaf per repeat instead would make autograd
    build n zero-filled gradients of the whole leaf and add them up."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        for i, part in enumerate(_repeats(v, n) if isinstance(v, dict) else torch.unbind(v, 0)):
            out[i][k] = part
    return out


def _train_repeat(cfg: ModelConfig, pattern, layer: dict, x: torch.Tensor, aux, ctx: Ctx):
    """One repeat of the pattern in train mode. Returns (x, aux): the MoE
    layers' aux losses added to ``aux`` in layer order (None while no MoE
    layer has run)."""
    for i, kind in enumerate(pattern):
        x, _, a = apply_block(cfg, kind, layer[f"p{i}"], x, ctx, None)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _run_blocks(cfg: ModelConfig, blocks: dict, x: torch.Tensor, ctx: Ctx, caches=None,
                pattern=None, n_repeats: int | None = None):
    """Loop over the stacked repeats of ``pattern`` (default: the config's
    decoder pattern and repeats; the encoder passes its own). Returns (x,
    caches, aux). caches: in decode the given caches, updated in place (the
    KV caches by ``cache_insert``, the RWKV and Mamba states, carries and conv
    tails by copying each layer's new values in); in prefill new caches
    stacked along the repeat axis; in train None. aux: in train the MoE
    layers' aux losses summed over the layers (None without MoE layers); in
    prefill and decode None."""
    pattern = cfg.pattern if pattern is None else pattern
    n_repeats = cfg.n_repeats if n_repeats is None else n_repeats
    if ctx.mode == "train":
        remat = cfg.remat and torch.is_grad_enabled()
        aux = None
        for layer in _repeats(blocks, n_repeats):
            if remat:
                x, aux = checkpoint(_train_repeat, cfg, pattern, layer, x, aux, ctx, use_reentrant=False)
            else:
                x, aux = _train_repeat(cfg, pattern, layer, x, aux, ctx)
        return x, None, aux
    new = {f"p{i}": [] for i in range(len(pattern))}
    for rep in range(n_repeats):
        for kind, (key, layers) in zip(pattern, new.items()):
            c_in = _at(caches[key], rep) if caches is not None else None
            x, nc, _ = apply_block(cfg, kind, _at(blocks[key], rep), x, ctx, c_in)
            if ctx.mode == "decode":
                for name, t in nc.items():
                    if t is not c_in[name]:
                        c_in[name].copy_(t)
            else:
                layers.append(nc)
    if ctx.mode == "decode":
        return x, caches, None
    stacked = {}
    for key, cs in new.items():
        with span(PREFILL_KV_CACHE):
            stacked[key] = {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
    return x, stacked, None


def _embed(params: dict, tokens: torch.Tensor, ctx: Ctx | None = None) -> torch.Tensor:
    """The rows of ``params["embed"]`` at ``tokens``. Sharded, each rank looks
    up its batch shard in the table gathered over its vocab rows (FSDP
    places them over "data") and keeps its d_model columns: the backward of
    DTensor's own index op fails on torch 2.11."""
    if ctx is None or ctx.rules is None:
        return params["embed"][tokens.long()]
    table = params["embed"]
    ba, tp = _batch_axis(ctx, tokens.shape[0]), _tp_axis(ctx, table.shape[1])
    return _on_shards(ctx, lambda e, t: e[t.long()], (table, tokens), (P(None, tp), P(ba, None)),
                      (P(ba, None, tp),))


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict, ctx: Ctx | None = None) -> torch.Tensor:
    """Token embeddings; a VLM's ``vision_embeds`` [B, S_v, D] take the
    place of the first S_v."""
    x = _embed(params, batch["tokens"], ctx)
    if cfg.vision_len_ratio and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def _encode(cfg: ModelConfig, params: dict, batch: dict, rules=None) -> torch.Tensor:
    """The encoder stack, non-causal and in train mode, over the frame
    embeddings ``batch["encoder_embeds"]`` cast to the parameters' dtype;
    returns the normed memory [B, S_enc, D]."""
    enc_x = batch["encoder_embeds"].to(params["enc_final_norm"].dtype)
    ectx = Ctx(mode="train", causal=False, rules=rules)
    enc_x, _, _ = _run_blocks(cfg, params["enc_blocks"], enc_x, ectx, pattern=(ENC_KIND,), n_repeats=cfg.n_enc_layers)
    return _seq_whole(ectx, rmsnorm(enc_x, params["enc_final_norm"], cfg.norm_eps))


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor, ctx: Ctx | None = None) -> torch.Tensor:
    x = _seq_whole(ctx, rmsnorm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _positions(batch: dict, B: int, S: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return positions


def _place_batch(ctx: Ctx, batch: dict) -> dict:
    """Without rules, ``batch`` itself. With rules, each input as a DTensor
    with its batch dim over dp where it splits evenly (``positions3``
    carries the batch on dim 1) and every other dim replicated: a plain
    tensor, which every rank holds whole, is cut locally; a DTensor is
    redistributed."""
    r = ctx.rules
    if r is None:
        return batch
    out = {}
    for name, t in batch.items():
        bdim = 1 if name == "positions3" else 0
        spec = P(*([None] * bdim), _batch_axis(ctx, t.shape[bdim]))
        out[name] = (r.constrain(t, spec) if isinstance(t, DTensor)
                     else distribute_local(t, r.mesh, placements(spec, r.mesh)))
    return out


# ================================================================ entry points
def forward_train(cfg: ModelConfig, params: dict, batch: dict, *,
                  rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits [B,S,Vp], aux_loss): the
    MoE layers' load-balancing losses summed over the layers, fp32; 0 for a
    model without MoE layers. With ``rules`` the params are DTensors placed
    by ``param_defs(cfg, rules)``, the outputs DTensors; a backward through
    them runs under ``implicit_replication()`` too (``train/steps.py``)."""
    with sharded_region(rules):
        ctx = Ctx(mode="train", rules=rules)
        batch = _place_batch(ctx, batch)
        x = _embed_inputs(cfg, params, batch, ctx)
        B, S, _ = x.shape
        ctx.positions, ctx.positions3 = _positions(batch, B, S, x.device), batch.get("positions3")
        if cfg.enc_dec:
            ctx.enc_memory = _encode(cfg, params, batch, rules)
        x = _constrain_residual(ctx, x)
        x, _, aux = _run_blocks(cfg, params["blocks"], x, ctx)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _logits(cfg, params, x, ctx), aux


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int, *, rules=None):
    """Process a full prompt; returns (caches, last-token logits [B,Vp]).
    With ``rules``, DTensors; the KV caches placed by ``rules.kv_cache``."""
    with sharded_region(rules):
        B = batch["tokens"].shape[0]
        eff_cache = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
        ctx = Ctx(mode="prefill", cache_len=eff_cache, rules=rules, batch_shardable=B >= 8)
        batch = _place_batch(ctx, batch)
        x = _embed_inputs(cfg, params, batch, ctx)
        S = x.shape[1]
        ctx.positions, ctx.positions3 = _positions(batch, B, S, x.device), batch.get("positions3")
        if cfg.enc_dec:
            ctx.enc_memory = _encode(cfg, params, batch, rules)
        x = _constrain_residual(ctx, x)
        x, caches, _ = _run_blocks(cfg, params["blocks"], x, ctx)
        return caches, _logits(cfg, params, x[:, -1:, :], ctx)[:, 0]


def decode_step(cfg: ModelConfig, params: dict, caches: dict, token: torch.Tensor, pos: int, *,
                rules=None):
    """One decode step. token [B,1] int; pos: position of the new token.
    Returns (logits [B,Vp], caches) — the caches are updated in place."""
    with sharded_region(rules):
        ctx = Ctx(mode="decode", pos=int(pos), rules=rules, batch_shardable=token.shape[0] >= 8)
        x = _embed(params, _place_batch(ctx, {"tokens": token})["tokens"], ctx)
        x, caches, _ = _run_blocks(cfg, params["blocks"], x, ctx, caches)
        return _logits(cfg, params, x, ctx)[:, 0], caches
