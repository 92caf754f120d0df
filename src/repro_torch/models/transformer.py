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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerKind, ModelConfig
from ..kernels.ops import flash_attention, mamba_scan, rwkv6
from . import ssm
from .attention import attention, cache_insert, decode_attention
from .layers import apply_mrope, apply_rope, rmsnorm, swiglu
from .moe import moe_ffn
from .params import ParamDef


def _use_kernels(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """'on' forces the kernels' wrappers (which take the plain versions on
    CPU tensors); 'off' keeps the plain paths; 'auto' means on for CUDA."""
    if cfg.use_pallas == "on":
        return True
    if cfg.use_pallas == "off":
        return False
    return x.is_cuda


ENC_KIND = LayerKind("attn")  # every encoder layer: self-attention (non-causal) and SwiGLU


# ================================================================ param defs
def _attn_defs(cfg: ModelConfig) -> dict:
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    d = {
        "wq": ParamDef((D, H * Dh)),
        "wk": ParamDef((D, KV * Dh)),
        "wv": ParamDef((D, KV * Dh)),
        "wo": ParamDef((H * Dh, D)),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((Dh,), "ones")
        d["k_norm"] = ParamDef((Dh,), "ones")
    return d


def _rwkv_defs(cfg: ModelConfig) -> dict:
    H, Dh, D, F = cfg.n_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "tm_mu": ParamDef((5, D), "zeros"),
        "tm_wr": ParamDef((D, H * Dh)),
        "tm_wk": ParamDef((D, H * Dh)),
        "tm_wv": ParamDef((D, H * Dh)),
        "tm_wg": ParamDef((D, H * Dh)),
        "tm_wo": ParamDef((H * Dh, D)),
        "tm_w0": ParamDef((D,), "normal", 1.0),
        "tm_w1": ParamDef((D, lora), "zeros"),
        "tm_w2": ParamDef((lora, D), "zeros"),
        "tm_u": ParamDef((H, Dh), "normal", 0.5),
        "tm_ln": ParamDef((H * Dh,), "ones"),
        "cm_mu": ParamDef((2, D), "zeros"),
        "cm_k": ParamDef((D, F)),
        "cm_v": ParamDef((F, D)),
        "cm_r": ParamDef((D, D)),
    }


def _mamba_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Di, St, K = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba.d_conv
    Rdt = max(1, Di // 16)
    return {
        "in_proj": ParamDef((D, 2 * Di)),
        "conv_w": ParamDef((Di, K), "normal", 0.5),
        "conv_b": ParamDef((Di,), "zeros"),
        "x_proj": ParamDef((Di, Rdt + 2 * St)),
        "dt_proj": ParamDef((Rdt, Di)),
        "dt_bias": ParamDef((Di,), "zeros"),
        "a_log": ParamDef((Di, St), "mamba_a"),
        "d_skip": ParamDef((Di,), "ones"),
        "out_proj": ParamDef((Di, D)),
    }


def _ffn_defs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w1": ParamDef((D, F)), "w3": ParamDef((D, F)), "w2": ParamDef((F, D))}


def _moe_defs(cfg: ModelConfig) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    d = {
        "router": ParamDef((D, E)),
        "e_w1": ParamDef((E, D, F)),
        "e_w3": ParamDef((E, D, F)),
        "e_w2": ParamDef((E, F, D)),
    }
    if cfg.moe.dense_residual:
        d["dense"] = _ffn_defs(cfg)
    return d


def _block_defs(cfg: ModelConfig, kind: LayerKind, cross_attn: bool = False) -> dict:
    D = cfg.d_model
    if kind.mixer == "rwkv6":  # time mix + channel mix, no swiglu
        return {"ln1": ParamDef((D,), "ones"), "rwkv": _rwkv_defs(cfg),
                "ln2": ParamDef((D,), "ones")}
    mixer = {"mamba": _mamba_defs(cfg)} if kind.mixer == "mamba" else {"attn": _attn_defs(cfg)}
    xattn = {"ln_x": ParamDef((D,), "ones"), "xattn": _attn_defs(cfg)} if cross_attn else {}
    ffn = {"moe": _moe_defs(cfg)} if kind.moe else {"ffn": _ffn_defs(cfg)}
    return {
        "ln1": ParamDef((D,), "ones"),
        **mixer,
        **xattn,
        "ln2": ParamDef((D,), "ones"),
        **ffn,
    }


def _stack(defs: dict, n: int) -> dict:
    return {
        k: ParamDef((n,) + v.shape, v.init, v.scale) if isinstance(v, ParamDef) else _stack(v, n)
        for k, v in defs.items()
    }


def param_defs(cfg: ModelConfig) -> dict:
    D, Vp = cfg.d_model, cfg.padded_vocab
    defs: dict = {
        "embed": ParamDef((Vp, D), "normal", 0.02),
        "final_norm": ParamDef((D,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, Vp), "normal", 0.02)
    blocks = {f"p{i}": _block_defs(cfg, kind, cross_attn=cfg.enc_dec)
              for i, kind in enumerate(cfg.pattern)}
    defs["blocks"] = _stack(blocks, cfg.n_repeats)
    if cfg.enc_dec:
        defs["enc_blocks"] = _stack({"p0": _block_defs(cfg, ENC_KIND)}, cfg.n_enc_layers)
        defs["enc_final_norm"] = ParamDef((D,), "ones")
    return defs


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


# ================================================================ sub-layers
def _project_qkv(cfg: ModelConfig, p_attn: dict, h: torch.Tensor):
    B, S, _ = h.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p_attn["wq"]).reshape(B, S, H, Dh)
    k = (h @ p_attn["wk"]).reshape(B, S, KV, Dh)
    v = (h @ p_attn["wv"]).reshape(B, S, KV, Dh)
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
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p["attn"], h)
    q, k = _rope(cfg, ctx, q, k)
    new_cache = {}
    if ctx.mode == "decode":
        kc, vc = cache_insert(cache["k"], cache["v"], k, v, ctx.pos)
        out = decode_attention(q, kc, vc, ctx.pos, ring=cfg.sliding_window is not None)
        new_cache = {"k": kc, "v": vc}
    else:
        if _use_kernels(cfg, q):
            out = flash_attention(q, k, v, ctx.causal, cfg.sliding_window)
        else:
            out = attention(q, k, v, causal=ctx.causal, window=cfg.sliding_window,
                            q_chunk=cfg.attn_q_chunk)
        if ctx.mode == "prefill":
            new_cache = _prefill_kv_cache(cfg, ctx, k, v)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
    return out, new_cache


def _prefill_kv_cache(cfg: ModelConfig, ctx: Ctx, k: torch.Tensor, v: torch.Tensor) -> dict:
    B, S, KV, Dh = k.shape
    L = ctx.cache_len

    def build(t):
        buf = t.new_zeros((B, L, KV, Dh))
        if cfg.sliding_window is not None and S > L:
            # ring discipline: token s lives at slot s % L
            slots = torch.arange(S - L, S, device=t.device) % L
            buf[:, slots] = t[:, S - L :]
        else:
            n = min(S, L)
            buf[:, :n] = t[:, :n]
        return buf

    return {"k": build(k), "v": build(v)}


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """Attention of the decoder's queries over the encoder memory, plain and
    non-causal. Train and prefill project the memory (prefill returns the
    projections as the ``xk``/``xv`` cache); decode reads them from the cache
    and returns the cache's own tensors, so the decode loop copies nothing.
    Returns (mixer_out, new_cache_entries)."""
    h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    B, S, _ = h.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    px = p["xattn"]
    q = (h @ px["wq"]).reshape(B, S, H, Dh)
    new_cache = {}
    if ctx.mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        out = decode_attention(q, xk, xv, xk.shape[1] - 1)
        new_cache = {"xk": xk, "xv": xv}
    else:
        mem = ctx.enc_memory
        xk = (mem @ px["wk"]).reshape(B, -1, KV, Dh)
        xv = (mem @ px["wv"]).reshape(B, -1, KV, Dh)
        out = attention(q, xk, xv, causal=False, q_chunk=cfg.attn_q_chunk)
        if ctx.mode == "prefill":
            new_cache = {"xk": xk, "xv": xv}
    return out.reshape(B, S, H * Dh) @ px["wo"], new_cache


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
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    dh = _shift(h, cache["shift_t"][:, None, :] if cache else None) - h
    mu = pr["tm_mu"]

    def lerp(i):
        return h + dh * mu[i]

    r = (lerp(0) @ pr["tm_wr"]).reshape(B, S, H, Dh)
    k = (lerp(1) @ pr["tm_wk"]).reshape(B, S, H, Dh)
    v = (lerp(2) @ pr["tm_wv"]).reshape(B, S, H, Dh)
    w_raw = pr["tm_w0"] + torch.tanh(lerp(3) @ pr["tm_w1"]) @ pr["tm_w2"]
    logw = ssm.rwkv6_decay(w_raw).reshape(B, S, H, Dh)
    g = torch.nn.functional.silu(lerp(4) @ pr["tm_wg"])
    state0 = cache["wkv"] if cache else None
    if ctx.mode == "decode":
        out1, wkv = ssm.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], pr["tm_u"], state0)
        out = out1[:, None].to(x.dtype)
    elif _use_kernels(cfg, r):
        out, wkv = rwkv6(r, k, v, logw.to(r.dtype), pr["tm_u"], state0)
    else:
        out, wkv = ssm.rwkv6_chunked(r, k, v, logw, pr["tm_u"], state0)
    out = rmsnorm(out.reshape(B, S, H * Dh), pr["tm_ln"], cfg.norm_eps) * g
    x = x + out @ pr["tm_wo"]
    # ---- channel mix
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    dh2 = _shift(h2, cache["shift_c"][:, None, :] if cache else None) - h2
    cmu = pr["cm_mu"]
    xk = h2 + dh2 * cmu[0]
    xr = h2 + dh2 * cmu[1]
    kk = torch.square(torch.relu(xk @ pr["cm_k"]))
    x = x + torch.sigmoid(xr @ pr["cm_r"]) * (kk @ pr["cm_v"])
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
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
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
        y1, hs = ssm.mamba_step(u[:, 0], dt[:, 0], A, B_[:, 0], C_[:, 0], h0)
        y = y1[:, None].to(x.dtype)
    elif _use_kernels(cfg, u):
        y, hs = mamba_scan(u, dt, A, B_, C_, h0)
    else:
        y, hs = ssm.mamba_scan_chunked(u, dt, A, B_, C_, h0)
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


def _ffn_or_moe(cfg: ModelConfig, kind: LayerKind, p: dict, x: torch.Tensor):
    """The feed-forward sub-layer on rmsnorm(x): SwiGLU, or the expert FFN
    plus, with a dense residual, a SwiGLU on the same normed input (every
    token gets it, the capacity queue's drops included). Returns (out, aux):
    aux is the MoE layer's load-balancing loss (fp32 scalar), else None."""
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if not kind.moe:
        f = p["ffn"]
        return swiglu(h, f["w1"], f["w3"], f["w2"]), None
    pm = p["moe"]
    out, aux = moe_ffn(h, pm["router"], pm["e_w1"], pm["e_w3"], pm["e_w2"], cfg.moe)
    if cfg.moe.dense_residual:
        d = pm["dense"]
        out = out + swiglu(h, d["w1"], d["w3"], d["w2"])
    return out, aux


def apply_block(cfg: ModelConfig, kind: LayerKind, p: dict, x: torch.Tensor, ctx: Ctx, cache):
    """One pattern-position layer. Returns (x, new_cache, aux): aux is an MoE
    layer's load-balancing loss (fp32 scalar), None for any other layer."""
    if kind.mixer == "rwkv6":
        return (*_rwkv_block(cfg, p, x, ctx, cache), None)
    mixer = _mamba_mixer if kind.mixer == "mamba" else _self_attention
    mix, new_cache = mixer(cfg, p, x, ctx, cache)
    x = x + mix
    if "xattn" in p:  # a decoder layer of an encoder-decoder model
        xmix, xcache = _cross_attention(cfg, p, x, ctx, cache)
        x = x + xmix
        new_cache = {**new_cache, **xcache}
    out, aux = _ffn_or_moe(cfg, kind, p, x)
    return x + out, new_cache, aux


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
    return x, {key: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
               for key, cs in new.items()}, None


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token embeddings; a VLM's ``vision_embeds`` [B, S_v, D] take the
    place of the first S_v."""
    x = _embed(params, batch["tokens"])
    if cfg.vision_len_ratio and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def _encode(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The encoder stack, non-causal and in train mode, over the frame
    embeddings ``batch["encoder_embeds"]`` cast to the parameters' dtype;
    returns the normed memory [B, S_enc, D]."""
    enc_x = batch["encoder_embeds"].to(params["enc_final_norm"].dtype)
    enc_x, _, _ = _run_blocks(cfg, params["enc_blocks"], enc_x, Ctx(mode="train", causal=False),
                              pattern=(ENC_KIND,), n_repeats=cfg.n_enc_layers)
    return rmsnorm(enc_x, params["enc_final_norm"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _positions(batch: dict, B: int, S: int, device) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return positions


# ================================================================ entry points
def forward_train(cfg: ModelConfig, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits [B,S,Vp], aux_loss): the
    MoE layers' load-balancing losses summed over the layers, fp32; 0 for a
    model without MoE layers."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    ctx = Ctx(mode="train", positions=_positions(batch, B, S, x.device),
              positions3=batch.get("positions3"))
    if cfg.enc_dec:
        ctx.enc_memory = _encode(cfg, params, batch)
    x, _, aux = _run_blocks(cfg, params["blocks"], x, ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Process a full prompt; returns (caches, last-token logits [B,Vp])."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    eff_cache = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    ctx = Ctx(mode="prefill", positions=_positions(batch, B, S, x.device),
              positions3=batch.get("positions3"), cache_len=eff_cache)
    if cfg.enc_dec:
        ctx.enc_memory = _encode(cfg, params, batch)
    x, caches, _ = _run_blocks(cfg, params["blocks"], x, ctx)
    return caches, _logits(cfg, params, x[:, -1:, :])[:, 0]


def decode_step(cfg: ModelConfig, params: dict, caches: dict, token: torch.Tensor, pos: int):
    """One decode step. token [B,1] int; pos: position of the new token.
    Returns (logits [B,Vp], caches) — the caches are updated in place."""
    x = _embed(params, token)
    x, caches, _ = _run_blocks(cfg, params["blocks"], x, Ctx(mode="decode", pos=int(pos)), caches)
    return _logits(cfg, params, x)[:, 0], caches
