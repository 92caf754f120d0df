"""Model / run configuration system.

A copy of ``repro.configs.base``: the port keeps its own copy so that it
imports nothing of the JAX package. The fields stay identical to the
reference's (``tests/test_torch_imports.py`` holds them equal); in the port
``use_pallas`` selects the hand-written CUDA kernels ('auto' = on when the
tensors lie on a CUDA device).

One :class:`ModelConfig` expresses every assigned architecture family:
dense GQA transformers, MoE (incl. dense-residual Arctic style), sliding-
window attention, encoder-decoder (audio backbone), M-RoPE VLM backbone,
RWKV6 (attention-free), and Mamba/attention hybrids with interleaved MoE.

Layer heterogeneity is expressed as a repeating *block pattern*: a tuple of
layer descriptors that tiles the depth (e.g. Jamba's 8-layer block with one
attention layer and MoE on every 2nd layer). Stacking weights per pattern
position keeps `lax.scan` over repeats applicable to every family, which is
what keeps compiled HLO size O(pattern) instead of O(depth).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    every_k_layers: int = 1  # MoE on layers where (i % every_k) == every_k-1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class LayerKind:
    mixer: str  # 'attn' | 'rwkv6' | 'mamba'
    moe: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE half-dim sections
    sliding_window: int | None = None
    moe: MoEConfig | None = None
    mamba: MambaConfig = field(default_factory=MambaConfig)
    # encoder-decoder (audio): encoder layers + how encoder length derives
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len_ratio: int = 4  # S_enc = seq_len // ratio
    # vlm: fraction of prefix positions fed as patch embeddings
    vision_len_ratio: int = 0  # 0 = no vision prefix; else S_vis = seq // ratio
    # mixer pattern: 'attn' everywhere by default; 'rwkv6' for ssm family;
    # hybrid uses attn_period (layer i is attention iff i % attn_period ==
    # attn_offset, else mamba)
    ssm: str | None = None  # None | 'rwkv6' | 'mamba'
    attn_period: int = 0  # 0 = homogeneous
    attn_offset: int = 3
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # runtime / optimizer knobs
    opt_moment_dtype: str = "float32"  # 'bfloat16' for 400B-class
    remat: bool = True
    use_pallas: str = "auto"  # 'auto' | 'on' | 'off'
    # performance knobs (hillclimbed in EXPERIMENTS.md §Perf)
    seq_shard_residual: bool = True  # Megatron-style sequence parallelism
    attn_q_chunk: int = 1024  # blockwise attention q-chunk (memory roofline)
    attn_unroll_chunks: bool = False  # python-loop chunks (exact HLO flop counts)
    decode_kv_shard: str = "head_dim"  # 'head_dim' | 'seq': KV-cache tp placement
    moe_expert_axis: str = "data"  # 'data' (ZeRO gather) | 'model' (EP all-to-all)
    fsdp_params: bool = False  # ZeRO-3: params+moments sharded over data AND model
    zero1_moments: bool = False  # ZeRO-1: only Adam moments sharded over data
    microbatches: int = 1  # gradient accumulation (activation-memory / batch trade)
    scan_layers: bool = True

    # -- derived -------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards evenly over any
        production mesh axis (MaxText-style)."""
        return _round_up(self.vocab_size, 256)

    @property
    def pattern(self) -> tuple[LayerKind, ...]:
        """The repeating layer-kind pattern (length divides n_layers)."""
        if self.ssm == "rwkv6":
            return (LayerKind("rwkv6"),)
        if self.attn_period > 0:  # hybrid
            period = self.attn_period
            moe_every = self.moe.every_k_layers if self.moe else 1
            span = math.lcm(period, moe_every)
            kinds = []
            for i in range(span):
                mixer = "attn" if i % period == self.attn_offset else "mamba"
                is_moe = bool(self.moe) and (i % moe_every == moe_every - 1)
                kinds.append(LayerKind(mixer, is_moe))
            return tuple(kinds)
        if self.moe is not None and self.moe.every_k_layers > 1:
            return tuple(
                LayerKind("attn", moe=(i % self.moe.every_k_layers == self.moe.every_k_layers - 1))
                for i in range(self.moe.every_k_layers)
            )
        return (LayerKind("attn", moe=self.moe is not None),)

    @property
    def n_repeats(self) -> int:
        p = len(self.pattern)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by pattern {p}")
        return self.n_layers // p

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba.expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) -------
    def param_counts(self) -> dict:
        """Returns {'total': N, 'active': N_active} (active = per-token)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D  # q,k,v,o
        dense_ffn = 3 * D * F  # SwiGLU w1,w3,w2
        moe_ffn = 0 if not self.moe else self.moe.n_experts * 3 * D * F
        moe_active = 0 if not self.moe else self.moe.top_k * 3 * D * F
        router = 0 if not self.moe else D * self.moe.n_experts
        # rwkv6 time-mix (5 square proj + decay lora) + channel-mix (k,v,r)
        rwkv = 5 * D * D + 2 * D * 64 + (D * F + F * D + D * D)
        # mamba: in_proj 2*Di*D, conv Di*4, x_proj Di*(dt+2*state), dt_proj, out_proj
        Di, St = self.mamba_d_inner, self.mamba.d_state
        mamba = 2 * Di * D + 4 * Di + Di * (Di // 16 + 2 * St) + Di * Di // 16 + Di * D
        total = 0
        active = 0
        for kind in self.pattern:
            if kind.mixer == "attn":
                mix = attn
            elif kind.mixer == "rwkv6":
                mix = rwkv
            else:
                mix = mamba
            if kind.mixer == "rwkv6":
                ffn_t = ffn_a = 0  # channel-mix is part of the rwkv term
            elif kind.moe:
                ffn_t = moe_ffn + router + (dense_ffn if self.moe.dense_residual else 0)
                ffn_a = moe_active + router + (dense_ffn if self.moe.dense_residual else 0)
            else:
                ffn_t = ffn_a = dense_ffn
            total += mix + ffn_t + 2 * D
            active += mix + ffn_a + 2 * D
        total *= self.n_repeats
        active *= self.n_repeats
        if self.enc_dec:
            # encoder layers: self-attn + ffn; decoder already counted; add
            # cross-attention for decoder layers
            enc = (attn + dense_ffn + 2 * D) * self.n_enc_layers
            cross = (attn + D) * self.n_layers
            total += enc + cross
            active += enc + cross
        emb = V * D * (1 if self.tie_embeddings else 2)
        return {"total": total + emb, "active": active + emb}
