"""The yardstick's arithmetic: the card's peaks and the operations and bytes
of the work, from shapes alone.

``attention_pairs``, ``attention_flops`` and ``attention_bytes`` are frozen
copies of ``repro_torch/kernels/costs.py`` (the work the function needs:
each input read once, each output written once, no exponential counted),
so that a change to the program cannot move its own yardstick.

Model FLOPs count what the model needs, not what a kernel does again:
2 x (matrix parameters a token touches) per token forward, 6 x in training,
plus attention's score and value products (3 x the forward's in training);
remat's recompute is not counted. An MoE layer touches its router and its
top-k experts. The head runs at every position in training and at the last
position of each prompt in a prompt phase.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _tri(n: int) -> int:
    return n * (n + 1) // 2 if n > 0 else 0


def attention_pairs(sq: int, sk: int, causal: bool = True, window: int | None = None) -> int:
    """Unmasked (row, col) pairs of one head: row i sees cols up to i when
    causal, and from i - window + 1 with a window."""
    if not causal:
        return sq * sk
    n = min(sq, sk + window) if window else sq
    hi = _tri(min(n, sk)) + max(n - sk, 0) * sk
    lo = _tri(n - window) if window else 0
    return hi - lo


def attention_flops(b: int, sq: int, sk: int, h: int, d: int, causal: bool = True,
                    window: int | None = None) -> int:
    """4 * Dh flops per unmasked (row, col) pair per head: q k^T and p v."""
    return 4 * d * attention_pairs(sq, sk, causal, window) * b * h


def attention_bytes(b: int, sq: int, sk: int, h: int, kv: int, d: int, elem_bytes: int) -> int:
    """q, k and v read once, o written once."""
    return elem_bytes * (2 * b * sq * h * d + 2 * b * sk * kv * d)


def attention_bound_s(b: int, sq: int, sk: int, h: int, kv: int, d: int, elem_bytes: int,
                      causal: bool = True, window: int | None = None) -> float:
    """The least time one launch could take on the card: the larger of its
    FLOPs over the bf16 peak and its bytes over the HBM peak."""
    return max(attention_flops(b, sq, sk, h, d, causal, window) / PEAK_BF16_FLOPS,
               attention_bytes(b, sq, sk, h, kv, d, elem_bytes) / PEAK_HBM_BYTES)


def layer_matrix_params(conf: dict) -> int:
    """Matrix parameters one token touches in one layer of a configuration
    file: q, k, v, o, and SwiGLU's three (or the router and top-k experts')."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = conf.get("head_dim") or d // h
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    if "num_local_experts" in conf:
        return attn + d * conf["num_local_experts"] + conf["num_experts_per_tok"] * 3 * d * f
    return attn + 3 * d * f


def attention_shape(conf: dict) -> dict:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"h": h, "kv": conf["num_key_value_heads"], "d": conf.get("head_dim") or d // h,
            "window": conf["sliding_window"]}


def prefill_flops(conf: dict, b: int, s: int) -> int:
    """A prompt phase of b prompts of s tokens: the layers at every position,
    the head at the last."""
    a = attention_shape(conf)
    layers = conf["num_hidden_layers"]
    return (2 * layer_matrix_params(conf) * b * s * layers
            + 2 * conf["hidden_size"] * conf["vocab_size"] * b
            + attention_flops(b, s, s, a["h"], a["d"], True, a["window"]) * layers)


def train_flops(conf: dict, b: int, s: int) -> int:
    """One training step on b rows of s tokens: forward and backward of the
    layers and the head at every position."""
    a = attention_shape(conf)
    layers = conf["num_hidden_layers"]
    matrices = layer_matrix_params(conf) * layers + conf["hidden_size"] * conf["vocab_size"]
    return 6 * matrices * b * s + 3 * attention_flops(b, s, s, a["h"], a["d"], True, a["window"]) * layers
