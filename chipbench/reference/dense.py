"""Plain fp32 reference of a dense decoder (phi3-mini's family): embedding,
pre-norm RMSNorm blocks of rotary GQA attention and a SwiGLU FFN, a final
RMSNorm and an untied head, as the published configs describe them.

It imports torch alone: nothing of the port, of ``jax`` or of ``repro``.
It reads a configuration file's dict and the weights the benchmark made
(``harness.layers``: per-layer dicts of the very tensors handed to the
port, in the port's ``[in, out]`` layout), upcasts each to fp32 where it
uses it, and works out everything else again. Matrix products run in fp32
with TF32 off (``fp32``), or, for the control, with both operands rounded
to fp8 e4m3 on a per-tensor scale, and the gradient too in a backward
(``fp8``): the precision below the bf16 the configurations state.

Positions are 0..S-1; RoPE rotates the two halves of each head (the
published ``rotate_half`` form) at angles computed in fp64; attention is
causal, within ``sliding_window`` where the config sets one, in blocks of
queries so that an 8,192-token prompt fits. The head covers the real
vocabulary only.

Training follows the port's AdamW (``optim/adamw.py``) as its arithmetic:
the global-norm clip, then per leaf m, v, bias corrections and decoupled
weight decay in fp32, on every leaf but the traffic's ``no_decay``; and,
as the configuration states bf16 weights, each updated weight is rounded to
bf16 for storage. The loss is the mean next-token cross-entropy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
Q_BLOCK = 1024  # query rows a block of attention takes


def fp32_matmuls() -> None:
    """fp32 products in fp32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 on one scale for the tensor (its largest
    magnitude at the format's largest), back in fp32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(FP8).float() * scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Arith:
    """The matrix product of a precision: ``fp32`` or ``fp8``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.fp8 = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _FP8MatMul.apply(a, b) if self.fp8 else a @ b


def dims(conf: dict) -> dict:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"d": d, "h": h, "kv": conf["num_key_value_heads"], "dh": conf.get("head_dim") or d // h,
            "eps": conf["rms_norm_eps"], "theta": float(conf["rope_theta"]),
            "window": conf["sliding_window"], "vocab": conf["vocab_size"]}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, Dh] at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[None, :, None, :], ang.sin().float()[None, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int | None, arith: Arith) -> torch.Tensor:
    """Causal softmax attention; q [B, S, H, Dh], k, v [B, S, KV, Dh]; query
    head h reads KV head h // (H / KV)."""
    b, s, h, dh = q.shape
    rep = h // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    blocks = []
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(s, i0 + Q_BLOCK)
        lo = 0 if window is None else max(0, i0 - window + 1)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(lo, i1, device=q.device)[None, :]
        seen = cols <= rows
        if window is not None:
            seen = seen & (cols > rows - window)
        scores = arith.mm(qh[:, :, i0:i1], kh[:, :, lo:i1].transpose(-1, -2)) * dh**-0.5
        p = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
        blocks.append(arith.mm(p, vh[:, :, lo:i1]))
    return torch.cat(blocks, dim=2).transpose(1, 2)


def attn_sublayer(x, w: dict, n: dict, arith: Arith):
    """x + attention(rmsnorm(x)) @ wo; returns (x, k, v) with k after RoPE."""
    b, s, d = x.shape
    hn = rmsnorm(x, w["ln1"], n["eps"]).reshape(b * s, d)
    q = arith.mm(hn, w["wq"].float()).view(b, s, n["h"], n["dh"])
    k = arith.mm(hn, w["wk"].float()).view(b, s, n["kv"], n["dh"])
    v = arith.mm(hn, w["wv"].float()).view(b, s, n["kv"], n["dh"])
    q, k = rope(q, n["theta"]), rope(k, n["theta"])
    o = attention(q, k, v, n["window"], arith).reshape(b * s, n["h"] * n["dh"])
    return x + arith.mm(o, w["wo"].float()).view(b, s, d), k, v


def swiglu(x2d, w1, w3, w2, arith: Arith):
    return arith.mm(F.silu(arith.mm(x2d, w1.float())) * arith.mm(x2d, w3.float()), w2.float())


def ffn_sublayer(x, w: dict, n: dict, conf: dict, arith: Arith):
    b, s, d = x.shape
    hn = rmsnorm(x, w["ln2"], n["eps"]).reshape(b * s, d)
    return x + swiglu(hn, w["w1"], w["w3"], w["w2"], arith).view(b, s, d)


def logits_of(x, weights: dict, n: dict, arith: Arith):
    """rmsnorm(x) @ head over the real vocabulary; x [..., D]."""
    hn = rmsnorm(x, weights["final_norm"], n["eps"])
    head = weights["lm_head"][:, : n["vocab"]].float()
    return arith.mm(hn.reshape(-1, n["d"]), head).view(*x.shape[:-1], n["vocab"])


@torch.no_grad()
def prefill(weights: dict, tokens: torch.Tensor, conf: dict, precision: str = "fp32",
            ffn=ffn_sublayer) -> dict:
    """The prompt phase of ``tokens`` [B, S]: each layer's K (after RoPE) and
    V [B, S, KV, Dh] and the last position's logits [B, V]; all fp32."""
    fp32_matmuls()
    arith, n = Arith(precision), dims(conf)
    x = weights["embed"][tokens.long()].float()
    ks, vs = [], []
    for w in weights["layers"]:
        x, k, v = attn_sublayer(x, w, n, arith)
        ks.append(k)
        vs.append(v)
        x = ffn(x, w, n, conf, arith)
    return {"k": ks, "v": vs, "last_logits": logits_of(x[:, -1], weights, n, arith)}


def _layer(x, arith, n, conf, ffn, names, *ws):
    w = dict(zip(names, ws))
    x, _, _ = attn_sublayer(x, w, n, arith)
    return ffn(x, w, n, conf, arith)


def train(make_weights, batches: list, conf: dict, opt: dict, precision: str = "fp32",
          half_batch: bool = False, ffn=ffn_sublayer) -> dict:
    """Training steps from the weights ``make_weights()`` gives on ``batches``
    (one [B, S] token tensor a step). The weights are copied to the
    reference's fp32 leaves and kept on the host for the change, so that
    only the reference's own state is on the device. Returns each step's loss, each leaf's norm of the first
    step's clipped gradient (what AdamW takes), and each leaf's norm of the
    change of its weights over all the steps. A leaf is ``embed``,
    ``lm_head``, ``final_norm`` or ``L{layer}/{name}``. ``half_batch`` (a
    fault) drops the second half of each batch's rows."""
    fp32_matmuls()
    arith, n = Arith(precision), dims(conf)
    vocab = n["vocab"]
    weights = make_weights()
    names = sorted(weights["layers"][0])
    n_layers = len(weights["layers"])
    # the reference's own fp32 weights, one tensor a leaf; the pad rows of the
    # port's vocabulary are not the model's
    p0 = {"embed": weights["embed"][:vocab], "lm_head": weights["lm_head"][:, :vocab],
          "final_norm": weights["final_norm"]}
    for i, w in enumerate(weights["layers"]):
        p0.update({f"L{i}/{k}": w[k] for k in names})
    del weights
    params = {k: t.detach().float().clone().requires_grad_() for k, t in p0.items()}
    p0 = {k: t.detach().cpu() for k, t in p0.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    store = getattr(torch, conf["torch_dtype"])
    losses, grad1 = [], {}
    for step, tokens in enumerate(batches, start=1):
        if half_batch:
            tokens = tokens[: tokens.shape[0] // 2]
        tokens = tokens.long()
        x = params["embed"][tokens]
        for i in range(n_layers):
            x = checkpoint(_layer, x, arith, n, conf, ffn, names,
                           *(params[f"L{i}/{k}"] for k in names), use_reentrant=False)
        hn = rmsnorm(x, params["final_norm"], n["eps"])
        logits = arith.mm(hn.reshape(-1, n["d"]), params["lm_head"]).view(*tokens.shape, vocab)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, vocab), tokens[:, 1:].reshape(-1))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del x, hn, logits
        losses.append(loss.item())
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(opt["max_grad_norm"] / (norm + 1e-9), max=1.0)
            bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for k, p in params.items():
                g = grads[k] * scale
                if step == 1:
                    grad1[k] = g.norm().item()
                m[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[k].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                wd = 0.0 if k in opt["no_decay"] else opt["weight_decay"]
                upd = (m[k] / bc1) / ((v[k] / bc2).sqrt() + opt["eps"]) + wd * p
                p.sub_(opt["lr"] * upd)
                p.copy_(p.to(store).float())
        del grads
    change = {k: (params[k].detach() - p0[k].to(p.device).float()).norm().item() for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
