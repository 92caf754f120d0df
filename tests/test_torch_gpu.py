"""Tests of the port that need the card: the CUDA kernels against their plain
versions, and the smoke models with the kernels on against off. They skip
without a CUDA device; run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports only the port (the machine with the card has no JAX).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.mamba import mamba_scan_fwd  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_fwd  # noqa: E402
from repro_torch.launch.serve import prompt_batch  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.optim.compression import ef_compress_tree  # noqa: E402
from repro_torch.train.loop import train_segment  # noqa: E402
from repro_torch.train.steps import make_grad_fn, make_prefill_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

# tests/test_kernels.py:24 and :29-38 (b, sq, sk, h, kv, dh, causal, window)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 128, 128, 4, 1, 128, True, None),
    (1, 256, 256, 4, 4, 64, True, 64),
    (1, 128, 128, 2, 2, 96, False, None),
    (2, 64, 64, 4, 2, 32, True, 16),
    (1, 100, 130, 4, 2, 16, False, None),  # ragged tiles, Dh of the smoke config
    (1, 300, 300, 8, 1, 128, True, None),  # ragged query and KV tiles at jamba's GQA group
    (2, 512, 512, 8, 2, 64, True, None),  # serving length at Dh=64 (128-byte swizzle, one box)
    (8, 128, 128, 16, 16, 64, False, None),  # seamless-m4t's encoder: non-causal, two 64-key tiles
    (8, 512, 512, 16, 16, 64, True, None),  # seamless-m4t's decoder
    (8, 512, 512, 28, 4, 128, True, None),  # qwen2-vl-7b: GQA group 7
    (8, 512, 512, 48, 8, 128, True, 4096),  # mixtral-8x22b: GQA group 6, the window does not bind
    (1, 8192, 8192, 48, 8, 128, True, 4096),  # mixtral-8x22b's long prompt: the window binds
    (8, 512, 512, 56, 8, 128, True, None),  # arctic-480b: 56 heads, GQA group 7
    (8, 512, 512, 32, 32, 96, True, None),  # phi3-mini-3.8B: MHA, Dh 96 (three 32-column TMA boxes a row)
    (8, 512, 512, 32, 8, 64, True, None),  # granite-3-2B: GQA group 4
    (8, 512, 512, 48, 8, 128, True, None),  # internlm2-20B: GQA group 6, no window
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda, shape, dtype):
    b, sq, sk, h, kv, dh, causal, window = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(cuda, getattr(torch, dtype))
               for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
    before = flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref.attention_ref(q, k, v, causal, window)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_takes_a_strided_q(cuda, dtype):
    """q as a head slice of a wider tensor: not contiguous, but 16-byte
    aligned with strides in multiples of 8 elements, so TMA takes it."""
    b, s, h, kv, dh = 2, 200, 4, 2, 128
    rng = np.random.default_rng(1)
    wide, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, getattr(torch, dtype))
                  for shape in ((b, s, 3 * h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    q = wide[:, :, h : 2 * h]
    assert not q.is_contiguous()
    got = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, True, None)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.gpu
def test_cuda_kernel_rejects_misaligned_bf16(cuda):
    """TMA needs a 16-byte-aligned start: a view one element in raises
    before any launch."""
    buf = torch.zeros(1 + 64 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 64, 4, 64)
    k = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(q, k, k)
    assert flash_attention_fwd.launches == before


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 4, 48, device=cuda)  # head dim 48 is not built
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 64, 4, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("prompt", [64, 100])
def test_smoke_prefill_kernel_on_matches_off(cuda, prompt):
    """fp32 smoke prefill with the kernel against the plain path, on the card
    (tests/test_pallas_model_parity.py's 2e-3 bar); both return the cache.
    A prompt that is no multiple of 64 goes through the kernel all the same."""
    cfg = configs.get_smoke("qwen3_0_6b").replace(use_pallas="off")
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt))).to(cuda)
    c_off, l_off = make_prefill_step(cfg, prompt + 8)(params, {"tokens": tokens})
    before = flash_attention_fwd.launches
    c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), prompt + 8)(
        params, {"tokens": tokens})
    assert flash_attention_fwd.launches == before + cfg.n_layers
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    for name in ("k", "v"):
        torch.testing.assert_close(c_on["p0"][name], c_off["p0"][name], rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "qwen2_vl_7b"])
def test_smoke_encdec_and_vlm_prefill_kernel_on_matches_off(cuda, arch):
    """fp32 smoke prefill of the encoder-decoder and the M-RoPE VLM with the
    kernel against the plain path, on the card, at the 2e-3 bar: last
    logits and every cache (seamless adds the projected memory xk/xv). The
    kernel launches once per self-attention layer, the encoder's included."""
    cfg = configs.get_smoke(arch).replace(use_pallas="off")
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    batch = prompt_batch(cfg, 2, 64, seed=0, device=cuda)
    c_off, l_off = make_prefill_step(cfg, 72)(params, batch)
    before = flash_attention_fwd.launches
    c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), 72)(params, batch)
    assert flash_attention_fwd.launches == before + cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    assert set(c_on["p0"]) == set(c_off["p0"]) == ({"k", "v", "xk", "xv"} if cfg.enc_dec else {"k", "v"})
    for name in c_off["p0"]:
        torch.testing.assert_close(c_on["p0"][name], c_off["p0"][name], rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("prompt", [64, 40])
def test_smoke_mixtral_prefill_kernel_on_matches_off(cuda, prompt):
    """fp32 smoke mixtral prefill with the windowed kernel against the plain
    path, on the card: the same experts chosen in every layer, then the last
    logits and the ring caches (8 slots) at the 2e-3 bar."""
    cfg = configs.get_smoke("mixtral_8x22b").replace(use_pallas="off")
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt))).to(cuda)
    routes = {}
    original = moe.router_topk

    def recording(name):
        def router_topk(*args):
            out = original(*args)
            routes.setdefault(name, []).append(out[1])
            return out
        return router_topk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "router_topk", recording("off"))
        c_off, l_off = make_prefill_step(cfg, prompt + 8)(params, {"tokens": tokens})
        before = flash_attention_fwd.launches
        mp.setattr(moe, "router_topk", recording("on"))
        c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), prompt + 8)(params, {"tokens": tokens})
    assert flash_attention_fwd.launches == before + cfg.n_layers
    assert len(routes["on"]) == len(routes["off"]) == cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(routes["on"], routes["off"]))
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    for name in ("k", "v"):
        assert c_on["p0"][name].shape[2] == cfg.sliding_window
        torch.testing.assert_close(c_on["p0"][name], c_off["p0"][name], rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, capacity_factor):
    """fp32 ``moe_ffn`` on the card against the CPU, with and without
    dropped choices: equal expert indices, then gates, output and aux
    within 1e-5."""
    rng = np.random.default_rng(3)
    b, s, d, f, e = 2, 64, 128, 256, 8
    arrays = [rng.normal(0, 1, (b, s, d)), rng.normal(0, d**-0.5, (d, e)), rng.normal(0, d**-0.5, (e, d, f)),
              rng.normal(0, d**-0.5, (e, d, f)), rng.normal(0, f**-0.5, (e, f, d))]
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    cfg = MoEConfig(n_experts=e, top_k=2, capacity_factor=capacity_factor)
    want_route, got_route = moe.router_topk(*cpu[:2], cfg), moe.router_topk(*(t.to(cuda) for t in cpu[:2]), cfg)
    assert torch.equal(got_route[1].cpu(), want_route[1])
    torch.testing.assert_close(got_route[0].cpu(), want_route[0], rtol=1e-5, atol=1e-5)
    (want, want_aux), (got, got_aux) = moe.moe_ffn(*cpu, cfg), moe.moe_ffn(*(t.to(cuda) for t in cpu), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,counts", [
    ("arctic_480b", {"flash_attention_fwd": 2}),
    ("jamba_1_5_large_398b", {"mamba_scan_fwd": 7, "flash_attention_fwd": 1}),
])
def test_smoke_arctic_and_jamba_experts_prefill_kernels_on_match_off(cuda, arch, counts):
    """fp32 smoke prefill of the last two MoE variants, arctic (the dense
    residual beside the experts) and jamba with its experts (MoE beside
    Mamba and attention), the kernels against the plain paths on the card:
    the same experts chosen in every MoE layer, then the last logits and
    every layer's caches (k/v; jamba's Mamba states and conv tails too) at
    the 2e-3 bar."""
    cfg = configs.get_smoke(arch).replace(use_pallas="off")
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))).to(cuda)
    wrappers = {"mamba_scan_fwd": mamba_scan_fwd, "flash_attention_fwd": flash_attention_fwd}
    routes = {}
    original = moe.router_topk

    def recording(name):
        def router_topk(*args):
            out = original(*args)
            routes.setdefault(name, []).append(out[1])
            return out
        return router_topk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "router_topk", recording("off"))
        c_off, l_off = make_prefill_step(cfg, 72)(params, {"tokens": tokens})
        before = {n: wrappers[n].launches for n in counts}
        mp.setattr(moe, "router_topk", recording("on"))
        c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), 72)(params, {"tokens": tokens})
    assert {n: wrappers[n].launches - before[n] for n in counts} == counts
    n_moe = cfg.n_repeats * sum(kind.moe for kind in cfg.pattern)
    assert len(routes["on"]) == len(routes["off"]) == n_moe
    assert all(torch.equal(a, b) for a, b in zip(routes["on"], routes["off"]))
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    assert set(c_on) == set(c_off)
    for key in c_off:
        assert set(c_on[key]) == set(c_off[key])
        for name in c_off[key]:
            torch.testing.assert_close(c_on[key][name], c_off[key][name], rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_ffn_with_the_dense_residual_on_the_card_matches_the_cpu(cuda, capacity_factor):
    """fp32 feed-forward sub-layer of the arctic smoke model (``moe_ffn``
    plus the dense SwiGLU) on the card against the CPU, with and without
    dropped choices: equal expert indices, then output and aux within 1e-5."""
    cfg = configs.get_smoke("arctic_480b")
    cfg = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, dense_residual=True, capacity_factor=capacity_factor))
    p = T._at(init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")["blocks"]["p0"], 0)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 64, cfg.d_model)).astype(np.float32))
    kind = cfg.pattern[0]
    routes = {}
    original = moe.router_topk

    def recording(*args):
        out = original(*args)
        routes[out[1].device.type] = out[1].cpu()
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "router_topk", recording)
        want, want_aux = T._ffn_or_moe(cfg, kind, p, x)
        got, got_aux = T._ffn_or_moe(cfg, kind, tree_map(lambda t: t.to(cuda), p), x.to(cuda))
    assert torch.equal(routes["cuda"], routes["cpu"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


# tests/test_kernels.py:94-95 (b, s, h, dh), then ragged lengths (started from
# a zero state) at the smoke config's head dim, the serving head count, one
# step past a 16-step chunk, and Dh=96, whose bf16 blocks own 48 value columns
# each (three mma warps, two blocks a head).
RWKV_SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (1, 32, 1, 128), (2, 40, 4, 16), (1, 37, 32, 64),
               (2, 17, 4, 64), (1, 40, 2, 96)]
RWKV_STATE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-3, atol=3e-3)}


def _rwkv_inputs(shape, dtype, device):
    """tests/test_kernels.py's inputs: logw = -|N(0, 1)| - 0.05 in the dtype,
    u fp32, state0 ~ N(0, 0.3) fp32 (None for the ragged shapes)."""
    b, s, h, dh = shape
    rng = np.random.default_rng(42)
    dt = getattr(torch, dtype)

    def t(x, d=dt):
        return torch.from_numpy(x.astype(np.float32)).to(device, d)

    r, k, v = (t(rng.normal(0, 1, shape)) for _ in range(3))
    logw = t(-np.abs(rng.normal(0, 1, shape)) - 0.05)
    u = t(rng.normal(0, 1, (h, dh)), torch.float32)
    s0 = t(rng.normal(0, 0.3, (b, h, dh, dh)), torch.float32) if s % 16 == 0 else None
    return r, k, v, logw, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RWKV_SHAPES)
def test_rwkv6_kernel_matches_plain_version(cuda, shape, dtype):
    r, k, v, logw, u, s0 = _rwkv_inputs(shape, dtype, cuda)
    before = rwkv6_fwd.launches
    out, state = ops.rwkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_fwd.launches == before + 1
    assert out.dtype == r.dtype and out.shape == r.shape and state.dtype == torch.float32
    want_out, want_state = ref.rwkv6_ref(r, k, v, logw, u, s0)
    np.testing.assert_allclose(out.float().cpu().numpy(), want_out.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(state.cpu().numpy(), want_state.cpu().numpy(), **RWKV_STATE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_rwkv6_kernel_takes_unaligned_views(cuda, dh):
    """r, k, v, logw as head-dim slices one element into a wider tensor: not
    16-byte aligned, so the bf16 kernel loads them element by element."""
    b, s, h = 2, 40, 2
    rng = np.random.default_rng(7)
    wide = [rng.normal(0, 1, (b, s, h, dh + 1)) for _ in range(4)]
    wide[3] = -np.abs(wide[3]) - 0.05
    r, k, v, logw = (torch.from_numpy(x.astype(np.float32)).to(cuda, torch.bfloat16)[..., 1:] for x in wide)
    u = torch.from_numpy(rng.normal(0, 1, (h, dh)).astype(np.float32)).to(cuda)
    s0 = torch.from_numpy(rng.normal(0, 0.3, (b, h, dh, dh)).astype(np.float32)).to(cuda)
    out, state = rwkv6_fwd(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    want_out, want_state = ref.rwkv6_ref(r, k, v, logw, u, s0)
    np.testing.assert_allclose(out.float().cpu().numpy(), want_out.float().cpu().numpy(), **TOL["bfloat16"])
    np.testing.assert_allclose(state.cpu().numpy(), want_state.cpu().numpy(), **RWKV_STATE_TOL["bfloat16"])


@pytest.mark.gpu
def test_rwkv6_kernel_rejects_what_it_does_not_take(cuda):
    r, k, v, logw, u, s0 = _rwkv_inputs((1, 32, 2, 32), "float32", cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6_fwd(r.cpu(), k.cpu(), v.cpu(), logw.cpu(), u.cpu(), s0.cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6_fwd(r, k, v, logw, u, s0.cpu())
    with pytest.raises(ValueError, match="float32 or bfloat16 alike"):
        rwkv6_fwd(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="float32 or bfloat16 alike"):
        rwkv6_fwd(*(t.half() for t in (r, k, v, logw)), u, s0)
    strided = torch.zeros(1, 32, 2, 64, device=cuda)[..., ::2]  # head dim with stride 2
    with pytest.raises(ValueError, match="must be contiguous"):
        rwkv6_fwd(strided, k, v, logw, u, s0)
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_fwd(*(torch.zeros(1, 8, 2, 48, device=cuda) for _ in range(4)),
                  torch.zeros(2, 48, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("prompt", [64, 40])
def test_smoke_rwkv6_prefill_kernel_on_matches_off(cuda, prompt):
    """fp32 rwkv6 smoke prefill with the kernel against the chunked plain
    path (the naive one at 40), on the card, at tests/test_pallas_model_parity.py's
    2e-3 bar: last logits and every layer's state and carries."""
    cfg = configs.get_smoke("rwkv6_1_6b").replace(use_pallas="off")
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt))).to(cuda)
    c_off, l_off = make_prefill_step(cfg, prompt + 8)(params, {"tokens": tokens})
    before = rwkv6_fwd.launches
    c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), prompt + 8)(
        params, {"tokens": tokens})
    assert rwkv6_fwd.launches == before + cfg.n_layers
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    for name in ("wkv", "shift_t", "shift_c"):
        torch.testing.assert_close(c_on["p0"][name], c_off["p0"][name], rtol=2e-3, atol=2e-3)


# tests/test_kernels.py:130 (b, s, di, st), a ragged length at the smoke
# config's state size (started from a zero state), a channel count that is no
# multiple of the kernel's 128-channel block, and a serving-width slice.
MAMBA_SHAPES = [(2, 64, 64, 8), (1, 128, 256, 16), (2, 40, 96, 4), (1, 64, 200, 16),
                (2, 37, 16384, 16)]
MAMBA_STATE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_kernels.py:144-145


def _mamba_inputs(shape, dtype, device):
    """tests/test_kernels.py's inputs: u, B, C ~ N(0, 1), dt = 0.1 |N(0, 1)|
    in the dtype, A = -|N(0, 1)| fp32, h0 ~ N(0, 0.3) fp32 (None for the
    ragged lengths)."""
    b, s, di, st = shape
    rng = np.random.default_rng(3)
    dt_ = getattr(torch, dtype)

    def t(x, d=dt_):
        return torch.from_numpy(x.astype(np.float32)).to(device, d)

    u = t(rng.normal(0, 1, (b, s, di)))
    dt = t(np.abs(rng.normal(0, 1, (b, s, di))) * 0.1)
    A = t(-np.abs(rng.normal(0, 1, (di, st))), torch.float32)
    B_, C_ = (t(rng.normal(0, 1, (b, s, st))) for _ in range(2))
    h0 = t(rng.normal(0, 0.3, (b, di, st)), torch.float32) if s % 64 == 0 else None
    return u, dt, A, B_, C_, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_mamba_kernel_matches_plain_version(cuda, shape, dtype):
    u, dt, A, B_, C_, h0 = _mamba_inputs(shape, dtype, cuda)
    before = mamba_scan_fwd.launches
    y, h = ops.mamba_scan(u, dt, A, B_, C_, h0)
    torch.cuda.synchronize()
    assert mamba_scan_fwd.launches == before + 1
    assert y.dtype == u.dtype and y.shape == u.shape and h.dtype == torch.float32
    want_y, want_h = ref.mamba_ref(u, dt, A, B_, C_, h0)
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(), **MAMBA_STATE_TOL)


@pytest.mark.gpu
def test_mamba_kernel_takes_unaligned_views(cuda):
    """u and dt as channel slices one element into a wider tensor: not
    16-byte aligned, so the bf16 kernel loads them element by element; y
    has an odd channel count, so it is stored element by element too."""
    b, s, di, st = 2, 40, 201, 16
    u, dt, A, B_, C_, _ = _mamba_inputs((b, s, di + 1, st), "bfloat16", cuda)
    u, dt, A = u[..., 1:], dt[..., 1:], A[1:].contiguous()
    y, h = mamba_scan_fwd(u, dt, A, B_, C_)
    torch.cuda.synchronize()
    want_y, want_h = ref.mamba_ref(u, dt, A, B_, C_)
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.float().cpu().numpy(), **TOL["bfloat16"])
    np.testing.assert_allclose(h.cpu().numpy(), want_h.cpu().numpy(), **MAMBA_STATE_TOL)


@pytest.mark.gpu
def test_mamba_kernel_rejects_what_it_does_not_take(cuda):
    u, dt, A, B_, C_, h0 = _mamba_inputs((1, 64, 64, 8), "float32", cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        mamba_scan_fwd(*(t.cpu() for t in (u, dt, A, B_, C_, h0)))
    with pytest.raises(ValueError, match="CUDA device"):
        mamba_scan_fwd(u, dt, A, B_, C_, h0.cpu())
    with pytest.raises(ValueError, match="float32 or bfloat16 alike"):
        mamba_scan_fwd(u, dt.bfloat16(), A, B_, C_, h0)
    with pytest.raises(ValueError, match="float32 or bfloat16 alike"):
        mamba_scan_fwd(u.half(), dt.half(), A, B_.half(), C_.half(), h0)
    with pytest.raises(ValueError, match="contiguous float32"):
        mamba_scan_fwd(u, dt, A.bfloat16(), B_, C_, h0)
    with pytest.raises(ValueError, match="must be contiguous"):
        mamba_scan_fwd(torch.zeros(1, 64, 128, device=cuda)[..., ::2], dt, A, B_, C_, h0)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan_fwd(u, dt, A[:, :6].contiguous(), B_[..., :6], C_[..., :6])
    with pytest.raises(ValueError, match="B and C must be"):
        mamba_scan_fwd(u, dt, A, B_[:, :32], C_, h0)


@pytest.mark.gpu
@pytest.mark.parametrize("prompt", [64, 40])
def test_smoke_jamba_prefill_kernels_on_match_off(cuda, prompt):
    """fp32 jamba smoke prefill without experts (16 layers: 14 Mamba, 2
    attention) with the kernels against the plain paths (the chunked scan's
    naive fallback at these lengths), on the card, at
    tests/test_pallas_model_parity.py's 2e-3 bar: last logits, every Mamba
    layer's state and conv tail, the attention layers' k/v."""
    cfg = configs.get_smoke("jamba_1_5_large_398b").replace(use_pallas="off", moe=None, n_layers=16)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt))).to(cuda)
    c_off, l_off = make_prefill_step(cfg, prompt + 8)(params, {"tokens": tokens})
    before = (mamba_scan_fwd.launches, flash_attention_fwd.launches)
    c_on, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), prompt + 8)(
        params, {"tokens": tokens})
    assert (mamba_scan_fwd.launches - before[0], flash_attention_fwd.launches - before[1]) == (14, 2)
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    assert set(c_on) == set(c_off)
    for key in c_off:
        assert set(c_on[key]) == set(c_off[key])
        for name in c_off[key]:
            torch.testing.assert_close(c_on[key][name], c_off[key][name], rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides,counts", [
    ("rwkv6_1_6b", {}, {"rwkv6_fwd": 2}),
    ("jamba_1_5_large_398b", {"moe": None, "n_layers": 16}, {"mamba_scan_fwd": 14, "flash_attention_fwd": 2}),
])
def test_smoke_bf16_prefill_kernels_on_stay_within_twice_bf16_error(cuda, arch, overrides, counts):
    """bf16 smoke prefill (B=2 x 64) with the redesigned bf16 kernels against
    the plain paths on the same weights cast: the last logits may differ by
    at most twice the bf16 plain path's own error against fp32 (chip_smoke.py
    holds the full-width models to the same bar)."""
    cfg = configs.get_smoke(arch).replace(use_pallas="off", **overrides)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))).to(cuda)
    _, l32 = make_prefill_step(cfg, 72)(params, {"tokens": tokens})

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.bfloat16() for k, v in tree.items()}

    params16 = cast(params)
    wrappers = {"rwkv6_fwd": rwkv6_fwd, "mamba_scan_fwd": mamba_scan_fwd, "flash_attention_fwd": flash_attention_fwd}
    before = {n: wrappers[n].launches for n in counts}
    _, l_off = make_prefill_step(cfg, 72)(params16, {"tokens": tokens})
    _, l_on = make_prefill_step(cfg.replace(use_pallas="auto"), 72)(params16, {"tokens": tokens})
    assert {n: wrappers[n].launches - before[n] for n in counts} == counts
    err_kernel = (l_on.float() - l_off.float()).abs().max().item()
    err_bf16 = (l_off.float() - l32.float()).abs().max().item()
    assert torch.isfinite(l_on.float()).all()
    assert err_kernel <= 2 * err_bf16, (err_kernel, err_bf16)


def _grad_case(kernel, cuda):
    """(op, fp32 inputs on the card, plain version, differentiable input
    positions) at one shape per kernel; the state inputs are given."""
    rng = np.random.default_rng(5)

    def t(shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(0, 1, shape)).astype(np.float32)).to(cuda)

    if kernel == "flash":
        b, s, h, kv, dh = 2, 128, 4, 2, 64
        return ops.flash_attention, [t((b, s, h, dh)), t((b, s, kv, dh)), t((b, s, kv, dh)), True, None], \
            ref.attention_ref, 3
    if kernel == "rwkv6":
        b, s, h, dh = 2, 64, 2, 32
        logw = -t((b, s, h, dh)).abs() - 0.05
        return ops.rwkv6, [t((b, s, h, dh)), t((b, s, h, dh)), t((b, s, h, dh)), logw, t((h, dh)),
                           t((b, h, dh, dh), 0.3)], ref.rwkv6_ref, 6
    # S=512: a length that ssm.mamba_scan_chunked would cut in two; the op's backward keeps the loop
    b, s, di, st = (2, 512, 128, 16) if kernel == "mamba_512" else (2, 64, 64, 8)
    return ops.mamba_scan, [t((b, s, di)), 0.1 * t((b, s, di)).abs(), -t((di, st)).abs(), t((b, s, st)),
                            t((b, s, st)), t((b, di, st), 0.3)], ref.mamba_ref, 6


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash", "rwkv6", "mamba", "mamba_512"])
def test_kernel_ops_keep_their_gradients(cuda, kernel):
    """On the card each op's outputs carry a grad_fn, and the gradients of a
    random weighting of them equal the plain version's autograd (the
    backward recomputes through it; Mamba also at S=512, jamba's train
    length; fp32 1e-5)."""
    op, args, plain, n_diff = _grad_case(kernel, cuda)
    counters = {"flash": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd,
                "mamba_512": mamba_scan_fwd}
    grads = []
    for fn in (op, plain):
        leaves = [a.clone().requires_grad_() for a in args[:n_diff]]
        before = counters[kernel].launches
        outs = fn(*leaves, *args[n_diff:])
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert counters[kernel].launches == before + (fn is op)
        assert all(o.grad_fn is not None for o in outs)
        weights = [torch.from_numpy(np.random.default_rng(6).normal(0, 1, o.shape).astype(np.float32)).to(cuda)
                   for o in outs]
        sum((o * w).sum() for o, w in zip(outs, weights)).backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_smoke_forward_train_gradients_kernel_on_match_off(cuda):
    """qwen3 smoke forward_train in fp32 with the flash kernel: every
    parameter gets the gradient it gets with the kernel off (2e-3)."""
    cfg = configs.get_smoke("qwen3_0_6b").replace(use_pallas="off")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))).to(cuda)
    grads = []
    for use_pallas in ("off", "on"):
        params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
        leaves = {}

        def walk(node, prefix=""):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    leaves[prefix + k] = v.requires_grad_()

        walk(params)
        before = flash_attention_fwd.launches
        logits, _ = T.forward_train(cfg.replace(use_pallas=use_pallas), params, {"tokens": tokens})
        assert flash_attention_fwd.launches - before == (cfg.n_layers if use_pallas == "on" else 0)
        logits.float().square().mean().backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    assert all(g is not None for g in grads[1].values())
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ training
def _smoke_tree(dev, seed):
    """A small parameter-shaped tree: leaves of 1, 2 and 3 dims."""
    g = torch.Generator().manual_seed(seed)
    tree = {"final_norm": 1 + 0.1 * torch.randn(8, generator=g), "embed": 0.5 * torch.randn(16, 8, generator=g),
            "blocks": {"w": 0.3 * torch.randn(2, 8, 4, generator=g)}}
    return {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_on_cuda_matches_the_cpu(cuda, schedule):
    """Four AdamW updates (fp32 moments, the last step clipped) on the card
    and on the CPU from the same values: params, m, v within 1e-6 (the same
    fp32 operations; the card may round pow and cos differently by an ulp)."""
    out = {}
    for dev in ("cpu", cuda):
        opt = AdamW(lr=cosine_schedule(1e-2, 2, 6) if schedule else 1e-2)
        params = _smoke_tree(dev, 0)
        state = opt.init(params)
        for k in range(4):
            grads = tree_map(lambda v: v * (30.0 if k == 3 else 1.0), _smoke_tree(dev, k + 1))
            params, state, stats = opt.update(grads, state, params)
        assert state["step"].device.type == torch.device(dev).type and state["step"].item() == 4
        out[str(dev)] = (params, state)
    (p_cpu, s_cpu), (p_gpu, s_gpu) = out["cpu"], out[str(cuda)]
    for a, b in ((p_gpu, p_cpu), (s_gpu["m"], s_cpu["m"]), (s_gpu["v"], s_cpu["v"])):
        for x, y in zip(leaves(a), leaves(b)):
            torch.testing.assert_close(x.cpu().float(), y.float(), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_ef_compression_on_cuda_equals_the_cpu(cuda):
    """Two rounds of int8 error feedback, the residual carried, on the card
    and on the CPU from the same gradients, fp32 and their bf16 cast: the
    dequantised gradients and both residuals equal bit for bit (amax, a
    division, round half to even, a clamp and fp32 products and sums, each
    exact or correctly rounded)."""
    g = torch.Generator().manual_seed(3)
    grads32 = {"embed": 1e-3 * torch.randn(4099, 256, generator=g), "norm": torch.randn(256, generator=g),
               "blocks": {"w": 1e-2 * torch.randn(2, 256, 768, generator=g).exp()}}
    for dtype in (torch.float32, torch.bfloat16):
        cpu = tree_map(lambda t: t.to(dtype), grads32)
        on_card = tree_map(lambda t: t.to(cuda), cpu)
        r_cpu = r_card = None
        for _ in range(2):
            (d_cpu, r_cpu), (d_card, r_card) = ef_compress_tree(cpu, r_cpu), ef_compress_tree(on_card, r_card)
            for a, b in ((d_card, d_cpu), (r_card, r_cpu)):
                for x, y in zip(leaves(a), leaves(b)):
                    assert x.device.type == "cuda" and x.dtype == y.dtype
                    bits = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
                    assert torch.equal(x.cpu().view(bits), y.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,seq", [("qwen3_0_6b", 64), ("rwkv6_1_6b", 64), ("jamba_1_5_large_398b", 512)])
def test_smoke_train_step_kernel_on_matches_off(cuda, arch, seq):
    """qwen3, rwkv6 and jamba (no experts; at S=512, jamba's train length)
    smoke, fp32, remat on: the loss and
    every gradient with the kernels against without (2e-3); each kernel
    runs twice per layer of its kind (the forward and remat's recompute)."""
    cfg = configs.get_smoke(arch).replace(moe=None)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, seq))).to(cuda)
    mixers = [kind.mixer for kind in cfg.pattern] * cfg.n_repeats
    want = {kernel: 2 * mixers.count(mixer) for kernel, mixer in
            ((flash_attention_fwd, "attn"), (rwkv6_fwd, "rwkv6"), (mamba_scan_fwd, "mamba"))}
    results = {}
    for use_pallas in ("off", "on"):
        params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device=cuda)
        before = {k: k.launches for k in want}
        results[use_pallas] = make_grad_fn(cfg.replace(use_pallas=use_pallas))(params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert {k: k.launches - before[k] for k in want} == {k: n if use_pallas == "on" else 0
                                                               for k, n in want.items()}
    (l_off, _, g_off), (l_on, _, g_on) = results["off"], results["on"]
    torch.testing.assert_close(l_on, l_off, rtol=2e-3, atol=2e-3)
    for a, b in zip(leaves(g_on), leaves(g_off)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


_RESUME = """
import json, sys, tempfile
import torch
torch.use_deterministic_algorithms(True)
from repro_torch import configs
from repro_torch.core.repo import Repository
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import train_segment

cfg = configs.get_smoke("qwen3_0_6b")
ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=1)
keys = []
with tempfile.TemporaryDirectory() as d:
    for name, segments in (("a", [(6, 2)]), ("b", [(3, 3), (6, 3)])):
        repo = Repository.init(f"{d}/{name}")
        for n, every in segments:
            train_segment(repo, cfg, ds, n_steps=n, ckpt_every=every, device="cuda")
        _, manifest = CheckpointManager(repo).restore(device="cuda")
        keys.append({p: m["key"] for p, m in manifest["leaves"].items()})
print(json.dumps(keys))
"""


@pytest.mark.gpu
def test_smoke_resume_is_bit_for_bit_on_the_card(cuda):
    """6 steps unbroken against 3, a new segment, 3 more, on the card with
    deterministic algorithms (in a child process: cuBLAS reads its
    workspace setting once): every leaf's annex key, so its bytes, equal."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    out = subprocess.run([sys.executable, "-c", _RESUME], capture_output=True, text=True, env=env,
                         timeout=600, check=True).stdout
    a, b = json.loads(out.splitlines()[-1])
    assert len(a) == 3 * 13 + 1 and a == b  # params, m and v of 13 leaves, and the step


@pytest.mark.gpu
def test_train_segment_runs_the_flash_op_with_gradients(cuda, tmp_path, monkeypatch):
    """Under train_segment on the card every flash op output carries a
    grad_fn, and the kernel launches twice per layer per step."""
    cfg = configs.get_smoke("qwen3_0_6b")
    seen = []

    def flash(*a, **kw):
        out = ops.flash_attention(*a, **kw)
        seen.append(out.grad_fn is not None)
        return out

    monkeypatch.setattr(T, "flash_attention", flash)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    before = flash_attention_fwd.launches
    res = train_segment(Repository.init(str(tmp_path / "r")), cfg, ds, n_steps=2, ckpt_every=2, device=cuda)
    assert flash_attention_fwd.launches - before == 2 * 2 * cfg.n_layers
    assert len(seen) == 2 * 2 * cfg.n_layers and all(seen)
    assert np.isfinite(res.final_loss) and res.checkpoint_commit


# ---------------------------------------------------------------- sharded runs
# A one-rank NCCL process group and a (1, 1) ("data", "model") mesh: the
# DTensor and local_map path of a sharded run, through the kernels, against
# the unsharded run. One card cannot hold two NCCL ranks; the multi-rank
# checks run on the CPU with gloo (tests/test_torch_sharded_run.py).
@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m gpu")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _sharded_tokens(cfg, params, rules, batch, gen: int, cache_len: int):
    """Greedy tokens and every step's logits of prefill + ``gen - 1`` decode
    steps, and the kernels' launches over them."""
    from repro_torch.train.steps import greedy_token, make_decode_step

    counters = (flash_attention_fwd, rwkv6_fwd, mamba_scan_fwd)
    before = [c.launches for c in counters]
    pre = make_prefill_step(cfg, cache_len, rules=rules)
    dec = make_decode_step(cfg, rules=rules)
    caches, logits = pre(params, batch)
    prompt = batch["tokens"].shape[1]
    toks, lg = [greedy_token(cfg, logits)], [logits]
    for i in range(gen - 1):
        logits, caches = dec(params, caches, toks[-1], prompt + i)
        toks.append(greedy_token(cfg, logits))
        lg.append(logits)
    torch.cuda.synchronize()

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    return ([full(t) for t in toks], [full(t) for t in lg],
            [c.launches - b for c, b in zip(counters, before)])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "rwkv6_1_6b", "jamba_1_5_large_398b"])
def test_sharded_smoke_serving_on_a_one_rank_mesh_matches_unsharded(mesh11, arch):
    """fp32 smoke serving (jamba with its experts), kernels on: prefill and 3
    decode steps on the (1, 1) mesh give the unsharded run's tokens exactly,
    its logits to 1e-5, and the same kernel launches."""
    from repro_torch.distributed.sharding import rules_for

    cfg = configs.get_smoke(arch).replace(use_pallas="on")
    rules = rules_for(cfg, mesh11)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 64))).cuda()}
    plain = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cuda")
    placed = init_params(T.param_defs(cfg, rules), seed=0, dtype=torch.float32, device="cuda", rules=rules)
    tok0, lg0, n0 = _sharded_tokens(cfg, plain, None, batch, 4, 72)
    tok1, lg1, n1 = _sharded_tokens(cfg, placed, rules, batch, 4, 72)
    assert n1 == n0 and sum(n0) > 0
    for a, b in zip(tok1, tok0):
        assert torch.equal(a, b)
    for a, b in zip(lg1, lg0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x22b", "seamless_m4t_large_v2"])
def test_seq_placed_decode_on_a_one_rank_mesh_matches_unsharded(mesh11, arch):
    """fp32 smoke serving with the KV cache's slots over tp
    (``decode_kv_shard="seq"``; mixtral's ring wraps, seamless's memory is
    seq-placed too): the unsharded run's tokens exactly, its logits to 1e-5,
    and the same launches."""
    from repro_torch.distributed.sharding import rules_for

    cfg = configs.get_smoke(arch).replace(use_pallas="on", decode_kv_shard="seq")
    rules = rules_for(cfg, mesh11)
    batch = prompt_batch(cfg, 8, 64, 0, torch.device("cuda"))
    plain = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cuda")
    placed = init_params(T.param_defs(cfg, rules), seed=0, dtype=torch.float32, device="cuda", rules=rules)
    tok0, lg0, n0 = _sharded_tokens(cfg, plain, None, batch, 4, 72)
    tok1, lg1, n1 = _sharded_tokens(cfg, placed, rules, batch, 4, 72)
    assert n1 == n0 and n0[0] > 0 and rules.kv_cache(True)[1] == "model"
    for a, b in zip(tok1, tok0):
        assert torch.equal(a, b)
    for a, b in zip(lg1, lg0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash", "rwkv6", "mamba"])
def test_kernel_ops_under_local_map_equal_the_plain_tensor_call(mesh11, kernel):
    """Each kernel through the model's local_map wiring, on DTensor inputs
    on the (1, 1) mesh, equals the call on plain tensors bit for bit, one
    launch each."""
    from repro_torch.distributed.sharding import P, distribute_local, placements, rules_for

    rules = rules_for(configs.get_smoke("qwen3_0_6b"), mesh11)
    ctx = T.Ctx(mode="prefill", rules=rules)
    op, args, _, _ = _grad_case(kernel, "cuda")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dargs = [distribute_local(a, mesh11, placements(P(), mesh11)) for a in tensors]
    counter = {"flash": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}[kernel]
    wired = {"flash": lambda *a: T._attend(ctx, lambda q, k, v: ops.flash_attention(q, k, v, True, None), *a),
             "rwkv6": lambda *a: T._on_heads_wkv(ctx, ops.rwkv6, *a),
             "mamba": lambda *a: T._on_channels_scan(ctx, ops.mamba_scan, *a)}[kernel]
    with torch.no_grad():
        before = counter.launches
        got = wired(*dargs)
        assert counter.launches == before + 1
        want = op(*args)
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert type(g).__name__ == "DTensor"
        assert torch.equal(g.full_tensor(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash", "rwkv6", "mamba"])
def test_kernel_op_refuses_a_dtensor_outside_local_map(mesh11, kernel):
    from repro_torch.distributed.sharding import P, distribute_local, placements

    op, args, _, _ = _grad_case(kernel, "cuda")
    counter = {"flash": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}[kernel]
    dargs = [distribute_local(a, mesh11, placements(P(), mesh11)) if isinstance(a, torch.Tensor) else a
             for a in args]
    before = counter.launches
    with pytest.raises(TypeError, match="not DTensors"):
        op(*dargs)
    assert counter.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_smoke_train_step_on_a_one_rank_mesh_matches_unsharded(mesh11, fsdp):
    """One fp32 smoke qwen3 train step, flash kernel on, on the (1, 1) mesh
    (the backward runs on the card's autograd thread): loss and params after
    the step equal the unsharded step's at the CPU test's step tolerance."""
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.train.steps import make_train_step

    cfg = configs.get_smoke("qwen3_0_6b").replace(use_pallas="on")
    rules = rules_for(cfg, mesh11, fsdp=fsdp)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 64))).cuda()}
    out = []
    for r in (None, rules):
        params = init_params(T.param_defs(cfg, r), seed=0, dtype=torch.float32, device="cuda", rules=r)
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        before = flash_attention_fwd.launches
        params, state, metrics = make_train_step(cfg, opt, rules=r)(params, state, batch)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches - before == 2 * cfg.n_layers
        out.append((params, metrics))
    (p0, m0), (p1, m1) = out
    loss1 = m1["loss"].full_tensor() if hasattr(m1["loss"], "full_tensor") else m1["loss"]
    torch.testing.assert_close(loss1, m0["loss"], rtol=1e-4, atol=1e-5)
    for a, b in zip(leaves(p1), leaves(p0)):
        torch.testing.assert_close(a.full_tensor().detach(), b.detach(), rtol=1e-4, atol=1e-5)
