"""The bf16 flash-attention kernel's arithmetic, emulated tile by tile in
plain PyTorch on the CPU, against the JAX package.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores: scores
in fp32, scaled by Dh^-0.5 log2(e) and exponentiated with exp2, fp32 m, l
and accumulator, and P rounded to bf16 before the P V product (l sums the
fp32 p). ``emulate_kernel`` repeats that rounding tile by tile, with the
kernel's tile walk (last KV tile first, tiles outside the causal window
skipped) and its masking, so that these tests show here, without the card,
that the rounding stays inside the bf16 bar (tests/test_kernels.py:24,
2e-2) up to the serving length. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402

LOG2E = 1.4426950408889634
NEG_INF = -1e30  # the TPU kernel's NEG_INF
TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py:24, bf16


def emulate_kernel(q, k, v, causal, window, block_m=64, block_n=64):
    """q [B,Sq,H,Dh], k/v [B,Sk,KV,Dh] in bf16 -> [B,Sq,H,Dh] in bf16, with
    the kernel's arithmetic at query tiles of ``block_m`` rows and KV tiles
    of ``block_n`` keys (the kernel's are 64 and 64)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)  # [B, H, Sq, Dh]
    kf = k.float().repeat_interleave(h // kv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // kv, dim=2).transpose(1, 2)
    scale_log2 = float(np.float32(np.float32(d**-0.5) * np.float32(LOG2E)))  # as the host computes it
    out = torch.empty(b, h, sq, d)
    for q0 in range(0, sq, block_m):
        rows = torch.arange(q0, min(q0 + block_m, sq))
        k_begin, k_end = 0, sk
        if causal:
            k_end = min(sk, int(rows[-1]) + 1)
            if window:
                k_begin = max(0, q0 - window + 1)
        m = torch.full((b, h, len(rows), 1), NEG_INF)
        l = torch.zeros(b, h, len(rows), 1)
        acc = torch.zeros(b, h, len(rows), d)
        for n in range((k_end + block_n - 1) // block_n - 1, k_begin // block_n - 1, -1):
            cols = torch.arange(n * block_n, min((n + 1) * block_n, sk))  # keys >= Sk: masked
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale_log2
            if causal:
                valid = cols[None, :] <= rows[:, None]
                if window:
                    valid &= cols[None, :] > rows[:, None] - window
                s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.where(m > 0.5 * NEG_INF, torch.exp2(m - m_new), 1.0)
            p = torch.where(s > 0.5 * NEG_INF, torch.exp2(s - m_new), 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc * (1.0 / torch.where(l == 0, 1.0, l))
    return out.transpose(1, 2).to(q.dtype)


def _inputs(shape, seed=0):
    b, sq, sk, h, kv, dh = shape[:6]
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(0, 1, s), jnp.bfloat16)
              for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]
    return arrays, [tensor_from_numpy(np.asarray(a), torch.device("cpu")) for a in arrays]


# b, sq, sk, h, kv, dh, causal, window: tests/test_kernels.py:29-38, the
# qwen3 serving shape cut in batch and heads, and a ragged length.
SHAPES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 128, 128, 4, 1, 128, True, None),
    (1, 256, 256, 4, 4, 64, True, 64),
    (1, 128, 128, 2, 2, 96, False, None),
    (2, 64, 64, 4, 2, 32, True, 16),
    (1, 512, 512, 2, 1, 128, True, None),
    (2, 40, 40, 4, 2, 64, True, None),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_jax_kernel_and_reference(shape):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (q, k, v) = _inputs(shape)
    got = emulate_kernel(q, k, v, causal, window).float().numpy()
    want_kernel = np.asarray(jax_ops.flash_attention(jq, jk, jv, causal, window, True), np.float32)
    want_ref = np.asarray(jax_ref.attention_ref(jq, jk, jv, causal, window), np.float32)
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


# Ragged lengths that leave a partial query and KV tile: S=300 at jamba's
# GQA group of 8, and Sq != Sk. The Pallas kernel would run these with
# 4-row and 2-row blocks (ops._pick_block), tens of thousands of grid steps
# in interpret mode, so they are held against the JAX reference only.
RAGGED = [
    (1, 300, 300, 8, 1, 128, True, None),
    (1, 100, 130, 4, 2, 16, False, None),
    (1, 300, 300, 2, 2, 64, True, 100),
]


@pytest.mark.parametrize("shape", RAGGED)
def test_emulation_at_ragged_lengths_matches_jax_reference(shape):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (q, k, v) = _inputs(shape, seed=1)
    got = emulate_kernel(q, k, v, causal, window).float().numpy()
    want = np.asarray(jax_ref.attention_ref(jq, jk, jv, causal, window), np.float32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("block_m,block_n", [(64, 128), (128, 64), (128, 128)])
def test_emulation_block_sweep(block_m, block_n):
    """Tile shape must not change the result beyond the bf16 bar
    (tests/test_kernels.py:52-72, there at fp32 and 1e-5)."""
    _, (q, k, v) = _inputs((1, 256, 256, 2, 2, 64, True, None), seed=2)
    want = emulate_kernel(q, k, v, True, None).float().numpy()
    got = emulate_kernel(q, k, v, True, None, block_m, block_n).float().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_masked_rows_and_tiles_give_p_zero():
    """A row whose window holds no key (row - window + 1 >= Sk) has l = 0
    and comes out 0, as in the TPU kernel; a KV tile wholly masked for a row
    leaves that row's m, l and accumulator as they were."""
    _, (q, k, v) = _inputs((1, 96, 32, 2, 2, 16, True, 8), seed=3)
    got = emulate_kernel(q, k, v, True, 8, block_n=16).float()
    assert torch.isfinite(got).all()
    assert (got[:, 39:] == 0).all()  # rows 39.. see no key below Sk = 32
    want = emulate_kernel(q, k, v, True, 8).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
