"""The flash-attention kernel of the port against the JAX package.

On the CPU the port's wrapper takes the kernel's plain version; both are
held against the JAX Pallas kernel (interpret mode) and the JAX reference at
the shapes and tolerances of tests/test_kernels.py. The CUDA kernel itself
is held against the plain version on the card by tests/test_torch_gpu.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402

# tests/test_kernels.py:24 — fp32 differs from the reference only in summation
# order; bf16 outputs are rounded to 8 mantissa bits.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [  # tests/test_kernels.py:29-38: b, sq, sk, h, kv, dh, causal, window
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),  # GQA 4:1
    (2, 128, 128, 4, 1, 128, True, None),  # MQA
    (1, 256, 256, 4, 4, 64, True, 64),  # sliding window
    (1, 128, 128, 2, 2, 96, False, None),  # encoder (non-causal), Dh=96
    (2, 64, 64, 4, 2, 32, True, 16),
]


def _inputs(shape, dtype, seed=0):
    b, sq, sk, h, kv, dh = shape[:6]
    rng = np.random.default_rng(seed)
    arrays = [jnp.asarray(rng.normal(0, 1, s), getattr(jnp, dtype))
              for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))]
    return arrays, [tensor_from_numpy(np.asarray(a), torch.device("cpu")) for a in arrays]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_kernel_and_reference(shape, dtype):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (q, k, v) = _inputs(shape, dtype)
    want_kernel = np.asarray(jax_ops.flash_attention(jq, jk, jv, causal, window, True), np.float32)
    want_ref = np.asarray(jax_ref.attention_ref(jq, jk, jv, causal, window), np.float32)
    for got in (ref.attention_ref(q, k, v, causal, window),
                ops.flash_attention(q, k, v, causal, window)):
        assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
        np.testing.assert_allclose(_np(got), want_kernel, **TOL[dtype])
        np.testing.assert_allclose(_np(got), want_ref, **TOL[dtype])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU; only ops.flash_attention
    routes CPU tensors to the plain version."""
    _, (q, k, v) = _inputs(SHAPES[0], "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_fwd(q, k, v)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_build_raises_when_nvcc_fails_and_reuses_built_libraries(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        build.build_all()
    assert not list(tmp_path.glob("*.so"))
    for src in build.sources().values():  # a library keyed by this source is present
        build.library_path(src).write_bytes(b"")
    monkeypatch.setattr(build, "nvcc_path", lambda: pytest.fail("rebuilt a built library"))
    assert set(build.build_all()) == set(build.sources())
