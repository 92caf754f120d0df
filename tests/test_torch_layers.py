"""The port's layers and plain attention against the JAX package, in fp32.

Tolerance 1e-5: both sides compute the same fp32 arithmetic and differ only
in summation order and in the libm of exp/sin/cos/pow (a few ulp at the
magnitudes here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, shape, scale=1.0):
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    (jx, x), (js, s) = _pair(rng, (2, 5, 64)), _pair(rng, (64,))
    _close(layers.rmsnorm(x, s, 1e-5), jlayers.rmsnorm(jx, js, 1e-5))


def test_rmsnorm_keeps_input_dtype_with_fp32_statistics():
    x = torch.full((1, 4), 300.0, dtype=torch.bfloat16)  # x^2 overflows no fp32 sum
    out = layers.rmsnorm(x, torch.ones(4, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert torch.allclose(out.float(), torch.ones(1, 4))


def test_swiglu():
    rng = np.random.default_rng(1)
    jx, x = _pair(rng, (2, 5, 32))
    (j1, w1), (j3, w3), (j2, w2) = (_pair(rng, s, 0.2) for s in ((32, 48), (32, 48), (48, 32)))
    _close(layers.swiglu(x, w1, w3, w2), jlayers.swiglu(jx, j1, j3, j2))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(2)
    jx, x = _pair(rng, (2, 7, 4, 16))
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    _close(layers.apply_rope(x, torch.from_numpy(pos), theta),
           jlayers.apply_rope(jx, jnp.asarray(pos), theta))


@pytest.mark.parametrize("causal,window,q_chunk", [
    (True, None, 1024),
    (True, 8, 1024),
    (False, None, 1024),
    (True, None, 16),  # Sq = 64 > q_chunk: four query chunks
    (True, 8, 16),
])
def test_attention(causal, window, q_chunk):
    rng = np.random.default_rng(3)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, s) for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    got = attention.attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    _close(got, jattn.attention(jq, jk, jv, causal=causal, window=window, q_chunk=q_chunk))


@pytest.mark.parametrize("pos,ring", [(5, False), (11, False), (20, True)])
def test_decode_attention(pos, ring):
    rng = np.random.default_rng(4)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, s) for s in ((2, 1, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    got = attention.decode_attention(q, k, v, pos, ring=ring)
    _close(got, jattn.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), ring=ring))


@pytest.mark.parametrize("pos", [3, 12 + 7])  # in range, and wrapped around the ring
def test_cache_insert_writes_in_place(pos):
    rng = np.random.default_rng(5)
    (jkc, kc), (jvc, vc), (jk, k), (jv, v) = (
        _pair(rng, s) for s in ((2, 12, 2, 16), (2, 12, 2, 16), (2, 1, 2, 16), (2, 1, 2, 16)))
    want_k, want_v = jattn.cache_insert(jkc, jvc, jk, jv, jnp.asarray(pos, jnp.int32))
    got_k, got_v = attention.cache_insert(kc, vc, k, v, pos)
    assert got_k is kc and got_v is vc
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
