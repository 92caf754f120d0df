"""rwkv6-1.6B smoke, the port against the JAX package: the WKV functions of
``models/ssm.py``, the kernel's plain version against the Pallas kernel
(interpret mode) and the JAX reference, and the model's prefill, decode,
greedy tokens and forward, in fp32 on weights initialised by JAX and
converted leaf by leaf.

Tolerances: 1e-5 for the WKV functions (the same fp32 arithmetic in another
summation order); tests/test_kernels.py's for the kernel's plain version
(out fp32 2e-5, bf16 2e-2; state fp32 1e-4, bf16 3e-3); 1e-4 for logits,
states and carries through two layers. Greedy tokens must be equal exactly.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.train.steps import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_fwd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "rwkv6_1_6b"
B, S, GEN = 2, 64, 8
CACHE_LEN = S + GEN
RAGGED = 40
TOL = dict(rtol=1e-4, atol=1e-4)
SSM_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py:24 (out) and :110-111 (state)
KERNEL_TOL = {"float32": (dict(rtol=2e-5, atol=2e-5), dict(rtol=1e-4, atol=1e-4)),
              "bfloat16": (dict(rtol=2e-2, atol=2e-2), dict(rtol=3e-3, atol=3e-3))}
KERNEL_SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (1, 32, 1, 128)]  # tests/test_kernels.py:94-95
CACHE_NAMES = ("wkv", "shift_t", "shift_c")


def _np(t):
    return t.float().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _pair(arr, dtype="float32"):
    """The same values as a JAX array and a CPU tensor (bf16 bit for bit)."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    return j, tensor_from_numpy(np.asarray(j), torch.device("cpu"))


def _wkv_inputs(shape, seed, dtype="float32"):
    """tests/test_kernels.py's inputs: r, k, v ~ N(0, 1), logw = -|N(0, 1)| - 0.05
    cast to the dtype, u ~ N(0, 1) fp32, state0 ~ N(0, 0.3) fp32."""
    b, s, h, dh = shape
    rng = np.random.default_rng(seed)
    r, k, v = (_pair(rng.normal(0, 1, shape), dtype) for _ in range(3))
    logw = _pair((-np.abs(rng.normal(0, 1, shape)) - 0.05).astype(np.float32), dtype)
    u = _pair(rng.normal(0, 1, (h, dh)))
    s0 = _pair(rng.normal(0, 0.3, (b, h, dh, dh)))
    return r, k, v, logw, u, s0


# ------------------------------------------------------------ models/ssm.py
def test_rwkv6_decay_matches_jax():
    jw, w = _pair(np.random.default_rng(0).normal(0, 1.5, (2, 5, 64)))
    _close(ssm.rwkv6_decay(w), jssm.rwkv6_decay(jw), SSM_TOL)


@pytest.mark.parametrize("fn,s", [("rwkv6_naive", 48), ("rwkv6_chunked", 48),
                                  ("rwkv6_chunked", RAGGED)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_functions_match_jax(fn, s, with_state):
    """S=48 runs three chunks; S=40 takes the chunked form's fallback to naive."""
    (jr, r), (jk, k), (jv, v), (jlw, lw), (ju, u), (js0, s0) = _wkv_inputs((2, s, 2, 16), seed=7)
    want_out, want_state = getattr(jssm, fn)(jr, jk, jv, jlw, ju, js0 if with_state else None)
    got_out, got_state = getattr(ssm, fn)(r, k, v, lw, u, s0 if with_state else None)
    assert got_out.dtype == r.dtype and got_state.dtype == torch.float32
    _close(got_out, want_out, SSM_TOL)
    _close(got_state, want_state, SSM_TOL)


def test_rwkv6_step_matches_jax():
    (jr, r), (jk, k), (jv, v), (jlw, lw), (ju, u), (js0, s0) = _wkv_inputs((2, 1, 4, 16), seed=8)
    want_out, want_state = jssm.rwkv6_step(jr[:, 0], jk[:, 0], jv[:, 0], jlw[:, 0], ju, js0)
    got_out, got_state = ssm.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, s0)
    _close(got_out, want_out, SSM_TOL)
    _close(got_state, want_state, SSM_TOL)


# --------------------------------------------------- the kernel's plain version
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_version_matches_jax_kernel_and_reference(shape, dtype):
    (jr, r), (jk, k), (jv, v), (jlw, lw), (ju, u), (js0, s0) = _wkv_inputs(shape, 42, dtype)
    want_kernel = jax_ops.rwkv6(jr, jk, jv, jlw, ju, js0, True)
    want_ref = jax_ref.rwkv6_ref(jr, jk, jv, jlw, ju, js0)
    out_tol, state_tol = KERNEL_TOL[dtype]
    for got_out, got_state in (ref.rwkv6_ref(r, k, v, lw, u, s0), ops.rwkv6(r, k, v, lw, u, s0)):
        assert got_out.dtype == r.dtype and tuple(got_out.shape) == shape
        assert got_state.dtype == torch.float32
        for want_out, want_state in (want_kernel, want_ref):
            _close(got_out, want_out, out_tol)
            _close(got_state, want_state, state_tol)


def test_plain_version_without_a_state_starts_from_zeros():
    (_, r), (_, k), (_, v), (_, lw), (_, u), (_, s0) = _wkv_inputs((1, 8, 2, 16), 3)
    zeros = torch.zeros_like(s0)
    for got, want in zip(ops.rwkv6(r, k, v, lw, u), ref.rwkv6_ref(r, k, v, lw, u, zeros)):
        assert torch.equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU; only ops.rwkv6 routes CPU
    tensors to the plain version."""
    (_, r), (_, k), (_, v), (_, lw), (_, u), (_, s0) = _wkv_inputs((1, 8, 2, 16), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6_fwd(r, k, v, lw, u, s0)


# ------------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, jparams, configs.get_smoke(ARCH), params, tokens


def _jax_prefill(jcfg, jparams, tokens, use_pallas):
    cfg = jcfg.replace(use_pallas=use_pallas)
    return jax.jit(lambda p, b: JT.prefill(cfg, None, p, b, cache_len=CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(tokens)})


def _port_prefill(cfg, params, tokens):
    return make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens)})


def _close_caches(got, want):
    """wkv [n_rep, B, H, Dh, Dh] fp32 and the carries [n_rep, B, D] of every layer."""
    assert set(got) == set(want) == {"p0"}
    assert set(got["p0"]) == set(want["p0"]) == set(CACHE_NAMES)
    for name in CACHE_NAMES:
        assert tuple(got["p0"][name].shape) == want["p0"][name].shape
        _close(got["p0"][name], want["p0"][name])
    assert got["p0"]["wkv"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_prefill_matches_jax(setup, use_pallas):
    """'on' holds the port's kernel branch (its plain version on the CPU)
    against the JAX kernel branch (the Pallas kernel in interpret mode)."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :S], use_pallas)
    caches, logits = _port_prefill(cfg.replace(use_pallas=use_pallas), params, tokens[:, :S])
    _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_kernel_branch_at_a_ragged_length_matches_jax(setup, monkeypatch):
    """At a length that is no multiple of 16 the reference takes its chunked
    path (and that its naive one); the port still goes through the kernel's
    wrapper once per layer, and agrees with the reference."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :RAGGED], "on")
    calls = []
    monkeypatch.setattr(T, "rwkv6", lambda *a: calls.append(1) or ops.rwkv6(*a))
    caches, logits = _port_prefill(cfg.replace(use_pallas="on"), params, tokens[:, :RAGGED])
    assert len(calls) == cfg.n_layers
    _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_decode_steps_match_jax(setup):
    """Four steps: the port updates the stacked state in place, JAX returns a
    new one; both must carry the same values from step to step."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :S], "off")
    caches, _ = _port_prefill(cfg, params, tokens[:, :S])
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(4):
        tok = tokens[:, S + i : S + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, new = step(params, caches, torch.from_numpy(tok), S + i)
        assert new is caches
        _close(logits, jlogits)
        _close_caches(caches, jcaches)


def test_greedy_decode_tokens_equal_jax(setup):
    jcfg, jparams, cfg, params, tokens = setup
    want = jax_greedy_decode(jcfg, None, jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                             GEN, CACHE_LEN)
    got = greedy_decode(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])}, GEN, CACHE_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_train_matches_jax_kernel_on(setup):
    jcfg, jparams, cfg, params, tokens = setup
    jcfg_on = jcfg.replace(use_pallas="on")
    jlogits, _ = jax.jit(lambda p, b: JT.forward_train(jcfg_on, None, p, b))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    with torch.inference_mode():
        logits, aux = T.forward_train(cfg.replace(use_pallas="on"), params,
                                      {"tokens": torch.from_numpy(tokens[:, :S])})
    assert logits.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0
    _close(logits, jlogits)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_decode_matches_forward(use_pallas):
    """prefill(0..t-1) + decode_step(t) reproduces the forward logits at t
    (the port on its own init; as tests/test_archs.py:81-119, in fp32)."""
    cfg = configs.get_smoke(ARCH).replace(use_pallas=use_pallas)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    n_decode, prompt = 4, 28
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, prompt + n_decode)))
    with torch.inference_mode():
        full, _ = T.forward_train(cfg, params, {"tokens": tokens})
    caches, logits = make_prefill_step(cfg, prompt + n_decode)(params, {"tokens": tokens[:, :prompt]})
    np.testing.assert_allclose(logits.numpy(), full[:, prompt - 1].numpy(), **TOL)
    step = make_decode_step(cfg)
    for i in range(n_decode - 1):
        logits, caches = step(params, caches, tokens[:, prompt + i : prompt + i + 1], prompt + i)
        np.testing.assert_allclose(logits.numpy(), full[:, prompt + i].numpy(), **TOL)


def test_serve_main_runs_on_cpu():
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "24", "--gen", "4",
                      "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite
    assert len(res.decode_ms) == 3 and res.prefills == 2 and res.peak_memory_bytes is None
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < configs.get_smoke(ARCH).vocab_size


def test_serve_run_in_bfloat16_stays_finite():
    """The bf16 path the card serves: logw goes to the kernel's wrapper in
    the model dtype, the state stays fp32."""
    entered = []

    @contextlib.contextmanager
    def window(name):
        entered.append(name)
        yield

    res = serve.run(ARCH, batch=2, prompt_len=20, gen=3, device="cpu", dtype="bfloat16",
                    window=window)
    assert entered == ["prefill", "decode"] and res.logits_finite
