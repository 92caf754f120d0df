"""qwen3-0.6B smoke serving, the port against the JAX package, in fp32 on
weights initialised by JAX and converted leaf by leaf.

Tolerance 1e-4 on logits and caches: the same fp32 arithmetic in another
summation order, through two layers (logits here are O(0.1)). Greedy
tokens must be equal exactly.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.train.steps import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "qwen3_0_6b"
B, S, GEN = 2, 64, 8
CACHE_LEN = S + GEN
TOL = dict(rtol=1e-4, atol=1e-4)


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


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _close_caches(got, want):
    assert set(got) == set(want) == {"p0"}
    for name in ("k", "v"):
        assert tuple(got["p0"][name].shape) == want["p0"][name].shape  # [n_rep, B, L, KV, Dh]
        _close(got["p0"][name], want["p0"][name])


def test_prefill_matches_jax(setup):
    """use_pallas 'auto' on CPU tensors takes the plain blockwise path."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :S], "off")
    caches, logits = _port_prefill(cfg, params, tokens[:, :S])
    _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_prefill_kernel_branch_matches_jax_and_keeps_the_cache(setup):
    jcfg, jparams, cfg, params, tokens = setup
    _, jlogits_on = _jax_prefill(jcfg, jparams, tokens[:, :S], "on")
    jcaches_off, _ = _jax_prefill(jcfg, jparams, tokens[:, :S], "off")
    caches, logits = _port_prefill(cfg.replace(use_pallas="on"), params, tokens[:, :S])
    _close(logits, jlogits_on)
    _close_caches(caches, jcaches_off)


def test_kernel_branch_at_a_ragged_length_matches_jax(setup, monkeypatch):
    """At a length that is no multiple of 64 the reference takes its plain
    path; the port still goes through the kernel's wrapper (on the CPU, its
    plain version) once per layer, and agrees with the reference."""
    jcfg, jparams, cfg, params, tokens = setup
    ragged = 40
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :ragged], "on")
    calls = []
    monkeypatch.setattr(T, "flash_attention", lambda *a: calls.append(1) or ops.flash_attention(*a))
    caches, logits = _port_prefill(cfg.replace(use_pallas="on"), params, tokens[:, :ragged])
    assert len(calls) == cfg.n_layers
    _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_reference_kernel_branch_drops_the_prefill_cache(setup):
    """The reference fault the port does not copy (ROADMAP.md §C): with the
    kernel on, the JAX prefill returns no KV cache."""
    jcfg, jparams, _, _, tokens = setup
    jcaches_on, _ = _jax_prefill(jcfg, jparams, tokens[:, :S], "on")
    assert jcaches_on is None


def test_decode_steps_match_jax(setup):
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :S], "off")
    caches, _ = _port_prefill(cfg, params, tokens[:, :S])
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(4):
        tok = tokens[:, S + i : S + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, caches = step(params, caches, torch.from_numpy(tok), S + i)
        _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_sliding_window_ring_cache_matches_jax(setup):
    """A window shorter than the prompt: prefill places the tail in a ring
    (token s at slot s % L) and decode wraps around it."""
    jcfg, jparams, cfg, params, tokens = setup
    window = 16
    jcfg_w, cfg_w = jcfg.replace(sliding_window=window), cfg.replace(sliding_window=window)
    jcaches, jlogits = _jax_prefill(jcfg_w, jparams, tokens[:, :S], "off")
    caches, logits = _port_prefill(cfg_w, params, tokens[:, :S])
    assert caches["p0"]["k"].shape[2] == window
    _close(logits, jlogits)
    _close_caches(caches, jcaches)
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg_w, None, p, c, t, pos))
    for i in range(2):
        tok = tokens[:, S + i : S + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, caches = make_decode_step(cfg_w)(params, caches, torch.from_numpy(tok), S + i)
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
    (the port on its own init; as tests/test_archs.py:81-110, in fp32)."""
    cfg = configs.get_smoke(ARCH).replace(use_pallas=use_pallas)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    n_decode, prompt = 4, 64
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
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "64", "--gen", "4",
                      "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite
    assert len(res.decode_ms) == 3 and res.prefill_ms > 0 and res.peak_memory_bytes is None
    assert res.prefills == 2  # the warm-up and the timed one
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < configs.get_smoke(ARCH).vocab_size


def test_serve_run_enters_the_window_around_the_timed_work():
    entered = []

    @contextlib.contextmanager
    def window(name):
        entered.append(name)
        yield

    res = serve.run(ARCH, batch=1, prompt_len=8, gen=3, device="cpu", dtype="float32", window=window)
    assert entered == ["prefill", "decode"] and len(res.decode_ms) == 2


def test_serve_defaults_to_cuda_and_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "64", "--gen", "4"])
