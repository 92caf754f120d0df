"""jamba-1.5-large smoke without experts, the port against the JAX package:
the Mamba functions of ``models/ssm.py``, the selective-scan kernel's plain
version against the Pallas kernel (interpret mode) and the JAX reference,
the ``mamba_a`` init, and the hybrid model's prefill, decode, greedy tokens
and forward, in fp32 on weights initialised by JAX and converted leaf by
leaf. The smoke config runs here without experts at 16 layers: two repeats
of the 8-layer pattern, attention at position 3 (the card's serving cut;
tests/test_torch_jamba_moe.py holds jamba with its experts).

Tolerances: 1e-5 for the Mamba functions (the same fp32 arithmetic in
another order); tests/test_kernels.py's for the kernel's plain version
(y fp32 2e-5, bf16 2e-2; h 1e-3); 1e-4 for logits, states, conv tails and
caches through 16 layers. Greedy tokens must be equal exactly.
"""
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
from repro_torch.kernels.mamba import mamba_scan_fwd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "jamba_1_5_large_398b"
CUTS = dict(moe=None, n_layers=16)
B, S, GEN = 2, 64, 8
CACHE_LEN = S + GEN
RAGGED = 40
TOL = dict(rtol=1e-4, atol=1e-4)
SSM_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py:24 (y) and :144-145 (h)
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_SHAPES = [(2, 64, 64, 8), (1, 128, 256, 16)]  # tests/test_kernels.py:130 (b, s, di, st)


def _np(t):
    return t.float().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _pair(arr, dtype="float32"):
    """The same values as a JAX array and a CPU tensor (bf16 bit for bit)."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    return j, tensor_from_numpy(np.asarray(j), torch.device("cpu"))


def _scan_inputs(shape, seed, dtype="float32"):
    """tests/test_kernels.py:133-139's inputs: u, B, C ~ N(0, 1) and
    dt = 0.1 |N(0, 1)| in the dtype, A = -|N(0, 1)| fp32, h0 ~ N(0, 0.3) fp32."""
    b, s, di, st = shape
    rng = np.random.default_rng(seed)
    u = _pair(rng.normal(0, 1, (b, s, di)), dtype)
    dt = _pair(np.abs(rng.normal(0, 1, (b, s, di))) * 0.1, dtype)
    A = _pair(-np.abs(rng.normal(0, 1, (di, st))))
    B_ = _pair(rng.normal(0, 1, (b, s, st)), dtype)
    C_ = _pair(rng.normal(0, 1, (b, s, st)), dtype)
    h0 = _pair(rng.normal(0, 0.3, (b, di, st)))
    return u, dt, A, B_, C_, h0


# ------------------------------------------------------------ models/ssm.py
@pytest.mark.parametrize("with_tail", [False, True])
def test_mamba_conv_matches_jax(with_tail):
    rng = np.random.default_rng(5)
    (jx, x), (jw, w), (jb, b) = (_pair(rng.normal(0, 1, s)) for s in ((2, 9, 24), (24, 4), (24,)))
    jt, t = _pair(rng.normal(0, 1, (2, 3, 24)))
    _close(ssm.mamba_conv(x, w, b, t if with_tail else None),
           jssm.mamba_conv(jx, jw, jb, jt if with_tail else None), SSM_TOL)


@pytest.mark.parametrize("fn,s", [("mamba_scan_naive", 48), ("mamba_scan_chunked", 512),
                                  ("mamba_scan_chunked", 48)])
@pytest.mark.parametrize("with_state", [False, True])
def test_scan_functions_match_jax(fn, s, with_state):
    """S=512 runs the chunked form's two chunks of 256; S=48 takes its
    fallback to the naive scan."""
    (ju, u), (jdt, dt), (jA, A), (jB, B_), (jC, C_), (jh0, h0) = _scan_inputs((2, s, 16, 4), seed=7)
    want_y, want_h = getattr(jssm, fn)(ju, jdt, jA, jB, jC, jh0 if with_state else None)
    got_y, got_h = getattr(ssm, fn)(u, dt, A, B_, C_, h0 if with_state else None)
    assert got_y.dtype == u.dtype and got_h.dtype == torch.float32
    _close(got_y, want_y, SSM_TOL)
    _close(got_h, want_h, SSM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_step_matches_jax(dtype):
    """The decode update returns y in fp32 whatever its inputs' dtype, as the
    reference does (its u_t is rebound to fp32 before the cast)."""
    (ju, u), (jdt, dt), (jA, A), (jB, B_), (jC, C_), (jh0, h0) = _scan_inputs((2, 1, 32, 8), 8, dtype)
    want_y, want_h = jssm.mamba_step(ju[:, 0], jdt[:, 0], jA, jB[:, 0], jC[:, 0], jh0)
    got_y, got_h = ssm.mamba_step(u[:, 0], dt[:, 0], A, B_[:, 0], C_[:, 0], h0)
    assert want_y.dtype == jnp.float32 and got_y.dtype == torch.float32
    assert got_h.dtype == torch.float32
    _close(got_y, want_y, SSM_TOL)
    _close(got_h, want_h, SSM_TOL)


# --------------------------------------------------- the kernel's plain version
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_version_matches_jax_kernel_and_reference(shape, dtype):
    (ju, u), (jdt, dt), (jA, A), (jB, B_), (jC, C_), (jh0, h0) = _scan_inputs(shape, 3, dtype)
    want_kernel = jax_ops.mamba_scan(ju, jdt, jA, jB, jC, jh0, True)
    want_ref = jax_ref.mamba_ref(ju, jdt, jA, jB, jC, jh0)
    for got_y, got_h in (ref.mamba_ref(u, dt, A, B_, C_, h0), ops.mamba_scan(u, dt, A, B_, C_, h0)):
        assert got_y.dtype == u.dtype and tuple(got_y.shape) == shape[:3]
        assert got_h.dtype == torch.float32
        for want_y, want_h in (want_kernel, want_ref):
            _close(got_y, want_y, KERNEL_TOL[dtype])
            _close(got_h, want_h, STATE_TOL)


def test_plain_version_without_a_state_starts_from_zeros():
    (_, u), (_, dt), (_, A), (_, B_), (_, C_), (_, h0) = _scan_inputs((1, 8, 16, 4), 3)
    zeros = torch.zeros_like(h0)
    for got, want in zip(ops.mamba_scan(u, dt, A, B_, C_), ref.mamba_ref(u, dt, A, B_, C_, zeros)):
        assert torch.equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU; only ops.mamba_scan routes
    CPU tensors to the plain version."""
    (_, u), (_, dt), (_, A), (_, B_), (_, C_), (_, h0) = _scan_inputs((1, 8, 16, 4), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        mamba_scan_fwd(u, dt, A, B_, C_, h0)


# ------------------------------------------------------------------ the model
def _cfg(use_pallas="auto"):
    return configs.get_smoke(ARCH).replace(use_pallas=use_pallas, **CUTS)


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH).replace(**CUTS)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, jparams, _cfg(), params, tokens


def test_mamba_a_init_matches_jax(setup):
    """The port's own init of A_log: log(1..St) along the state axis, on every
    channel, equal to the reference's bit for bit."""
    want = np.asarray(setup[1]["blocks"]["p0"]["mamba"]["a_log"])
    got = init_params(T.param_defs(_cfg()), seed=0, dtype=torch.float32,
                      device="cpu")["blocks"]["p0"]["mamba"]["a_log"]
    assert tuple(got.shape) == want.shape == (2, 128, 4) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_prefill(jcfg, jparams, tokens, use_pallas):
    cfg = jcfg.replace(use_pallas=use_pallas)
    return jax.jit(lambda p, b: JT.prefill(cfg, None, p, b, cache_len=CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(tokens)})


def _port_prefill(cfg, params, tokens):
    return make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens)})


def _close_caches(got, want, want_kv=None):
    """Every Mamba position's h [n_rep, B, Di, St] fp32 and conv tail
    [n_rep, B, K-1, Di]; the attention position's k/v against ``want_kv``
    (the reference's kernel branch returns none, ROADMAP.md §C)."""
    assert set(got) == set(want) == {f"p{i}" for i in range(8)}
    for key, kind in zip(sorted(got), configs.get_smoke(ARCH).pattern):
        ref_caches = want if kind.mixer == "mamba" else (want_kv or want)
        names = ("h", "conv") if kind.mixer == "mamba" else ("k", "v")
        assert set(got[key]) == set(names) == set(ref_caches[key]), key
        for name in names:
            assert tuple(got[key][name].shape) == ref_caches[key][name].shape, (key, name)
            _close(got[key][name], ref_caches[key][name])
    assert got["p0"]["h"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_prefill_matches_jax(setup, use_pallas):
    """'on' holds the port's kernel branches (their plain versions on the CPU)
    against the JAX kernel branches (the Pallas kernels in interpret mode);
    k/v against JAX 'off', since JAX 'on' returns no attention cache."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :S], use_pallas)
    joff = jcaches if use_pallas == "off" else _jax_prefill(jcfg, jparams, tokens[:, :S], "off")[0]
    if use_pallas == "on":
        assert jcaches["p3"] == {}  # the reference fault of ROADMAP.md §C
    caches, logits = _port_prefill(cfg.replace(use_pallas=use_pallas), params, tokens[:, :S])
    _close(logits, jlogits)
    _close_caches(caches, jcaches, joff)


@pytest.mark.parametrize("prompt", [RAGGED, 2])
def test_kernel_branch_at_short_and_ragged_lengths_matches_jax(setup, monkeypatch, prompt):
    """At S=40 the reference takes its chunked scan (and that its naive one),
    since its kernel needs S % 64 == 0; at S=2 the conv tail is zero-padded
    in front. The port still goes through the kernel's wrapper once per Mamba
    layer, and agrees with the reference."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :prompt], "on")
    calls = []
    monkeypatch.setattr(T, "mamba_scan", lambda *a: calls.append(1) or ops.mamba_scan(*a))
    caches, logits = _port_prefill(cfg.replace(use_pallas="on"), params, tokens[:, :prompt])
    assert len(calls) == 14
    _close(logits, jlogits)
    _close_caches(caches, jcaches)
    if prompt == 2:
        assert not caches["p0"]["conv"][:, :, 0].any()  # K-1-S = 1 zero row in front


def test_decode_steps_match_jax(setup):
    """Four steps: the port updates the stacked states and conv tails in
    place, JAX returns new ones; both must carry the same values."""
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
    cfg = _cfg(use_pallas)
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


def test_serve_main_runs_on_cpu_with_the_cuts():
    res = serve.main(["--arch", ARCH, "--n-layers", "16", "--no-moe", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4", "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite
    assert len(res.decode_ms) == 3 and res.prefills == 2 and res.peak_memory_bytes is None
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < configs.get_smoke(ARCH).vocab_size


def test_serve_run_in_bfloat16_stays_finite():
    """The bf16 path the card serves: B and C reach the kernel's wrapper in
    the model dtype, the state stays fp32."""
    res = serve.run(ARCH, batch=2, prompt_len=20, gen=3, device="cpu", dtype="bfloat16",
                    overrides=CUTS)
    assert res.logits_finite and res.tokens.shape == (2, 3)
