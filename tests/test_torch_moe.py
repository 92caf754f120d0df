"""The MoE feed-forward layer and the mixtral-8x22b smoke model, the port
against the JAX package, on the CPU in fp32. Inputs are made from a seed
with numpy; model weights are initialised by JAX and converted leaf by leaf.

Tolerances: ``router_topk`` and ``moe_ffn`` 1e-5 (the same fp32 arithmetic
in another summation order on O(1) values), expert indices and dropped
choices exactly; model logits, aux loss and caches 1e-4 (two layers of fp32
arithmetic); greedy tokens exactly. Routing is discrete, so every case
first holds the expert indices equal: an index that differs changes a
token's output wholly, not by a rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import tree_paths as jax_tree_paths  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.steps import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, path_seed, tree_paths  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "mixtral_8x22b"
B, S, GEN = 2, 40, 6  # S is 5 windows of the smoke config's 8 tokens
CACHE_LEN = S + GEN
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- the layer
def _layer_inputs(seed, b=2, s=16, d=32, f=48, e=4, zero_router=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    router = np.zeros((d, e), np.float32) if zero_router else rng.normal(0, d**-0.5, (d, e)).astype(np.float32)
    w1, w3 = (rng.normal(0, d**-0.5, (e, d, f)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(0, f**-0.5, (e, f, d)).astype(np.float32)
    return x, router, w1, w3, w2


def _kept(idx, e, capacity):
    """Which (token, slot) choices fit their expert's queue: the reference's
    own lines (``repro/models/moe.py:56-60``) on the given indices."""
    b, s, k = idx.shape
    mask = jax.nn.one_hot(jnp.asarray(idx), e, dtype=jnp.float32).reshape(b, s * k, e)
    pos = jnp.cumsum(mask, axis=1) * mask - 1.0
    return np.asarray(((pos < capacity) & (pos >= 0)).any(-1)).reshape(b, s, k)


@pytest.mark.parametrize("case,capacity_factor,zero_router", [
    ("free", 8.0, False),  # capacity above any queue: nothing drops
    ("dropping", 0.5, False),  # capacity int(0.5 * 16 * 2 / 4) = 4 slots: choices drop
    ("ties", 1.25, True),  # every probability equal: experts 0 and 1, queues overflow
])
def test_router_topk_and_moe_ffn_match_jax(case, capacity_factor, zero_router):
    x, router, w1, w3, w2 = _layer_inputs(1, zero_router=zero_router)
    jcfg = JMoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor)
    cfg = MoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor)
    jgates, jidx, jaux = jmoe.router_topk(jnp.asarray(x), jnp.asarray(router), jcfg)
    gates, idx, aux = moe.router_topk(torch.from_numpy(x), torch.from_numpy(router), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if zero_router:
        assert (idx.numpy() == [0, 1]).all()
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **LAYER_TOL)

    jout, jaux2 = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, router, w1, w3, w2)), jcfg)
    out, aux2 = moe.moe_ffn(*(torch.from_numpy(a) for a in (x, router, w1, w3, w2)), cfg)
    assert out.dtype == torch.float32 and aux2.dtype == torch.float32 and aux2.shape == ()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LAYER_TOL)
    np.testing.assert_allclose(aux2.item(), float(jaux2), **LAYER_TOL)
    # a token whose every choice dropped gets exactly zero, in both packages
    kept = _kept(idx.numpy(), 4, max(1, int(capacity_factor * 16 * 2 / 4)))
    assert kept.all() == (case == "free")
    none_kept = ~kept.any(-1)
    np.testing.assert_array_equal((out.numpy() == 0).all(-1), none_kept)
    np.testing.assert_array_equal((np.asarray(jout) == 0).all(-1), none_kept)


def test_moe_ffn_keeps_the_dtypes_of_the_reference():
    """bf16 x: dispatch and combine in bf16, the router and aux in fp32."""
    x, router, w1, w3, w2 = (torch.from_numpy(a).to(torch.bfloat16) for a in _layer_inputs(2))
    cfg = MoEConfig(n_experts=4, top_k=2)
    gates, idx, aux = moe.router_topk(x, router, cfg)
    out, aux2 = moe.moe_ffn(x, router, w1, w3, w2, cfg)
    assert (gates.dtype, aux.dtype, out.dtype, aux2.dtype) == (torch.float32,) * 2 + (torch.bfloat16, torch.float32)
    jcfg = JMoEConfig(n_experts=4, top_k=2)
    jout, _ = jmoe.moe_ffn(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, router, w1, w3, w2)), jcfg)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), rtol=2e-2, atol=2e-2)


def test_in_place_init_draws_the_bits_of_the_scaled_copy():
    """``init_params`` scales each normal leaf in place; the values are those
    of ``(x * scale).to(dtype)``, for every leaf of the mixtral smoke tree."""
    defs = T.param_defs(configs.get_smoke(ARCH))
    for dtype in (torch.float32, torch.bfloat16):
        params = init_params(defs, seed=3, dtype=dtype, device="cpu")
        for path, d in tree_paths(defs):
            got = params
            for key in path.strip("/").split("/"):
                got = got[key]
            if d.init != "normal":
                continue
            gen = torch.Generator().manual_seed(path_seed(3, path))
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32)
            scale = d.scale if d.scale is not None else (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]) ** -0.5
            assert torch.equal(got, (x * scale).to(dtype)), path


# --------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, 64 + GEN)).astype(np.int32)
    return jcfg, jparams, configs.get_smoke(ARCH), params, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _close_caches(got, want, window):
    assert set(got) == set(want) == {"p0"} and set(got["p0"]) == set(want["p0"]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got["p0"][name].shape) == want["p0"][name].shape
        assert got["p0"][name].shape[2] <= window  # [n_rep, B, L, KV, Dh]: the ring's slots
        _close(got["p0"][name], want["p0"][name])


def _jax_prefill(jcfg, jparams, tokens, cache_len):
    return jax.jit(lambda p, b: JT.prefill(jcfg, None, p, b, cache_len=cache_len))(
        jparams, {"tokens": jnp.asarray(tokens)})


def test_param_defs_match_jax():
    """Same /-paths, shapes and init kinds in the same nesting order, with
    the reference's MoE leaf names, so checkpoints cross unchanged."""
    jdefs = JT.param_defs(jconfigs.get_smoke(ARCH))
    tdefs = T.param_defs(configs.get_smoke(ARCH))
    want, got = dict(jax_tree_paths(jdefs)), dict(tree_paths(tdefs))
    assert list(got) == list(want)
    for path, d in got.items():
        assert (d.shape, d.init, d.scale) == (want[path].shape, want[path].init, want[path].scale), path
    assert list(tdefs["blocks"]["p0"]) == list(jdefs["blocks"]["p0"]) == ["ln1", "attn", "ln2", "moe"]
    assert list(tdefs["blocks"]["p0"]["moe"]) == ["router", "e_w1", "e_w3", "e_w2"]


@pytest.mark.parametrize("seq,use_pallas,capacity_factor", [
    (40, "off", None),
    (64, "on", None),  # the reference's Pallas kernel (interpret mode) with the window
    (40, "off", 0.5),  # capacity binds: choices drop inside the model
])
def test_forward_train_logits_and_aux_match_jax(setup, seq, use_pallas, capacity_factor):
    jcfg, jparams, cfg, params, tokens = setup
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=JMoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=capacity_factor))
    batch = tokens[:, :seq]
    jlogits, jaux = jax.jit(lambda p, b: JT.forward_train(jcfg.replace(use_pallas=use_pallas), None, p, b))(
        jparams, {"tokens": jnp.asarray(batch)})
    with torch.inference_mode():
        logits, aux = T.forward_train(cfg.replace(use_pallas=use_pallas), params, {"tokens": torch.from_numpy(batch)})
    assert logits.shape == (B, seq, cfg.padded_vocab) and aux.dtype == torch.float32 and float(aux) > 0
    _close(logits, jlogits)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


def test_prefill_caches_and_logits_match_jax(setup):
    """use_pallas 'off' on both sides: the reference's kernel branch drops
    the cache (ROADMAP.md §C1). The prompt is 5 windows long, so the cache
    is a ring of 8 slots holding the last 8 tokens."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, tokens[:, :S], CACHE_LEN)
    caches, logits = make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg.sliding_window)
    assert caches["p0"]["k"].shape[2] == cfg.sliding_window


@pytest.mark.parametrize("prompt", [5, S])
def test_decode_steps_and_greedy_tokens_match_jax(setup, prompt):
    """A prompt shorter than the window fills the ring in decode and wraps
    (5 + 6 > 8); a prompt longer than it wraps in prefill and again in
    decode. Three decode steps' logits and caches, then the greedy tokens."""
    jcfg, jparams, cfg, params, tokens = setup
    cache_len = prompt + GEN
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :prompt], cache_len)
    caches, _ = make_prefill_step(cfg, cache_len)(params, {"tokens": torch.from_numpy(tokens[:, :prompt])})
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(3):
        tok = tokens[:, prompt + i : prompt + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(prompt + i, jnp.int32))
        logits, caches = step(params, caches, torch.from_numpy(tok), prompt + i)
        _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg.sliding_window)
    jbatch = {"tokens": jnp.asarray(tokens[:, :prompt])}
    want = jax_greedy_decode(jcfg, None, jparams, jbatch, GEN, cache_len)
    got = greedy_decode(cfg, params, {"tokens": torch.from_numpy(tokens[:, :prompt])}, GEN, cache_len)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_cache_holds_token_s_at_slot_s_mod_window(setup):
    """After a prompt of 20 tokens and 5 decode steps, the 8-slot ring holds
    tokens 17..24, token s at slot s % 8, as the reference's does, and each
    step's logits are the reference's."""
    jcfg, jparams, cfg, params, tokens = setup
    prompt, n_dec = 20, 5
    cache_len = prompt + GEN
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :prompt], cache_len)
    caches, _ = make_prefill_step(cfg, cache_len)(params, {"tokens": torch.from_numpy(tokens[:, :prompt])})
    _close_caches(caches, jcaches, cfg.sliding_window)
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    for i in range(n_dec):
        tok = tokens[:, prompt + i : prompt + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(prompt + i, jnp.int32))
        logits, caches = make_decode_step(cfg)(params, caches, torch.from_numpy(tok), prompt + i)
        _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg.sliding_window)
    # the first layer's keys of the last 8 tokens, from a prefill of all of them
    total = prompt + n_dec
    full, _ = make_prefill_step(cfg, total)(params, {"tokens": torch.from_numpy(tokens[:, :total])})
    window = cfg.sliding_window
    for s in range(total - window, total):
        _close(caches["p0"]["k"][0, :, s % window], full["p0"]["k"][0, :, s % window])


def test_kernel_branch_launches_per_layer_and_matches_jax(setup, monkeypatch):
    """With the kernel on, the port goes through the flash wrapper once per
    layer with the window (on the CPU its plain version), and agrees with
    the reference's plain path."""
    jcfg, jparams, cfg, params, tokens = setup
    calls = []
    monkeypatch.setattr(T, "flash_attention", lambda *a: calls.append(a[3:]) or ops.flash_attention(*a))
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, tokens[:, :S], CACHE_LEN)
    caches, logits = make_prefill_step(cfg.replace(use_pallas="on"), CACHE_LEN)(
        params, {"tokens": torch.from_numpy(tokens[:, :S])})
    assert calls == [(True, cfg.sliding_window)] * cfg.n_layers
    _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg.sliding_window)


def test_sliding_window_limits_attention():
    """tests/test_archs.py:136 on the port: with a window of 8 over 2
    layers, token 0 reaches positions 0..14 and no later one (the smoke
    capacity factor of 8 drops nothing, so no queue couples tokens).

    The reference's test holds the last logits bit for bit. Here a changed
    token 0 may take other experts, which moves every later token of those
    experts by one capacity slot; the dense combine einsum then adds its two
    weighted expert outputs in other vector lanes of the BLAS reduction, a
    few fp32 roundings apart. So positions past the window's reach are held
    at 1e-6 (logits are O(0.1)), and those within it must move by 1e-2."""
    cfg = configs.get_smoke(ARCH)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 32))
    t2 = toks.copy()
    t2[0, 0] = (t2[0, 0] + 7) % cfg.vocab_size
    with torch.inference_mode():
        l1, _ = T.forward_train(cfg, params, {"tokens": torch.from_numpy(toks)})
        l2, _ = T.forward_train(cfg, params, {"tokens": torch.from_numpy(t2)})
    moved = (l1[0] - l2[0]).abs().amax(-1)
    reach = cfg.n_layers * (cfg.sliding_window - 1) + 1  # positions 0..14
    assert bool((moved[reach:] <= 1e-6).all()), moved
    assert bool((moved[:reach] > 1e-2).all()), moved


def test_decode_matches_forward():
    """prefill(0..t-1) + decode_step(t) reproduces the forward logits at t
    through the ring (the port on its own init; tests/test_archs.py:80-119)."""
    cfg = configs.get_smoke(ARCH)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    total, n_decode = 32, 4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, total)))
    with torch.inference_mode():
        full, _ = T.forward_train(cfg, params, {"tokens": tokens})
    prompt = total - n_decode
    caches, logits = make_prefill_step(cfg, total)(params, {"tokens": tokens[:, :prompt]})
    np.testing.assert_allclose(logits.numpy(), full[:, prompt - 1].numpy(), **TOL)
    for i in range(n_decode - 1):
        logits, caches = make_decode_step(cfg)(params, caches, tokens[:, prompt + i : prompt + i + 1], prompt + i)
        np.testing.assert_allclose(logits.numpy(), full[:, prompt + i].numpy(), **TOL)


def test_serve_main_runs_on_cpu():
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "24", "--gen", "4",
                      "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite and res.prefills == 2
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < configs.get_smoke(ARCH).vocab_size


def test_serve_from_a_jax_checkpoint_gives_jax_greedy_tokens(tmp_path):
    batch, prompt_len, gen = 2, 16, 4
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    JCheckpointManager(JRepository.init(str(tmp_path))).save(5, jparams, {})
    prompts = serve.prompt_batch(configs.get_smoke(ARCH), batch, prompt_len, seed=0, device="cpu")
    want = jax_greedy_decode(jcfg, None, jparams, {"tokens": jnp.asarray(prompts["tokens"].numpy())},
                             gen, prompt_len + gen)
    res = serve.run(ARCH, batch=batch, prompt_len=prompt_len, gen=gen, device="cpu", dtype="float32",
                    repo=str(tmp_path))
    assert res.checkpoint_step == 5
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))
