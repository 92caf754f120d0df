"""arctic-480b's dense-residual MoE, the port against the JAX package, on the
CPU in fp32: the smoke model (2 layers, 4 experts top-2 beside a dense
SwiGLU on every layer) and the full config's parameter tree. Inputs are made
from a seed with numpy; model weights are initialised by JAX and converted
leaf by leaf.

Tolerances are those of tests/test_torch_moe.py: logits, aux loss and
caches 1e-4 (two layers of fp32 arithmetic in another order); the FFN
sub-layer 1e-5; expert indices and dropped choices exactly; greedy tokens
exactly. A token whose every choice the capacity queue drops gets the dense
SwiGLU alone, bit for bit, in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.models.layers import swiglu as jax_swiglu  # noqa: E402
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
from repro_torch.models.layers import rmsnorm, swiglu  # noqa: E402
from repro_torch.models.params import init_params, tree_paths  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "arctic_480b"
B, S, GEN = 2, 40, 6
CACHE_LEN = S + GEN
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
DROPPING = 0.5  # capacity int(0.5 * 40 * 2 / 4) = 10 slots for 80 choices over 4 experts


def _dropping(cfg, moe_config):
    return cfg.replace(moe=moe_config(n_experts=4, top_k=2, dense_residual=True, capacity_factor=DROPPING))


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, 64 + GEN)).astype(np.int32)
    return jcfg, jparams, configs.get_smoke(ARCH), params, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _close_caches(got, want):
    assert set(got) == set(want) == {"p0"} and set(got["p0"]) == set(want["p0"]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got["p0"][name].shape) == want["p0"][name].shape
        _close(got["p0"][name], want["p0"][name])


def _jax_prefill(jcfg, jparams, tokens, cache_len):
    return jax.jit(lambda p, b: JT.prefill(jcfg, None, p, b, cache_len=cache_len))(
        jparams, {"tokens": jnp.asarray(tokens)})


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_param_defs_match_jax(get):
    """Full and smoke configs: the same /-paths, shapes and init kinds in the
    same order, the dense SwiGLU under ``moe/dense`` after the router and
    the three expert leaves, so checkpoints cross unchanged."""
    jdefs = JT.param_defs(getattr(jconfigs, get)(ARCH))
    tdefs = T.param_defs(getattr(configs, get)(ARCH))
    want, got = dict(jax_tree_paths(jdefs)), dict(tree_paths(tdefs))
    assert list(got) == list(want)
    for path, d in got.items():
        assert (d.shape, d.init, d.scale) == (want[path].shape, want[path].init, want[path].scale), path
    pm = tdefs["blocks"]["p0"]["moe"]
    assert list(pm) == list(jdefs["blocks"]["p0"]["moe"]) == ["router", "e_w1", "e_w3", "e_w2", "dense"]
    assert list(pm["dense"]) == ["w1", "w3", "w2"]
    if get == "get":  # the card's cut, 1 of 35 layers: 14,069,938,176 parameters
        one = configs.get(ARCH).replace(n_layers=1)
        n = sum(int(np.prod(d.shape)) for _, d in tree_paths(T.param_defs(one)))
        assert n - one.d_model == one.param_counts()["total"] == 14_069_938_176  # less the final norm


@pytest.mark.parametrize("capacity_factor", [None, DROPPING])
def test_ffn_sub_layer_matches_jax_and_dropped_tokens_get_the_dense_swiglu(setup, capacity_factor):
    """The layer's feed-forward sub-layer on one input, the port against the
    reference's ``_ffn_or_moe``: the same expert indices and output. Where
    the capacity queue drops both of a token's choices, its output is the
    dense SwiGLU alone, bit for bit."""
    jcfg, jparams, cfg, params, _ = setup
    if capacity_factor is not None:
        jcfg, cfg = _dropping(jcfg, JMoEConfig), _dropping(cfg, MoEConfig)
    x = np.random.default_rng(4).normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["p0"])  # the second layer
    p = T._at(params["blocks"]["p0"], 1)
    kind = cfg.pattern[0]
    jout, jaux = JT._ffn_or_moe(jcfg, None, kind, jp, jnp.asarray(x), None)
    out, aux = T._ffn_or_moe(cfg, kind, p, torch.from_numpy(x))
    _close(out, jout, LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **LAYER_TOL)

    h = rmsnorm(torch.from_numpy(x), p["ln2"], cfg.norm_eps)
    _, idx, _ = moe.router_topk(h, p["moe"]["router"], cfg.moe)
    capacity = max(1, int(cfg.moe.capacity_factor * S * 2 / 4))
    mask = torch.nn.functional.one_hot(idx, 4).float().reshape(B, S * 2, 4)
    pos = (torch.cumsum(mask, dim=1) * mask - 1.0).amax(-1).reshape(B, S, 2)
    dropped = ~(pos < capacity).any(-1)  # both of the token's choices past their queues
    assert bool(dropped.any()) == (capacity_factor is not None)
    d = p["moe"]["dense"]
    dense = swiglu(h, d["w1"], d["w3"], d["w2"])
    assert torch.equal(out[dropped], dense[dropped])
    assert bool((out[~dropped] != dense[~dropped]).any(-1).all())
    jh = jax_rmsnorm(jnp.asarray(x), jp["ln2"], jcfg.norm_eps)
    jd = jp["moe"]["dense"]
    jdense = np.asarray(jax_swiglu(jh, jd["w1"], jd["w3"], jd["w2"]))
    np.testing.assert_array_equal(np.asarray(jout)[dropped.numpy()], jdense[dropped.numpy()])


@pytest.mark.parametrize("seq,use_pallas,capacity_factor", [
    (40, "off", None),
    (64, "on", None),  # the reference's Pallas kernel (interpret mode)
    (40, "off", DROPPING),  # capacity binds: choices drop inside the model
])
def test_forward_train_logits_and_aux_match_jax(setup, seq, use_pallas, capacity_factor):
    jcfg, jparams, cfg, params, tokens = setup
    if capacity_factor is not None:
        jcfg, cfg = _dropping(jcfg, JMoEConfig), _dropping(cfg, MoEConfig)
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
    the cache (ROADMAP.md §C1)."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, tokens[:, :S], CACHE_LEN)
    caches, logits = make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    _close(logits, jlogits)
    _close_caches(caches, jcaches)
    assert caches["p0"]["k"].shape[2] == CACHE_LEN


def test_decode_steps_and_greedy_tokens_match_jax(setup):
    """Three decode steps' logits and caches (at s=1 each expert holds one
    slot a row, so every token keeps both choices), then the greedy tokens."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :S], CACHE_LEN)
    caches, _ = make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(3):
        tok = tokens[:, S + i : S + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, caches = step(params, caches, torch.from_numpy(tok), S + i)
        _close(logits, jlogits)
    _close_caches(caches, jcaches)
    want = jax_greedy_decode(jcfg, None, jparams, {"tokens": jnp.asarray(tokens[:, :S])}, GEN, CACHE_LEN)
    got = greedy_decode(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])}, GEN, CACHE_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_branch_launches_per_layer_and_matches_jax(setup, monkeypatch):
    """With the kernel on, the port goes through the flash wrapper once per
    layer (on the CPU its plain version), and agrees with the reference's
    plain path."""
    jcfg, jparams, cfg, params, tokens = setup
    calls = []
    monkeypatch.setattr(T, "flash_attention", lambda *a: calls.append(a[3:]) or ops.flash_attention(*a))
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, tokens[:, :S], CACHE_LEN)
    caches, logits = make_prefill_step(cfg.replace(use_pallas="on"), CACHE_LEN)(
        params, {"tokens": torch.from_numpy(tokens[:, :S])})
    assert calls == [(True, None)] * cfg.n_layers
    _close(logits, jlogits)
    _close_caches(caches, jcaches)


def test_decode_matches_forward():
    """prefill(0..t-1) + decode_step(t) reproduces the forward logits at t
    (the port on its own init; tests/test_archs.py:80-119)."""
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


def test_serve_main_runs_on_cpu_with_the_cut():
    """The card's cut, one layer (``--n-layers 1``), at smoke width."""
    res = serve.main(["--arch", ARCH, "--n-layers", "1", "--batch", "2", "--prompt-len", "24", "--gen", "4",
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
