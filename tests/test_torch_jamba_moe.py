"""jamba-1.5-large with its experts, the port against the JAX package, on
the CPU in fp32: the smoke model (one 8-layer repeat, 7 Mamba layers and
attention at position 3, the expert FFN, 4 experts top-2, on positions 1,
3, 5 and 7: three beside Mamba, one beside attention) and the full config's
parameter tree. Inputs are made from a seed with numpy; model weights are
initialised by JAX and converted leaf by leaf. tests/test_torch_mamba.py
holds the model without experts, the card's other cut.

Tolerances are those of tests/test_torch_moe.py: logits, aux loss, Mamba
states, conv tails and KV caches 1e-4 (eight layers of fp32 arithmetic in
another order); greedy tokens exactly.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
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
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, tree_paths  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

ARCH = "jamba_1_5_large_398b"
B, S, GEN = 2, 64, 6
CACHE_LEN = S + GEN
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_AT = [1, 3, 5, 7]
ATTN_AT = 3


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S + GEN)).astype(np.int32)
    return jcfg, jparams, configs.get_smoke(ARCH), params, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _close_caches(got, want, want_kv=None):
    """Every Mamba position's h [1, B, Di, St] fp32 and conv tail [1, B, K-1,
    Di]; the attention position's k/v against ``want_kv`` (the reference's
    kernel branch returns none, ROADMAP.md §C1)."""
    assert set(got) == set(want) == {f"p{i}" for i in range(8)}
    for i in range(8):
        key = f"p{i}"
        ref_caches = (want_kv or want) if i == ATTN_AT else want
        names = ("k", "v") if i == ATTN_AT else ("h", "conv")
        assert set(got[key]) == set(names) == set(ref_caches[key]), key
        for name in names:
            assert tuple(got[key][name].shape) == ref_caches[key][name].shape, (key, name)
            _close(got[key][name], ref_caches[key][name])


def _jax_prefill(jcfg, jparams, tokens, use_pallas="off"):
    cfg = jcfg.replace(use_pallas=use_pallas)
    return jax.jit(lambda p, b: JT.prefill(cfg, None, p, b, cache_len=CACHE_LEN))(
        jparams, {"tokens": jnp.asarray(tokens)})


def _port_prefill(cfg, params, tokens):
    return make_prefill_step(cfg, CACHE_LEN)(params, {"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("get", ["get", "get_smoke"])
def test_param_defs_match_jax(get):
    """Full and smoke configs: the same /-paths, shapes and init kinds in the
    same order; the MoE leaves on positions 1, 3, 5 and 7, the dense SwiGLU
    on the others."""
    jdefs = JT.param_defs(getattr(jconfigs, get)(ARCH))
    tdefs = T.param_defs(getattr(configs, get)(ARCH))
    want, got = dict(jax_tree_paths(jdefs)), dict(tree_paths(tdefs))
    assert list(got) == list(want)
    for path, d in got.items():
        assert (d.shape, d.init, d.scale) == (want[path].shape, want[path].init, want[path].scale), path
    blocks = tdefs["blocks"]
    assert [i for i in range(8) if "moe" in blocks[f"p{i}"]] == MOE_AT
    assert [i for i in range(8) if "attn" in blocks[f"p{i}"]] == [ATTN_AT]
    assert all(list(blocks[f"p{i}"]["moe"]) == ["router", "e_w1", "e_w3", "e_w2"] for i in MOE_AT)
    if get == "get":  # the card's cut: one repeat, 8 of 16 experts
        cut = configs.get(ARCH)
        cut = cut.replace(n_layers=8, moe=MoEConfig(n_experts=8, top_k=2, every_k_layers=2))
        n = sum(int(np.prod(d.shape)) for _, d in tree_paths(T.param_defs(cut)))
        assert cut.param_counts()["total"] == 26_025_984_000 and n == 26_028_171_264  # with the norms and biases


@pytest.mark.parametrize("use_pallas,capacity_factor", [
    ("off", None),
    ("on", None),  # the reference's Pallas kernels (interpret mode): flash and the Mamba scan
    ("off", 0.5),  # capacity int(0.5 * 64 * 2 / 4) = 16 slots: choices drop beside Mamba and attention
])
def test_forward_train_logits_and_aux_match_jax(setup, use_pallas, capacity_factor):
    """Logits and the aux loss summed over the four MoE layers."""
    jcfg, jparams, cfg, params, tokens = setup
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=JMoEConfig(n_experts=4, every_k_layers=2, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=MoEConfig(n_experts=4, every_k_layers=2, capacity_factor=capacity_factor))
    jlogits, jaux = jax.jit(lambda p, b: JT.forward_train(jcfg.replace(use_pallas=use_pallas), None, p, b))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    with torch.inference_mode():
        logits, aux = T.forward_train(cfg.replace(use_pallas=use_pallas), params,
                                      {"tokens": torch.from_numpy(tokens[:, :S])})
    assert logits.shape == (B, S, cfg.padded_vocab) and aux.dtype == torch.float32 and float(aux) > 0
    _close(logits, jlogits)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_prefill_states_and_caches_match_jax(setup, monkeypatch, use_pallas):
    """Every Mamba layer's state and conv tail and the attention layer's
    k/v after prefill. 'on' holds the port's kernel branches (their plain
    versions here; each wrapper once per layer of its kind) against the
    reference's Pallas kernels; k/v against JAX 'off'."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, jlogits = _jax_prefill(jcfg, jparams, tokens[:, :S], use_pallas)
    joff = jcaches if use_pallas == "off" else _jax_prefill(jcfg, jparams, tokens[:, :S])[0]
    calls = []
    monkeypatch.setattr(T, "mamba_scan", lambda *a: calls.append("mamba") or ops.mamba_scan(*a))
    monkeypatch.setattr(T, "flash_attention", lambda *a: calls.append("flash") or ops.flash_attention(*a))
    caches, logits = _port_prefill(cfg.replace(use_pallas=use_pallas), params, tokens[:, :S])
    want_calls = {"off": [], "on": ["mamba"] * 3 + ["flash"] + ["mamba"] * 4}[use_pallas]
    assert calls == want_calls
    _close(logits, jlogits)
    _close_caches(caches, jcaches, joff)
    assert caches["p1"]["h"].dtype == torch.float32


def test_decode_steps_and_greedy_tokens_match_jax(setup):
    """Three decode steps: the port updates the stacked states, conv tails
    and KV cache in place, JAX returns new ones; both carry the same values.
    Then the greedy tokens."""
    jcfg, jparams, cfg, params, tokens = setup
    jcaches, _ = _jax_prefill(jcfg, jparams, tokens[:, :S])
    caches, _ = _port_prefill(cfg, params, tokens[:, :S])
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(3):
        tok = tokens[:, S + i : S + i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, new = step(params, caches, torch.from_numpy(tok), S + i)
        assert new is caches
        _close(logits, jlogits)
        _close_caches(caches, jcaches)
    want = jax_greedy_decode(jcfg, None, jparams, {"tokens": jnp.asarray(tokens[:, :S])}, GEN, CACHE_LEN)
    got = greedy_decode(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])}, GEN, CACHE_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_decode_matches_forward(use_pallas):
    """prefill(0..t-1) + decode_step(t) reproduces the forward logits at t
    (the port on its own init; tests/test_archs.py:80-119)."""
    cfg = configs.get_smoke(ARCH).replace(use_pallas=use_pallas)
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


def test_serve_main_runs_on_cpu_with_the_cuts():
    """The card's cuts at smoke width: one repeat, half the experts."""
    res = serve.main(["--arch", ARCH, "--n-layers", "8", "--n-experts", "2", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4", "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite and res.prefills == 2
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < configs.get_smoke(ARCH).vocab_size


def test_n_experts_cuts_the_experts_and_refuses_a_model_without_moe():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--full", action="store_true")
    serve.add_override_args(ap)
    over = serve.overrides_from_args(ap.parse_args(["--arch", ARCH, "--full", "--n-experts", "8"]))
    assert over == {"moe": MoEConfig(n_experts=8, top_k=2, every_k_layers=2)}
    with pytest.raises(ValueError, match="no MoE layers"):
        serve.overrides_from_args(ap.parse_args(["--arch", "qwen3_0_6b", "--n-experts", "8"]))
    with pytest.raises(SystemExit):
        ap.parse_args(["--arch", ARCH, "--n-experts", "8", "--no-moe"])


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
