"""The encoder-decoder (seamless-m4t-large-v2) and M-RoPE vision
(qwen2-vl-7b) paths, the port against the JAX package, on the CPU at the
smoke configs, in fp32 on weights initialised by JAX and converted leaf by
leaf. Inputs are made from a seed with numpy: tokens and the stub
frontends' ``encoder_embeds``, ``vision_embeds`` and ``positions3``.

Tolerances: M-RoPE 1e-6 (the same fp32 angles; the rotated values are
O(1)); logits and caches 1e-4 (the same fp32 arithmetic in another
summation order, through an encoder and a decoder of two layers each);
greedy tokens exactly.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import tree_paths as jax_tree_paths  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.steps import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, tree_paths  # noqa: E402
from repro_torch.train.loop import train_segment  # noqa: E402
from repro_torch.train.steps import greedy_decode, make_decode_step, make_prefill_step  # noqa: E402

SEAMLESS, QWEN2_VL = "seamless_m4t_large_v2", "qwen2_vl_7b"
ARCHS = [SEAMLESS, QWEN2_VL]
B, S, GEN = 2, 64, 6
CACHE_LEN = S + GEN
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(cfg, s, seed=0, distinct_streams=True):
    """Numpy inputs of ``cfg`` at B x ``s``: tokens, and the stub frontends'
    (tests/test_archs.py's ``make_batch``), with three distinct M-RoPE
    position streams unless ``distinct_streams`` is false."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["encoder_embeds"] = rng.normal(0, 0.02, (B, s // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    if cfg.vision_len_ratio:
        out["vision_embeds"] = rng.normal(0, 0.02, (B, s // cfg.vision_len_ratio, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, B, s)).copy()
        if distinct_streams:
            pos += rng.integers(0, 3 * s, (3, B, 1)).astype(np.int32)
        out["positions3"] = pos
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg = jconfigs.get_smoke(arch)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return arch, jcfg, jparams, configs.get_smoke(arch), params


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _close_caches(got, want, cfg):
    names = {"k", "v", "xk", "xv"} if cfg.enc_dec else {"k", "v"}
    assert set(got) == set(want) == {"p0"} and set(got["p0"]) == set(want["p0"]) == names
    for name in names:
        assert tuple(got["p0"][name].shape) == want["p0"][name].shape  # [n_rep, B, L, KV, Dh]
        _close(got["p0"][name], want["p0"][name])


def _jax_prefill(jcfg, jparams, batch):
    return jax.jit(lambda p, b: JT.prefill(jcfg, None, p, b, cache_len=CACHE_LEN))(jparams, _jax(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_jax(arch):
    """Same /-paths, shapes and init kinds in the same nesting order: the
    decoder layers' ``ln_x`` and ``xattn``, the stacked ``enc_blocks`` and
    ``enc_final_norm``."""
    jdefs = JT.param_defs(jconfigs.get_smoke(arch))
    tdefs = T.param_defs(configs.get_smoke(arch))
    want, got = dict(jax_tree_paths(jdefs)), dict(tree_paths(tdefs))
    assert list(got) == list(want)
    for path, d in got.items():
        assert (d.shape, d.init, d.scale) == (want[path].shape, want[path].init, want[path].scale), path
    assert list(tdefs) == list(jdefs) and list(tdefs["blocks"]["p0"]) == list(jdefs["blocks"]["p0"])
    if arch == SEAMLESS:
        assert list(tdefs["enc_blocks"]["p0"]) == list(jdefs["enc_blocks"]["p0"])
        assert "xattn" not in tdefs["enc_blocks"]["p0"]


@pytest.mark.parametrize("sections,dh,theta", [((2, 3, 3), 16, 1e4), ((16, 24, 24), 128, 1e6)])
def test_apply_mrope_matches_jax(sections, dh, theta):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 40, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 40)).astype(np.int32)  # three distinct streams
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, (1,) + sections)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_forward_train_matches_jax(setup, use_pallas):
    """At S=256 the encoder has 64 frames, so with 'on' the reference runs
    its Pallas kernel (interpret mode) in the encoder and the decoder alike;
    the port's kernel wrapper takes its plain version on the CPU."""
    arch, jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, 256)
    jlogits, _ = jax.jit(lambda p, b: JT.forward_train(jcfg.replace(use_pallas=use_pallas), None, p, b))(
        jparams, _jax(batch))
    with torch.inference_mode():
        logits, aux = T.forward_train(cfg.replace(use_pallas=use_pallas), params, _torch(batch))
    assert logits.shape == (B, 256, cfg.padded_vocab) and float(aux) == 0.0
    _close(logits, jlogits)


def test_prefill_caches_and_logits_match_jax(setup):
    """With use_pallas 'off' on both sides: the reference's kernel branch
    drops the self-attention cache (ROADMAP.md §C1)."""
    arch, jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, S)
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, batch)
    caches, logits = make_prefill_step(cfg, CACHE_LEN)(params, _torch(batch))
    _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg)
    if cfg.enc_dec:  # the projected memory: [n_rep, B, S_enc, KV, Dh]
        assert caches["p0"]["xk"].shape[2] == S // cfg.enc_len_ratio


def test_decode_steps_and_greedy_tokens_match_jax(setup):
    arch, jcfg, jparams, cfg, params = setup
    batch = _batch(cfg, S)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    jcaches, _ = _jax_prefill(jcfg, jparams, batch)
    caches, _ = make_prefill_step(cfg, CACHE_LEN)(params, _torch(batch))
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
    step = make_decode_step(cfg)
    for i in range(3):
        tok = tokens[:, i : i + 1]
        jlogits, jcaches = jstep(jparams, jcaches, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32))
        logits, caches = step(params, caches, torch.from_numpy(tok), S + i)
        _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg)
    want = jax_greedy_decode(jcfg, None, jparams, _jax(batch), GEN, CACHE_LEN)
    got = greedy_decode(cfg, params, _torch(batch), GEN, CACHE_LEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cross_attention_decode_reuses_the_cache_tensors():
    """Decode reads the projected memory from the cache and re-emits the
    cache's own tensors: the loop writes nothing into them."""
    cfg = configs.get_smoke(SEAMLESS)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    caches, logits = make_prefill_step(cfg, CACHE_LEN)(params, _torch(_batch(cfg, S)))
    before = {n: (caches["p0"][n].data_ptr(), caches["p0"][n].clone()) for n in ("xk", "xv")}
    for i in range(2):
        _, caches = make_decode_step(cfg)(params, caches, logits[:, :1].argmax(-1, keepdim=True), S + i)
    for n, (ptr, values) in before.items():
        assert caches["p0"][n].data_ptr() == ptr and torch.equal(caches["p0"][n], values)


def test_kernel_branch_launches_per_layer_and_matches_jax(setup, monkeypatch):
    """With the kernel on, at a length that is no multiple of 64, the port
    goes through the flash wrapper once per self-attention layer, the
    encoder's included (on the CPU its plain version), never for
    cross-attention, and agrees with the reference."""
    _, jcfg, jparams, cfg, params = setup
    calls = []
    monkeypatch.setattr(T, "flash_attention", lambda *a: calls.append(a[3]) or ops.flash_attention(*a))
    batch = _batch(cfg, 40)
    jcaches, jlogits = _jax_prefill(jcfg.replace(use_pallas="off"), jparams, batch)
    caches, logits = make_prefill_step(cfg.replace(use_pallas="on"), CACHE_LEN)(params, _torch(batch))
    n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
    assert calls == [False] * n_enc + [True] * cfg.n_layers  # causal flags: encoder, then decoder
    _close(logits, jlogits)
    _close_caches(caches, jcaches, cfg)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_decode_matches_forward(setup, use_pallas):
    """prefill(0..t-1) + decode_step(t) reproduces the forward logits at t
    (the port on its own init, fp32; tests/test_archs.py:80-119)."""
    arch, _, _, cfg, _ = setup
    cfg = cfg.replace(use_pallas=use_pallas)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    n_decode, total = 4, 32
    batch = _torch(_batch(cfg, total, seed=1, distinct_streams=False))
    with torch.inference_mode():
        full, _ = T.forward_train(cfg, params, batch)
    prompt = total - n_decode
    pbatch = dict(batch, tokens=batch["tokens"][:, :prompt])
    if cfg.vision_len_ratio:
        pbatch["positions3"] = batch["positions3"][:, :, :prompt]
    caches, logits = make_prefill_step(cfg, total)(params, pbatch)
    np.testing.assert_allclose(logits.numpy(), full[:, prompt - 1].numpy(), **TOL)
    step = make_decode_step(cfg)
    for i in range(n_decode - 1):
        logits, caches = step(params, caches, batch["tokens"][:, prompt + i : prompt + i + 1], prompt + i)
        np.testing.assert_allclose(logits.numpy(), full[:, prompt + i].numpy(), **TOL)


def test_mrope_prefill_needs_positions3():
    cfg = configs.get_smoke(QWEN2_VL)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    batch = _torch(_batch(cfg, 16))
    del batch["positions3"]
    with pytest.raises(ValueError, match="positions3"):
        make_prefill_step(cfg, 20)(params, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch):
    res = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "64", "--gen", "4",
                      "--device", "cpu", "--dtype", "float32"])
    assert res.tokens.shape == (2, 4) and res.logits_finite and res.prefills == 2
    assert len(res.decode_ms) == 3 and res.peak_memory_bytes is None
    assert 0 <= int(res.tokens.min()) and int(res.tokens.max()) < configs.get_smoke(arch).vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_batch_carries_the_stub_frontends(arch):
    cfg = configs.get_smoke(arch)
    b = serve.prompt_batch(cfg, 2, 64, seed=3, device="cpu")
    want = {"tokens": (2, 64), "encoder_embeds": (2, 16, 64)} if cfg.enc_dec else {
        "tokens": (2, 64), "vision_embeds": (2, 8, 64), "positions3": (3, 2, 64)}
    assert {k: tuple(v.shape) for k, v in b.items()} == want
    np.testing.assert_array_equal(b["tokens"].numpy(), serve.prompt_batch(cfg, 2, 64, 3, "cpu")["tokens"].numpy())
    for k in ("encoder_embeds", "vision_embeds"):
        if k in b:
            assert b[k].dtype == torch.bfloat16 and 0.015 < b[k].float().std().item() < 0.025
    if "positions3" in b:
        assert torch.equal(b["positions3"], torch.arange(64, dtype=torch.int32).expand(3, 2, 64))


@pytest.mark.parametrize("arch,error", [(SEAMLESS, KeyError), (QWEN2_VL, TypeError)])
def test_reference_serve_launcher_fails_on_both_models(arch, error, monkeypatch):
    """The reference fault the port does not copy (ROADMAP.md §C3):
    ``repro.launch.serve`` builds a batch of tokens only, so seamless's
    encoder finds no ``encoder_embeds`` and qwen2-vl's M-RoPE broadcasts a
    missing position."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--batch", "2", "--prompt-len", "16",
                                      "--gen", "2"])
    with pytest.raises(error):
        jserve.main()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_from_a_jax_checkpoint_gives_jax_greedy_tokens(tmp_path, arch):
    batch, prompt_len, gen = 2, 16, 4
    jcfg = jconfigs.get_smoke(arch)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    JCheckpointManager(JRepository.init(str(tmp_path))).save(5, jparams, {})
    prompts = serve.prompt_batch(configs.get_smoke(arch), batch, prompt_len, seed=0, device="cpu")
    jbatch = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.is_floating_point() else jnp.asarray(v.numpy())
              for k, v in prompts.items()}
    want = jax_greedy_decode(jcfg, None, jparams, jbatch, gen, prompt_len + gen)
    res = serve.run(arch, batch=batch, prompt_len=prompt_len, gen=gen, device="cpu", dtype="float32",
                    repo=str(tmp_path))
    assert res.checkpoint_step == 5
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_token_data_is_refused(tmp_path, arch):
    """The training data carries tokens only (ROADMAP.md §A item 7's
    follow-up); the launcher refuses before it makes a repository."""
    with pytest.raises(NotImplementedError, match="item 7"):
        launch_train.run(arch, steps=1, repo=str(tmp_path / "run"), device="cpu")
    assert not (tmp_path / "run").exists()
    ds = SyntheticTokens(vocab_size=512, seq_len=16, global_batch=2, seed=0)
    with pytest.raises(NotImplementedError, match="item 7"):
        train_segment(Repository.init(str(tmp_path / "loop")), configs.get_smoke(arch), ds, 1, device="cpu")
