"""The train step of every config, the port against the JAX package, on
the CPU at smoke sizes: one fp32 step, compressed gradients, remat on
against off and microbatches. tests/test_torch_train.py holds the data,
loss, optimizer, the loss drop on a repeated batch, checkpoints, the loop
and the launcher.

Parameters are initialised by JAX and converted leaf by leaf. Tolerances:
- loss: 1e-5 absolute after a model's forward;
- one train step in fp32: each gradient within rtol 1e-4 / atol 1e-5 (two
  layers of fp32 arithmetic in another order; gradients are O(1e-2)). The
  step's first moment is (1 - b1) clip(g), so its m is compared at
  rtol 1e-4 / atol 1e-6; post-Adam parameters are not compared, since
  Adam's first step is lr sign(g), which flips on tiny gradients;
- remat on against off: bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

QWEN = "qwen3_0_6b"


def _cfgs(arch, **change):
    return jconfigs.get_smoke(arch).replace(**change), configs.get_smoke(arch).replace(**change)


def _params(jcfg, dtype=jnp.float32):
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=dtype)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, **tol):
    got_l, want_l = leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _batches(cfg, shape):
    """(JAX batch, port batch): ``_tokens`` and, for the encoder-decoder and
    VLM configs, the stub frontends' inputs of ``serve.prompt_batch`` (bf16
    values cross exactly through fp32)."""
    tokens = _tokens(cfg.vocab_size, shape)
    stubs = {k: v for k, v in serve.prompt_batch(cfg, *shape, seed=0, device="cpu").items() if k != "tokens"}
    jstubs = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.is_floating_point() else jnp.asarray(v.numpy())
              for k, v in stubs.items()}
    return {"tokens": jnp.asarray(tokens), **jstubs}, {"tokens": torch.from_numpy(tokens), **stubs}


def _one_step(arch, *, n_mb=1, compress=False, n_steps=1):
    """``n_steps`` fp32 train steps from identical state in both packages;
    returns (JAX (params, opt_state, metrics), port's)."""
    jcfg, cfg = _cfgs(arch, microbatches=n_mb)
    jparams, params = _params(jcfg)
    jbatch, batch = _batches(cfg, (4, 32))
    jopt, opt = jadamw.AdamW(lr=1e-3), adamw.AdamW(lr=1e-3)
    jfn = jax.jit(jsteps.make_train_step(jcfg, None, jopt, compress_grads=compress))
    fn = steps.make_train_step(cfg, opt, compress_grads=compress)
    jout = (jparams, jopt.init(jparams), None)
    out = (params, opt.init(params), None)
    for _ in range(n_steps):
        jout = jfn(jout[0], jout[1], jbatch)
        out = fn(out[0], out[1], batch)
    return jout, out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_matches_jax(arch):
    (_, jst, jm), (_, st, m) = _one_step(arch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    if _cfgs(arch)[1].moe is None:
        assert m["aux_loss"].item() == float(jm["aux_loss"]) == 0.0
    else:  # the MoE models: the routers' load-balancing loss, also weighted into the gradients above
        assert float(jm["aux_loss"]) > 0
        np.testing.assert_allclose(m["aux_loss"].item(), float(jm["aux_loss"]), rtol=1e-5)
    _close(st["m"], jst["m"], rtol=1e-4, atol=1e-6)  # (1 - b1) clip(g)


def test_train_step_with_compressed_gradients_matches_jax():
    """Two steps through int8 error feedback. A gradient that the packages
    give within ~1e-7 of a rounding boundary of its int8 code may take the
    next code in one of them, which moves that element's residual by one
    code step (its row's max |g| / 127) and its m by a tenth of that; any
    other element is held as in the uncompressed step."""
    (_, jst, jm), (_, st, m) = _one_step(QWEN, compress=True, n_steps=2)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=0, atol=1e-5)
    assert sorted(st) == sorted(jst) == ["ef_residual", "m", "step", "v"]
    # a residual's largest value is about half its leaf's largest code step
    for name, step_of in (("m", lambda w: 4 * np.abs(w).max() / 127), ("ef_residual", lambda w: 2 * np.abs(w).max())):
        for g, w in zip(leaves(st[name]), jax.tree.leaves(jst[name])):
            g, w = _np(g), _np(w)
            off = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
            assert off.mean() <= 1e-3, name
            assert np.all(np.abs(g - w)[off] <= step_of(w) + 1e-6), name


def _grads(cfg, params, tokens):
    _, _, grads = steps.make_grad_fn(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    return grads


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "rwkv6_1_6b", "jamba_1_5_large_398b", "mixtral_8x22b",
                                  "arctic_480b"])
def test_remat_gives_the_gradients_of_the_plain_backward(arch):
    """Recomputing each repeat's forward in the backward changes no bit
    (the MoE models' aux loss passes through each repeat's checkpoint; jamba's
    one repeat mixes Mamba layers, attention and four MoE layers)."""
    jcfg, cfg = _cfgs(arch)
    _, params = _params(jcfg)
    tokens = _tokens(cfg.vocab_size, (2, 32))
    assert cfg.remat
    on, off = _grads(cfg, params, tokens), _grads(cfg.replace(remat=False), params, tokens)
    for a, b in zip(leaves(on), leaves(off)):
        assert torch.equal(a, b)


def test_split_microbatches_matches_jax():
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "positions3": rng.integers(0, 9, (3, 4, 6)).astype(np.int32)}
    want = jsteps._split_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = steps._split_microbatches({k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="microbatches"):
        steps._split_microbatches({"tokens": torch.zeros(3, 2)}, 2)


def test_microbatches_match_the_full_batch_and_jax():
    """tests/test_microbatch.py's bounds for 2 microbatches against 1 (loss
    2e-3, params 5e-3), and the port against JAX at 2 (the same bf16 cast
    of the mean gradient)."""
    (jp2, jst2, jm2), (p2, st2, m2) = _one_step(QWEN, n_mb=2)
    _, (p1, _, m1) = _one_step(QWEN, n_mb=1)
    assert abs(m1["loss"].item() - m2["loss"].item()) < 2e-3
    _close(p2, tree_map(_np, p1), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(m2["loss"].item(), float(jm2["loss"]), rtol=0, atol=1e-5)
    _close(st2["m"], jst2["m"], rtol=1e-4, atol=1e-6)
