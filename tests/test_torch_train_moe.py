"""Mixtral's train step at its real routing, the port against the JAX
package on the CPU, and ``chip_smoke.py``'s routing pin under remat.

The smoke mixtral routes 4 experts at capacity factor 8.0, so its queue
never drops a choice. Here the smoke widths take the full config's MoE (8
experts, top-2, capacity factor 1.25): at (4, 32) tokens each batch row's
expert holds 10 of the row's 64 choices, and each layer's queue drops some.

Parameters are initialised by JAX and converted leaf by leaf. Tolerances, as
tests/test_torch_train_steps.py holds every smoke config's step: loss 1e-5
absolute, the aux loss and grad norm rtol 1e-5, the first moment rtol 1e-4
/ atol 1e-6; remat on against off and a step pinned to its own routes
against the free-running step: bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

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
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MIXTRAL = "mixtral_8x22b"
SHAPE = (4, 32)


def _real_moe(cfg):
    full = configs.get(MIXTRAL).moe
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=full.n_experts, top_k=full.top_k,
                                               capacity_factor=full.capacity_factor))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX params, port params, JAX batch, port batch)."""
    jcfg, cfg = _real_moe(jconfigs.get_smoke(MIXTRAL)), _real_moe(configs.get_smoke(MIXTRAL))
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor) == (8, 2, 1.25)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, SHAPE).astype(np.int32)
    return jcfg, cfg, jparams, params, {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}


def _grads(cfg, params, batch):
    return steps.make_grad_fn(cfg)(params, batch)


def test_train_step_at_the_real_routing_matches_jax(model):
    jcfg, cfg, jparams, params, jbatch, batch = model
    jopt, opt = jadamw.AdamW(lr=1e-3), adamw.AdamW(lr=1e-3)
    _, jst, jm = jax.jit(jsteps.make_train_step(jcfg, None, jopt))(jparams, jopt.init(jparams), jbatch)
    own = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")  # the step updates in place
    _, st, m = steps.make_train_step(cfg, opt)(own, opt.init(own), batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    assert float(jm["aux_loss"]) > 0
    np.testing.assert_allclose(m["aux_loss"].item(), float(jm["aux_loss"]), rtol=1e-5)
    got, want = leaves(st["m"]), jax.tree.leaves(jst["m"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=1e-4, atol=1e-6)


def test_every_layer_drops_choices_at_capacity_factor_1_25(model, smoke):
    _, cfg, _, params, _, batch = model
    with smoke.routing(torch, moe) as routes:
        _grads(cfg, params, batch)
    assert len(routes) == cfg.n_layers == 2
    fill, dropped = smoke.slot_fill(torch, routes, cfg.moe)
    assert all(n > 0 for n in dropped), dropped
    b, s = SHAPE
    capacity = int(cfg.moe.capacity_factor * s * cfg.moe.top_k / cfg.moe.n_experts)
    kept = [b * s * cfg.moe.top_k - n for n in dropped]
    assert fill == sum(kept) / (cfg.n_layers * cfg.moe.n_experts * b * capacity)


def test_remat_is_bitwise_at_the_real_routing(model):
    _, cfg, _, params, _, batch = model
    assert cfg.remat
    on, off = _grads(cfg, params, batch), _grads(cfg.replace(remat=False), params, batch)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for a, b in zip(leaves(on[2]), leaves(off[2])):
        assert torch.equal(a, b)


def test_routing_pin_holds_under_remat(model, smoke):
    """Every layer pinned to its own free-running routes: each layer's
    forward and its recompute take that layer's pin (the recompute runs
    in reverse layer order, so a pin by call count would ask for a third
    pin at 2 layers and raise), no route is recorded twice, and the step's
    loss, aux loss and gradients are bit for bit the unpinned step's."""
    _, cfg, _, params, _, batch = model
    assert cfg.remat and cfg.n_layers == 2
    with smoke.routing(torch, moe) as free:
        want = _grads(cfg, params, batch)
    original, taken = moe.router_topk, []
    with smoke.routing(torch, moe, pinned=list(free)) as pinned:
        pin = moe.router_topk

        def spy(x, w_router, mcfg):  # the experts each call of the pinned router routes by
            out = pin(x, w_router, mcfg)
            taken.append(out[1])
            return out

        moe.router_topk = spy
        try:
            got = _grads(cfg, params, batch)
        finally:
            moe.router_topk = pin
    assert moe.router_topk is original
    assert len(pinned) == len(free) == 2
    # the forward in layer order, then remat's recompute in reverse
    assert len(taken) == 4 and all(idx is free[layer] for layer, idx in zip((0, 1, 1, 0), taken))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        assert torch.equal(a, b)
