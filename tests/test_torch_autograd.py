"""The kernel ops' autograd Functions against ``jax.grad`` through the JAX
package's ``ops.*`` (Pallas kernels in interpret mode, ``custom_vjp``
backward through ``ref.py``).

A CUDA kernel cannot run here, so each Function's forward is given the
kernel's plain version in the kernel wrapper's place (counted, as
``chip_smoke.py``'s rehearsal does); its backward is the one the card runs.
The loss is a random weighting of every output, the same on both sides.
Tolerance: fp32 1e-5 (rtol and atol), the same arithmetic in another
summation order. On the card, tests/test_torch_gpu.py holds the same
Functions with the real kernels against the plain version's autograd.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def counted(monkeypatch):
    """Every kernel wrapper replaced by its plain version, counting calls."""
    calls = {"flash": 0, "rwkv6": 0, "mamba": 0}

    def flash(q, k, v, *, causal, window):
        calls["flash"] += 1
        return ref.attention_ref(q, k, v, causal, window)

    def rwkv6(*a):
        calls["rwkv6"] += 1
        return ref.rwkv6_ref(*a)

    def mamba(*a):
        calls["mamba"] += 1
        return ref.mamba_ref(*a)

    monkeypatch.setattr(ops, "flash_attention_fwd", flash)
    monkeypatch.setattr(ops, "rwkv6_fwd", rwkv6)
    monkeypatch.setattr(ops, "mamba_scan_fwd", mamba)
    return calls


def _arrays(rng, shapes: dict, **special) -> dict:
    out = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
    for n, fn in special.items():
        out[n] = fn(out[n]).astype(np.float32)
    return out


def _grads_port(function, arrays: dict, names_diff, static, weights):
    """Gradients through ``function``: an ``autograd.Function`` (its
    ``apply``) or a plain callable."""
    leaves = {n: (None if a is None else torch.from_numpy(a.copy()).requires_grad_(n in names_diff))
              for n, a in arrays.items()}
    outs = getattr(function, "apply", function)(*leaves.values(), *static)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    loss.backward()
    return {n: leaves[n].grad.numpy() for n in names_diff}


def _grads_jax(fn, arrays: dict, names_diff, weights):
    def loss(diff):
        outs = fn(**{**{n: jnp.asarray(a) for n, a in arrays.items() if a is not None}, **diff})
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o * w).sum() for o, w in zip(outs, weights))

    g = jax.grad(loss)({n: jnp.asarray(arrays[n]) for n in names_diff})
    return {n: np.asarray(v) for n, v in g.items()}


@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 32, True, 16), (1, 128, 128, 2, 2, 96, False, None)])
def test_flash_attention_gradients_match_jax(counted, shape):
    b, sq, sk, h, kv, dh, causal, window = shape
    rng = np.random.default_rng(0)
    arrays = _arrays(rng, {"q": (b, sq, h, dh), "k": (b, sk, kv, dh), "v": (b, sk, kv, dh)})
    weights = [rng.normal(0, 1, (b, sq, h, dh)).astype(np.float32)]
    names = ("q", "k", "v")
    got = _grads_port(ops.FlashAttention, arrays, names, (causal, window), weights)
    want = _grads_jax(lambda q, k, v: jax_ops.flash_attention(q, k, v, causal, window, True),
                      arrays, names, weights)
    assert counted["flash"] == 1
    for n in names:
        np.testing.assert_allclose(got[n], want[n], **TOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_rwkv6_gradients_match_jax(counted, with_state):
    b, s, h, dh = 2, 64, 2, 32
    rng = np.random.default_rng(1)
    arrays = _arrays(rng, {"r": (b, s, h, dh), "k": (b, s, h, dh), "v": (b, s, h, dh),
                           "logw": (b, s, h, dh), "u": (h, dh), "state0": (b, h, dh, dh)},
                     logw=lambda x: -np.abs(x) - 0.05, state0=lambda x: 0.3 * x)
    weights = [rng.normal(0, 1, (b, s, h, dh)).astype(np.float32),
               rng.normal(0, 1, (b, h, dh, dh)).astype(np.float32)]
    names = ("r", "k", "v", "logw", "u") + (("state0",) if with_state else ())
    jax_arrays = dict(arrays)
    if not with_state:
        arrays["state0"] = None  # the port's zeros; JAX's ops take an array
        jax_arrays["state0"] = np.zeros((b, h, dh, dh), np.float32)
    got = _grads_port(ops.RWKV6, arrays, names, (), weights)
    want = _grads_jax(lambda **a: jax_ops.rwkv6(**a, interpret=True), jax_arrays, names, weights)
    assert counted["rwkv6"] == 1
    for n in names:
        np.testing.assert_allclose(got[n], want[n], **TOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_mamba_scan_gradients_match_jax(counted, with_state):
    b, s, di, st = 2, 64, 64, 8
    rng = np.random.default_rng(2)
    arrays = _arrays(rng, {"u": (b, s, di), "dt": (b, s, di), "A": (di, st), "B_": (b, s, st),
                           "C_": (b, s, st), "h0": (b, di, st)},
                     dt=lambda x: 0.1 * np.abs(x), A=lambda x: -np.abs(x), h0=lambda x: 0.3 * x)
    weights = [rng.normal(0, 1, (b, s, di)).astype(np.float32),
               rng.normal(0, 1, (b, di, st)).astype(np.float32)]
    names = ("u", "dt", "A", "B_", "C_") + (("h0",) if with_state else ())
    jax_arrays = dict(arrays)
    if not with_state:
        arrays["h0"] = None
        jax_arrays["h0"] = np.zeros((b, di, st), np.float32)
    got = _grads_port(ops.MambaScan, arrays, names, (), weights)
    want = _grads_jax(lambda **a: jax_ops.mamba_scan(**a, interpret=True), jax_arrays, names, weights)
    assert counted["mamba"] == 1
    for n in names:
        np.testing.assert_allclose(got[n], want[n], **TOL)


@pytest.mark.parametrize("with_state", [True, False])
def test_mamba_scan_backward_at_512_steps_is_the_loops(counted, with_state):
    """At S=512, where ``ssm.mamba_scan_chunked`` cuts two 256-step chunks,
    the op's backward recomputes through the plain loop ``ref.mamba_ref``:
    its gradients are the loop's autograd, bit for bit. The chunked form's
    are too, but for A's, which sum over the chunks in another order: within
    1e-5 here, outside it on the card at jamba's width (chip_smoke.py phase
    30), which is why the op keeps the loop."""
    b, s, di, st = 2, 512, 16, 4
    rng = np.random.default_rng(7)
    arrays = _arrays(rng, {"u": (b, s, di), "dt": (b, s, di), "A": (di, st), "B_": (b, s, st),
                           "C_": (b, s, st), "h0": (b, di, st)},
                     dt=lambda x: 0.1 * np.abs(x), A=lambda x: -np.abs(x), h0=lambda x: 0.3 * x)
    weights = [rng.normal(0, 1, (b, s, di)).astype(np.float32),
               rng.normal(0, 1, (b, di, st)).astype(np.float32)]
    names = ("u", "dt", "A", "B_", "C_") + (("h0",) if with_state else ())
    if not with_state:
        arrays["h0"] = None
    loop = _grads_port(ref.mamba_ref, arrays, names, (), weights)
    got = _grads_port(ops.MambaScan, arrays, names, (), weights)
    chunked = _grads_port(ssm.mamba_scan_chunked, arrays, names, (), weights)
    assert counted["mamba"] == 1
    for n in names:
        np.testing.assert_array_equal(got[n], loop[n])
        if n == "A":
            np.testing.assert_allclose(chunked[n], loop[n], **TOL)
        else:
            np.testing.assert_array_equal(chunked[n], loop[n])


def test_only_the_inputs_that_need_a_gradient_get_one(counted):
    """r alone: rwkv6's state does not depend on r, and the other inputs get
    no gradient."""
    rng = np.random.default_rng(3)
    r, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 16, 2, 16)).astype(np.float32)) for _ in range(3))
    logw = -torch.rand(1, 16, 2, 16) - 0.05
    u = torch.randn(2, 16)
    r.requires_grad_()
    out, state = ops.RWKV6.apply(r, k, v, logw, u, None)
    (out.sum() + state.sum()).backward()
    r_ref = r.detach().requires_grad_()
    want_out, want_state = ref.rwkv6_ref(r_ref, k, v, logw, u, None)
    (want_out.sum() + want_state.sum()).backward()
    assert torch.equal(r.grad, r_ref.grad) and k.grad is None and u.grad is None


def test_inference_mode_records_nothing_and_launches_once(counted):
    q = torch.randn(1, 32, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 32, 1, 16), torch.randn(1, 32, 1, 16)
    with torch.inference_mode():
        out = ops.FlashAttention.apply(q, k, v, True, None)
    assert out.grad_fn is None and counted["flash"] == 1
    assert torch.equal(out, ref.attention_ref(q, k, v, True, None).detach())
