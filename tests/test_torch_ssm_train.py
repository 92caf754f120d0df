"""Training through the recurrences, on the CPU: the chunked WKV and Mamba
forms' per-chunk remat, AdamW's in-place clipping and sliced update, and a
smoke rwkv6 and jamba train step through the kernel ops' autograd
Functions against the JAX package's step.

A CUDA kernel cannot run here, so each Function's forward is given the
kernel's plain version in the kernel wrapper's place (counted); its
backward is the one the card runs, through ``ref.rwkv6_ref`` and
``ref.mamba_ref``. Tolerances: remat, clipping and the
update are bitwise; the train step as tests/test_torch_train_steps.py
holds it (loss 1e-5 absolute, grad norm 1e-5, m rtol 1e-4 / atol 1e-6).
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

JAMBA = "jamba_1_5_large_398b"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the steps here are loops of small ops, and with
    the other test workers on the cores, more threads mostly wait on each
    other (a step at S=512 took 30x longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_remat(fn, *args, **_kw):
    return fn(*args)


def _inputs(kind: str, seed: int = 0) -> list:
    """fp32 inputs of a chunked form, as the model gives them: rwkv6 at
    S=64 (4 chunks of 16), Mamba at S=512 (2 chunks of 256), each with a
    state."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    if kind == "rwkv6":
        b, s, h, dh = 2, 64, 2, 16
        return [n(b, s, h, dh), n(b, s, h, dh), n(b, s, h, dh), -n(b, s, h, dh).abs() - 0.05, n(h, dh),
                n(b, h, dh, dh, scale=0.3)]
    b, s, di, st = 2, 512, 16, 4
    return [n(b, s, di), 0.1 * n(b, s, di).abs(), -n(di, st).abs(), n(b, s, st), n(b, s, st),
            n(b, di, st, scale=0.3)]


CHUNKED = {"rwkv6": (ssm.rwkv6_chunked, ssm.RWKV_CHUNK), "mamba": (ssm.mamba_scan_chunked, ssm.MAMBA_CHUNK)}


def _values_and_grads(fn, args, outer: bool):
    """Outputs and the gradients of a random weighting of them with respect
    to every input; with ``outer`` the call runs inside a checkpoint of its
    own, as the layer's remat runs it."""
    leaves_ = [a.clone().requires_grad_() for a in args]
    outs = checkpoint(fn, *leaves_, use_reentrant=False) if outer else fn(*leaves_)
    g = torch.Generator().manual_seed(9)
    sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs).backward()
    return [o.detach() for o in outs] + [x.grad for x in leaves_]


@pytest.mark.parametrize("outer", [False, True], ids=["alone", "inside_the_layer_remat"])
@pytest.mark.parametrize("kind", ["rwkv6", "mamba"])
def test_chunked_form_remat_changes_no_bit(monkeypatch, kind, outer):
    """Values and gradients with each chunk rematerialised equal those of the
    same loop without it, bit for bit, alone and nested in an outer
    checkpoint."""
    fn, chunk = CHUNKED[kind]
    args = _inputs(kind)
    calls = []
    body = "_wkv_chunk" if kind == "rwkv6" else "mamba_scan_naive"
    inner = getattr(ssm, body)
    monkeypatch.setattr(ssm, body, lambda *a: calls.append(1) or inner(*a))
    got = _values_and_grads(fn, args, outer)
    n_chunks = args[0].shape[1] // chunk
    # the forward and each chunk's remat; nested, the outer recompute too, which
    # may stop early, before the last chunk's body (nothing it saves is needed)
    assert len(calls) in ((3 * n_chunks - 1, 3 * n_chunks) if outer else (2 * n_chunks,))
    monkeypatch.setattr(ssm, "checkpoint", _no_remat)
    want = _values_and_grads(fn, args, outer)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _saved_bytes(fn, args) -> int:
    """Bytes of the distinct storages that autograd keeps from the forward
    of ``fn(*args)`` for its backward: the tensors saved outside a
    checkpoint and each checkpoint's inputs."""
    kept = {}

    def pack(t):
        kept[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return sum(kept.values())


@pytest.mark.parametrize("kind", ["rwkv6", "mamba"])
def test_chunked_form_keeps_one_chunk_of_residuals(monkeypatch, kind):
    """With remat, what the forward keeps for the backward is at most its
    inputs, the state carried into each chunk and one chunk's residuals
    (each chunk's are made again in the backward, one at a time); without
    it, every chunk's residuals, more than that bound."""
    fn, chunk = CHUNKED[kind]
    args = [a.requires_grad_() for a in _inputs(kind)]
    b, s = args[0].shape[:2]
    n_chunks = s // chunk
    state = args[-1]
    if kind == "rwkv6":
        h, dh = args[0].shape[2:]
        r, k, v, lw = (a[:, :chunk].detach().clone().requires_grad_() for a in args[:4])
        tri = torch.tril(torch.ones((chunk, chunk)), diagonal=-1)
        one_chunk = _saved_bytes(ssm._wkv_chunk, [r, k, v, lw, args[4], state, tri, torch.eye(chunk)])
    else:
        sl = [a[:, :chunk].detach().clone().requires_grad_() if a.dim() == 3 and a.shape[1] == s else a
              for a in args]
        one_chunk = _saved_bytes(ref.mamba_ref, sl)
    inputs = sum(a.untyped_storage().nbytes() for a in args)
    bound = inputs + n_chunks * state.untyped_storage().nbytes() + one_chunk
    with_remat = _saved_bytes(fn, args)
    monkeypatch.setattr(ssm, "checkpoint", _no_remat)
    without = _saved_bytes(fn, args)
    assert with_remat <= bound < without, (with_remat, bound, without)


# ------------------------------------------------------------------ AdamW
def _formula(opt, grads, state, params):
    """The clipping and the update as one whole-leaf expression each, the
    gradients left as they are: the arithmetic the sliced, in-place code
    must reproduce bit for bit."""
    norm = adamw.global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, opt.max_grad_norm) / (norm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = opt.lr(step) if callable(opt.lr) else opt.lr
    t = step.float()
    bc1, bc2 = 1 - opt.b1**t, 1 - opt.b2**t
    out = {"p": [], "m": [], "v": []}
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), leaves(params)):
        g32 = (g.float() * scale).to(g.dtype).float()
        m32 = opt.b1 * m.float() + (1 - opt.b1) * g32
        v32 = opt.b2 * v.float() + (1 - opt.b2) * g32.square()
        p32 = p.float()
        wd = opt.weight_decay if p.ndim >= 2 else 0.0
        out["p"].append((p32 - lr * ((m32 / bc1) / ((v32 / bc2).sqrt() + opt.eps) + wd * p32)).to(p.dtype))
        out["m"].append(m32.to(m.dtype))
        out["v"].append(v32.to(v.dtype))
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_inplace_clip_and_sliced_update_equal_the_whole_leaf_formula(monkeypatch, arch, dtype):
    """Every smoke config's params, bf16 (moments in the config's dtype) or
    fp32: three updates with slices of 1,000 elements (so most leaves are
    cut, raggedly) give params, m and v bitwise equal to the whole-leaf
    formula, the clip binding in the third; the gradients come back
    scaled in place."""
    monkeypatch.setattr(adamw, "SLICE", 1000)
    cfg = configs.get_smoke(arch)
    mdt = cfg.opt_moment_dtype if dtype == "bfloat16" else "float32"
    params = init_params(T.param_defs(cfg), seed=0, dtype=getattr(torch, dtype), device="cpu")
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-2, 2, 6), moment_dtype=mdt)
    state = opt.init(params)
    assert any(p.numel() > adamw.SLICE for p in leaves(params))
    small = 0.3 / sum(p.numel() for p in leaves(params)) ** 0.5  # a global norm of ~0.3
    for k in range(3):
        g = torch.Generator().manual_seed(k)
        grads = tree_map(lambda p: ((30.0 if k == 2 else small) * torch.randn(p.shape, generator=g)).to(p.dtype),
                         params)
        want = _formula(opt, grads, state, params)
        want_g = tree_map(lambda x: x.clone(), grads)
        params, state, stats = opt.update(grads, state, params)
        for name, got in (("p", leaves(params)), ("m", leaves(state["m"])), ("v", leaves(state["v"]))):
            assert all(torch.equal(a, b) for a, b in zip(got, want[name])), (k, name)
        norm = stats["grad_norm"]
        assert (norm.item() > opt.max_grad_norm) == (k == 2)
        scale = torch.clamp(torch.full_like(norm, opt.max_grad_norm) / (norm + 1e-9), max=1.0)
        for a, b in zip(leaves(grads), leaves(want_g)):  # scaled where they lie
            assert torch.equal(a, (b.float() * scale).to(b.dtype))


def test_clip_scales_a_gradient_that_two_leaves_share_once():
    """Autograd gives one tensor to both inputs of an add: clipping in place
    scales it once for each leaf, as for two distinct tensors."""
    a, b = (torch.randn(64, requires_grad=True) for _ in range(2))
    ga, gb = torch.autograd.grad(((a + b) * 10.0).sum(), [a, b])
    assert ga is gb
    want, _ = adamw.clip_by_global_norm({"a": ga.clone(), "b": ga.clone()}, 1.0)
    got, _ = adamw.clip_by_global_norm({"a": ga, "b": gb}, 1.0)
    assert got["a"] is not got["b"]
    assert all(torch.equal(got[n], want[n]) for n in want)


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", JAMBA])
def test_a_train_step_frees_its_gradients_without_the_cyclic_gc(monkeypatch, arch):
    """With the cyclic collector off, every gradient that ``autograd.grad``
    hands a smoke train step (remat, rwkv6's chunk checkpoints at S=32, the
    clipping and the sliced update) is freed when the step returns: one held
    by a reference cycle would live on while the next step makes its own (on
    the card, jamba's 18 GB over a plan of 72 GiB)."""
    made = []
    grad = torch.autograd.grad

    def recording(*args, **kwargs):
        out = grad(*args, **kwargs)
        made.extend(weakref.ref(g) for g in out if g is not None)
        return out

    monkeypatch.setattr(torch.autograd, "grad", recording)
    cfg = configs.get_smoke(arch).replace(moe=None)
    params = init_params(T.param_defs(cfg), seed=0, device="cpu")
    opt = adamw.AdamW()
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(0))}
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            params, state, _ = step(params, state, batch)
            assert made and all(r() is None for r in made)
            made.clear()
    finally:
        gc.enable()


# ------------------------------------------------------- the train step
@pytest.fixture
def through_ops(monkeypatch):
    """The model's kernel calls routed through the ops' autograd Functions,
    each Function's forward given its plain version (counted)."""
    calls = {"flash": 0, "rwkv6": 0, "mamba": 0}

    def counted(name, plain):
        def fwd(*a, **kw):
            calls[name] += 1
            return plain(*a, **kw)
        return fwd

    monkeypatch.setattr(ops, "flash_attention_fwd", counted(
        "flash", lambda q, k, v, *, causal, window: ref.attention_ref(q, k, v, causal, window)))
    monkeypatch.setattr(ops, "rwkv6_fwd", counted("rwkv6", ref.rwkv6_ref))
    monkeypatch.setattr(ops, "mamba_scan_fwd", counted("mamba", ref.mamba_ref))
    monkeypatch.setattr(T, "flash_attention", lambda q, k, v, causal=True, window=None:
                        ops.FlashAttention.apply(q, k, v, causal, window))
    monkeypatch.setattr(T, "rwkv6", ops.RWKV6.apply)
    monkeypatch.setattr(T, "mamba_scan", ops.MambaScan.apply)
    return calls


@pytest.mark.parametrize("arch,launches", [("rwkv6_1_6b", {"flash": 0, "rwkv6": 4, "mamba": 0}),
                                           (JAMBA, {"flash": 2, "rwkv6": 0, "mamba": 14})])
def test_smoke_train_step_through_the_kernel_ops_matches_jax(through_ops, arch, launches):
    """One fp32 step at B=2 x 512, jamba without experts as on the card,
    remat on (the layer's checkpoint around the ops' Functions, whose
    backwards recompute under ``enable_grad`` inside its recompute): each
    op runs its forward twice (the step's and remat's recompute), and the
    loss, the gradient norm and the first moments are JAX's."""
    change = {"moe": None} if arch == JAMBA else {}
    jcfg = jconfigs.get_smoke(arch).replace(**change)
    cfg = configs.get_smoke(arch).replace(use_pallas="on", **change)
    assert cfg.remat
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)
    jopt, opt = jadamw.AdamW(lr=1e-3), adamw.AdamW(lr=1e-3)
    _, jst, jm = jax.jit(jsteps.make_train_step(jcfg, None, jopt))(jparams, jopt.init(jparams),
                                                                   {"tokens": jnp.asarray(tokens)})
    _, st, m = steps.make_train_step(cfg, opt)(params, opt.init(params), {"tokens": torch.from_numpy(tokens)})
    assert through_ops == launches
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    got, want = leaves(st["m"]), jax.tree.leaves(jst["m"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=1e-4, atol=1e-6)
