"""The training path, the port against the JAX package, on the CPU at smoke
sizes: data, loss, optimizer, schedule, compression, checkpoints with their
records, the resumable loop (bit for bit, and across the packages) and the
launcher, and the loss drop of every config on a repeated batch.
tests/test_torch_train_steps.py holds the train step of every config
against JAX, remat and microbatches.

Parameters are initialised by JAX and converted leaf by leaf. Tolerances:
- batches, ``step``, ``lr`` and resumed state: bitwise (integers, or the
  same fp32 operations on the same values), except the cosine of the
  schedule, within one fp32 spacing (``_assert_same_lr``);
- loss: 1e-6 relative for one loss on given logits (the same fp32 lse in
  another summation order; the loss is O(10), its fp32 spacing ~1e-6);
  1e-5 absolute after a model's forward;
- optimizer and compression on the same gradients: 1e-6 (fp32 updates of
  values O(1); bf16 leaves are compared in fp32 after the same rounding);
- a bf16 checkpoint continued two steps by each package: the step equal;
  the loss within 1e-2 (bf16 logits); parameters within one bf16 rounding
  (rtol 2^-7) plus 4e-3 = 2 steps x 2 lr, since Adam moves a parameter by
  ~lr a step and a tiny gradient whose sign the two packages' bf16
  roundings disagree on moves it the other way; the moments, carried over
  bit for bit, within 5% of their leaf's largest value for the two new
  gradients' bf16 differences (a lost or reset moment is off by ~80%).
"""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.records import RunRecord as JRunRecord  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.data.tokens import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import cross_entropy as jax_cross_entropy  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.loop import train_segment as jax_train_segment  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.records import RunRecord  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.layers import cross_entropy  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402
from repro_torch.train.loop import train_segment  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

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


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step,shards", [(0, 0, 1), (1, 7, 2), (3, 1000, 4)])
def test_synthetic_tokens_are_jax_bit_for_bit(seed, step, shards):
    kw = dict(vocab_size=151936, seq_len=64, global_batch=8, seed=seed)
    ours, ref = SyntheticTokens(**kw), JSyntheticTokens(**kw)
    for shard in range(shards):
        got, want = ours.shard_batch_at(step, shard, shards), ref.shard_batch_at(step, shard, shards)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours.global_batch_at(step), ref.global_batch_at(step))


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_loss_matches_jax_on_a_padded_vocabulary(dtype):
    """granite's smoke vocabulary, 500, pads to 512: the pad columns must
    drop out of the lse in either dtype."""
    jcfg, cfg = _cfgs("granite_3_2b")
    assert cfg.padded_vocab == 512 and cfg.vocab_size == 500
    logits = np.random.default_rng(1).normal(0, 3, (2, 16, cfg.padded_vocab)).astype(np.float32)
    tokens = _tokens(cfg.vocab_size, (2, 16))
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = steps.masked_loss(tl, torch.from_numpy(tokens), cfg.vocab_size)
    want = jsteps.masked_loss(jl, jnp.asarray(tokens), jcfg.vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


def test_cross_entropy_with_a_mask_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (3, 10, 64)).astype(np.float32)
    labels = _tokens(64, (3, 10))
    for mask in (rng.random((3, 10)) < 0.6, np.zeros((3, 10), bool)):
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


# ------------------------------------------------------------- optimizer
def _opt_tree(dtype, seed):
    """Leaves of 1, 2 and 3 dims (decay applies from 2 on), nested as a model's."""
    rng = np.random.default_rng(seed)
    tree = {"final_norm": rng.normal(1, 0.1, (8,)), "embed": rng.normal(0, 0.5, (16, 8)),
            "blocks": {"p0": {"ln1": rng.normal(1, 0.1, (2, 8)), "w": rng.normal(0, 0.3, (2, 8, 4))}}}
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(dtype), tree)


@pytest.mark.parametrize("param_dtype,moment_dtype,schedule", [
    ("float32", "float32", False), ("float32", "float32", True),
    ("bfloat16", "float32", True), ("bfloat16", "bfloat16", False),
])
def test_adamw_updates_as_jax_on_the_same_gradients(param_dtype, moment_dtype, schedule):
    """Four updates from the same state with the same gradients (the last
    step clipped): params, m, v within 1e-6; step bitwise, lr as
    ``_assert_same_lr`` says."""
    lr = (jadamw.cosine_schedule(1e-2, 2, 6), adamw.cosine_schedule(1e-2, 2, 6)) if schedule else (1e-2, 1e-2)
    jopt = jadamw.AdamW(lr=lr[0], moment_dtype=moment_dtype)
    opt = adamw.AdamW(lr=lr[1], moment_dtype=moment_dtype)
    jp = _opt_tree(getattr(jnp, param_dtype), 0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jst, tst = jopt.init(jp), opt.init(tp)
    for k in range(4):
        jg = jax.tree.map(lambda a: a * (30.0 if k == 3 else 1.0), _opt_tree(getattr(jnp, param_dtype), k + 1))
        tg = params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
        jp, jst, jstats = jopt.update(jg, jst, jp)
        tp, tst, tstats = opt.update(tg, tst, tp)
        assert tst["step"].dtype == torch.int32 and tst["step"].item() == int(jst["step"]) == k + 1
        _assert_same_lr(tstats["lr"], jstats["lr"], k + 1, 1e-2, *((2, 6) if schedule else (9, 9)))
        np.testing.assert_allclose(tstats["grad_norm"].item(), float(jstats["grad_norm"]), rtol=1e-6)
        for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
            assert [t.dtype for t in leaves(got)] == [getattr(torch, str(w.dtype)) for w in jax.tree.leaves(want)]
            _close(got, want, rtol=1e-6, atol=1e-6)
    assert float(jstats["grad_norm"]) > opt.max_grad_norm  # the last step was clipped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(dtype):
    jg = jax.tree.map(lambda a: a * 4.0, _opt_tree(getattr(jnp, dtype), 5))
    tg = params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    want, wnorm = jadamw.clip_by_global_norm(jg, 1.0)
    got, norm = adamw.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    assert float(wnorm) > 1.0
    _close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(adamw.global_norm(got).item(), 1.0, rtol=1e-2)


def _assert_same_lr(got, want, step: int, base_lr: float, warmup: int, total: int) -> None:
    """Bitwise in the warm-up and at the cosine's ends. Inside, torch's cos
    (SLEEF, within 1 ulp) and XLA's on the CPU (the C library's cosf) may
    round to neighbouring floats, 2^-24 apart at most; through 1 + cos
    (spacing up to 2^-23) and 0.5 base_lr that is 0.5 base_lr 2^-22, plus
    the last rounding."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    if step <= warmup or step >= total:
        assert got.tobytes() == want.tobytes(), step
    else:
        assert abs(float(got) - float(want)) <= 0.5 * base_lr * 2**-22 + np.spacing(want), step


def test_cosine_schedule_matches_jax():
    want, got = jadamw.cosine_schedule(3e-4, 10, 40), adamw.cosine_schedule(3e-4, 10, 40)
    for step in range(0, 45):
        _assert_same_lr(got(torch.tensor(step, dtype=torch.int32)), want(jnp.asarray(step, jnp.int32)),
                        step, 3e-4, 10, 40)


def test_ef_compression_matches_jax():
    """Two rounds of int8 error feedback on the same gradients: the
    dequantised gradients and the residual within 1e-6, the int8 codes equal."""
    jg = _opt_tree(jnp.bfloat16, 3)
    tg = params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    jr = tr = None
    for _ in range(2):
        (jout, jr), (tout, tr) = jcompression.ef_compress_tree(jg, jr), compression.ef_compress_tree(tg, tr)
        _close(tout, jout, rtol=1e-6, atol=1e-6)
        _close(tr, jr, rtol=1e-6, atol=1e-6)
        assert [t.dtype for t in leaves(tout)] == [torch.bfloat16] * 4
    x = np.random.default_rng(4).normal(0, 1, (5, 7)).astype(np.float32)
    (q, s), (jq, js) = compression.compress_int8(torch.from_numpy(x)), jcompression.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)


# ------------------------------------------------------------- loss drop
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_reduces_loss_on_a_repeated_batch(arch):
    """tests/test_archs.py:65-77 in the port: bf16, the same batch 5 times."""
    jcfg, cfg = _cfgs(arch)
    _, params = _params(jcfg, jnp.bfloat16)
    opt = adamw.AdamW(lr=5e-3, moment_dtype=cfg.opt_moment_dtype)
    fn, state = steps.make_train_step(cfg, opt), opt.init(params)
    _, batch = _batches(cfg, (2, 32))
    losses = []
    for _ in range(5):
        params, state, metrics = fn(params, state, batch)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------- checkpoints, loop
@pytest.mark.parametrize("message", ["", "step three", "[REPRO CKPT] custom"])
def test_checkpoint_records_data_step_extra_and_message_as_jax(tmp_path, message):
    jparams, params = _params(jconfigs.get_smoke(QWEN))
    kw = dict(data_step=3, extra={"loss": 1.5, "config": "qwen3-0.6b-smoke"}, message=message)
    repo = Repository.init(str(tmp_path / "port"))
    oid = CheckpointManager(repo).save(3, params, adamw.AdamW().init(params), **kw)
    jrepo = JRepository.init(str(tmp_path / "jax"))
    joid = JCheckpointManager(jrepo).save(3, jparams, jadamw.AdamW().init(jparams), **kw)
    _, manifest = CheckpointManager(repo).restore(oid, device="cpu")
    _, jmanifest = JCheckpointManager(jrepo).restore(joid)
    assert manifest == jmanifest and manifest["data_step"] == 3 and manifest["extra"]["loss"] == 1.5
    msg, jmsg = repo.objects.get_commit(oid)["message"], jrepo.objects.get_commit(joid)["message"]
    assert msg.replace(repo.dsid, "") == jmsg.replace(jrepo.dsid, "")
    title = msg.splitlines()[0]
    assert title.count("[REPRO CKPT]") == 1 and title.endswith(message.removeprefix("[REPRO CKPT] ") or "step 3")
    assert RunRecord.from_message(msg).extras == JRunRecord.from_message(jmsg).extras == {
        "checkpoint_step": 3, "data_step": 3, "loss": 1.5, "config": "qwen3-0.6b-smoke"}


def _state_bits(repo):
    """{leaf path: annex key} of the newest checkpoint: equal keys, equal bytes."""
    mgr = CheckpointManager(repo)
    oid, step = mgr.latest()
    manifest = json.loads(mgr._tree_bytes(oid, f"checkpoints/step_{step:08d}/manifest.json"))
    return step, {p: m["key"] for p, m in manifest["leaves"].items()}


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_preemption_and_resume_are_bit_for_bit(tmp_path, async_ckpt):
    """tests/test_train.py:182 in the port: 6 steps unbroken against 3, a
    new segment, 3 more; every leaf of params, m and v equal."""
    cfg = configs.get_smoke(QWEN)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    repo_a = Repository.init(str(tmp_path / "a"))
    res_a = train_segment(repo_a, cfg, ds, n_steps=6, ckpt_every=2, async_ckpt=async_ckpt, device="cpu")
    repo_b = Repository.init(str(tmp_path / "b"))
    first = train_segment(repo_b, cfg, ds, n_steps=3, ckpt_every=3, async_ckpt=async_ckpt, device="cpu")
    res_b = train_segment(repo_b, cfg, ds, n_steps=6, ckpt_every=3, async_ckpt=async_ckpt, device="cpu")
    assert (first.start_step, res_b.start_step, res_a.end_step, res_b.end_step) == (0, 3, 6, 6)
    assert res_a.losses[3:] == res_b.losses and res_a.final_loss == res_b.final_loss
    assert _state_bits(repo_a) == _state_bits(repo_b)
    assert [s for _, s in CheckpointManager(repo_a).checkpoints()] == [6, 4, 2]
    assert res_a.checkpoint_commit == CheckpointManager(repo_a).latest()[0]
    _, manifest = CheckpointManager(repo_b).restore(device="cpu")
    assert manifest["data_step"] == 6 and manifest["extra"] == {"loss": res_b.final_loss, "config": cfg.name}
    state, _ = CheckpointManager(repo_b).restore(device="cpu")
    assert state["opt_state"]["step"].dtype == torch.int32 and state["opt_state"]["step"].item() == 6
    assert {t.dtype for t in leaves(state["params"])} == {torch.bfloat16}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, first):
    """Two steps in one package's train_segment, then two more in each
    package's from that checkpoint (bf16 parameters, fp32 moments): the
    same leaf paths, dtypes and shapes, and values within one bf16 rounding."""
    cfg, jcfg = configs.get_smoke(QWEN), jconfigs.get_smoke(QWEN)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    root = str(tmp_path / "start")
    if first == "jax":
        jax_train_segment(JRepository.init(root), jcfg, JSyntheticTokens(**kw), n_steps=2, ckpt_every=2)
    else:
        train_segment(Repository.init(root), cfg, SyntheticTokens(**kw), n_steps=2, ckpt_every=2, device="cpu")
    shutil.copytree(root, tmp_path / "j")
    shutil.copytree(root, tmp_path / "p")
    jres = jax_train_segment(JRepository(str(tmp_path / "j")), jcfg, JSyntheticTokens(**kw), n_steps=4,
                             ckpt_every=2)
    res = train_segment(Repository(str(tmp_path / "p")), cfg, SyntheticTokens(**kw), n_steps=4, ckpt_every=2,
                        device="cpu")
    assert res.start_step == jres.start_step == 2
    np.testing.assert_allclose(res.final_loss, jres.final_loss, rtol=0, atol=1e-2)
    jstate, jmanifest = JCheckpointManager(JRepository(str(tmp_path / "j"))).restore()
    state, manifest = CheckpointManager(Repository(str(tmp_path / "p"))).restore(device="cpu")
    assert ({p: (m["dtype"], m["shape"]) for p, m in manifest["leaves"].items()}
            == {p: (m["dtype"], m["shape"]) for p, m in jmanifest["leaves"].items()})
    assert (manifest["step"], manifest["data_step"]) == (jmanifest["step"], jmanifest["data_step"]) == (4, 4)
    flat, jflat = _flatten(state), _flatten(jstate)
    assert sorted(flat) == sorted(jflat)
    assert flat["opt_state/step"].item() == int(jflat["opt_state/step"]) == 4
    for p in flat:
        got, want = _np(flat[p]), _np(jflat[p])
        if p.startswith("params/"):  # two updates of at most ~lr each, apart by at most 2 lr each
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=4e-3, err_msg=p)
        else:  # moments carried over bit for bit, plus two gradients from bf16 activations
            assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), p


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    repo = str(tmp_path / "run")
    argv = ["--arch", QWEN, "--steps", "3", "--ckpt-every", "2", "--repo", repo, "--seq-len", "16",
            "--batch", "2", "--device", "cpu"]
    res = launch_train.main(argv)
    assert (res.start_step, res.end_step, len(res.step_ms), len(res.save_s)) == (0, 3, 3, 2)
    assert np.isfinite(res.final_loss) and "new repository" in capsys.readouterr().out
    again = launch_train.main(argv[:3] + ["5"] + argv[4:])
    assert (again.start_step, again.end_step) == (3, 5)
    assert "resuming in existing repository" in capsys.readouterr().out
    assert [s for _, s in CheckpointManager(Repository(repo)).checkpoints()] == [5, 4, 3, 2]


def test_launch_train_takes_the_config_cuts(tmp_path):
    """``--n-layers`` and ``--n-experts``, as ``launch.serve`` takes them:
    the checkpoint holds arctic's smoke model at 1 layer with 2 experts."""
    repo = str(tmp_path / "run")
    launch_train.main(["--arch", "arctic_480b", "--n-layers", "1", "--n-experts", "2", "--steps", "1",
                       "--ckpt-every", "1", "--repo", repo, "--seq-len", "16", "--batch", "2", "--device", "cpu"])
    _, manifest = CheckpointManager(Repository(repo)).restore(device="cpu")
    cfg = configs.get_smoke("arctic_480b")
    assert manifest["leaves"]["params/blocks/p0/moe/e_w1"]["shape"] == [1, 2, cfg.d_model, cfg.d_ff]
    assert manifest["leaves"]["params/blocks/p0/moe/dense/w1"]["shape"] == [1, cfg.d_model, cfg.d_ff]


def test_training_needs_cuda_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_smoke(QWEN)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_segment(Repository.init(str(tmp_path / "r")), cfg, ds, n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.run(QWEN, steps=1, repo=str(tmp_path / "l"))
    assert not (tmp_path / "l").exists()
