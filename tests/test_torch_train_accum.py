"""The train step's accumulation, compression and async-save paths, the
port against the JAX package on the CPU at smoke sizes, and their plans.

``chip_smoke.py``'s phase 43 runs these on the card at full width: qwen3
at B=64 x 512 in 8 microbatches with int8 error-feedback gradients, held to
a ``--one-card`` plan of the compressed step, and a resume through
``launch.train.run`` across async saves. Here:

- a compressed step plans ``ef_residual`` stand-ins (fp32, placed as the
  params) and counts the FLOPs that ``FlopCounterMode`` counts over a real
  CPU step, and a microbatched plan counts two flash launches an attention
  layer a microbatch; ``--compress-grads`` on the command line;
- 2 microbatches with compression over 2 steps against
  ``repro.train.steps.make_train_step(..., compress_grads=True)``: loss 1e-5,
  m and the residual rtol 1e-4 / atol 1e-6 (the bars of
  tests/test_torch_train_steps.py, whose compressed case also allows a
  gradient within ~1e-7 of a rounding boundary of its int8 code to take the
  next code in one package);
- a resume through the launcher with 2 microbatches across async saves, one
  of them held in flight through a step, bit for bit the unbroken sync run;
- a compressed state through ``CheckpointManager``: the next step from the
  restored state is the unbroken one's bit for bit, and the JAX package's
  ``CheckpointManager`` restores its residual to the same bytes.
"""
import json
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.distributed.sharding import rules_for  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.op_stats import BLOCK  # noqa: E402
from repro_torch.launch.serve import prompt_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, tree_paths  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

QWEN = "qwen3_0_6b"
TRAIN = configs.Shape("smoke_train", "train", 32, 4)


def _block(nbytes: int) -> int:
    """A tensor's bytes as the plan counts them: rounded up to the caching allocator's block."""
    return -(-nbytes // BLOCK) * BLOCK


def _residual_zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), params)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("mesh", ["unsharded", "pod16x16"])
def test_a_compressed_plan_stands_in_an_fp32_residual_placed_as_the_params(mesh):
    cfg = configs.get(QWEN)
    started = mesh != "unsharded"
    rules = rules_for(cfg, launch_mesh.make_production_mesh()) if started else None
    try:
        params, opt_state = specs.model_state_specs(cfg, rules, True, compress_grads=True)
        _, plain = specs.model_state_specs(cfg, rules, True)
    finally:
        if started:
            dist.destroy_process_group()
    assert sorted(opt_state) == ["ef_residual", "m", "step", "v"] and "ef_residual" not in plain
    for p, r in zip(leaves(params), leaves(opt_state["ef_residual"])):
        assert (r.shape, r.dtype) == (p.shape, torch.float32)
        if started:
            assert r.placements == p.placements and r._local_tensor.shape == p._local_tensor.shape
        else:
            assert r.device.type == "meta"


@pytest.mark.parametrize("n_mb", [1, 2])
def test_a_compressed_smoke_plan_counts_the_flops_of_a_real_cpu_step(n_mb):
    """As tests/test_torch_dryrun.py holds the plain step: the plan on meta
    stand-ins and a real CPU step (with a residual, as the stand-ins hold
    one) count the same FLOPs."""
    cfg = configs.get_smoke(QWEN).replace(use_pallas="off", microbatches=n_mb)
    plan = dryrun.plan_step(cfg, TRAIN, compress_grads=True)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.bfloat16, device="cpu")
    opt = specs.make_optimizer(cfg)
    state = {**opt.init(params), "ef_residual": _residual_zeros(params)}
    batch = prompt_batch(cfg, TRAIN.global_batch, TRAIN.seq_len, 0, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        _, new_state, _ = steps.make_train_step(cfg, opt, compress_grads=True)(params, state, batch)
    assert plan["flops"] == fc.get_total_flops() > 0
    assert any(r.abs().max() > 0 for r in leaves(new_state["ef_residual"]))
    residual = plan["memory"]["argument_bytes"] - dryrun.plan_step(cfg, TRAIN)["memory"]["argument_bytes"]
    assert residual == sum(_block(4 * p.numel()) for p in leaves(params))


@pytest.mark.parametrize("n_mb", [2, 4])
def test_a_microbatched_plan_counts_two_flash_launches_a_layer_a_microbatch(n_mb):
    cfg = configs.get_smoke(QWEN).replace(microbatches=n_mb)
    attn_layers = cfg.n_repeats * sum(kind.mixer == "attn" for kind in cfg.pattern)
    for compress in (False, True):
        plan = dryrun.plan_step(cfg, TRAIN, compress_grads=compress)
        assert dryrun.kernel_calls(plan["ops"]) == {"flash_attention_fwd": 2 * attn_layers * n_mb}


def test_compress_grads_on_the_command_line(monkeypatch, capsys):
    """``--one-card --compress-grads`` plans the compressed step (its
    arguments hold the fp32 residual of every parameter); without
    ``--one-card`` the flag is refused."""
    argv = ["dryrun", "--arch", QWEN, "--shape", "train_4k", "--one-card", "--batch", "2", "--seq-len", "32",
            "--override", "n_layers=1", "--override", "microbatches=2"]
    cells = {}
    for extra in ([], ["--compress-grads"]):
        monkeypatch.setattr("sys.argv", argv + extra)
        dryrun.main()
        out = capsys.readouterr().out
        cells[bool(extra)] = next(json.loads(ln) for ln in out.splitlines() if ln.startswith("{"))
    assert "int8 error-feedback gradients" in out
    plain, compressed = cells[False], cells[True]
    assert (plain["compress_grads"], compressed["compress_grads"]) == (False, True)
    assert compressed["kernel_calls"] == plain["kernel_calls"] == {"flash_attention_fwd": 4}
    defs = T.param_defs(configs.get(QWEN).replace(n_layers=1))
    residual = sum(_block(4 * math.prod(d.shape)) for _, d in tree_paths(defs))
    assert compressed["memory"]["argument_bytes"] - plain["memory"]["argument_bytes"] == residual
    assert compressed["memory"]["peak_bytes"] > plain["memory"]["peak_bytes"]
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", QWEN, "--shape", "train_4k", "--compress-grads"])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 2 and "--compress-grads plans with --one-card" in capsys.readouterr().err


# ------------------------------------------------------------ against JAX
def test_compressed_microbatched_steps_match_jax():
    """Two steps of 2 microbatches with int8 error feedback: the loss, and
    m and the residual as tests/test_torch_train_steps.py holds one
    compressed step's: an element whose int8 code the packages round apart
    moves by one code step (its row's max |g| / 127) in the residual and by
    a tenth of that in m. Here the accumulation's bf16 cast also rounds the
    packages' fp32 sums apart, by one bf16 step (under a code step), so more
    elements move: at most 1e-3 of each tree's elements, counted over the
    whole tree (one element is 5e-4 of a 2,048-element leaf)."""
    jcfg, cfg = jconfigs.get_smoke(QWEN).replace(microbatches=2), configs.get_smoke(QWEN).replace(microbatches=2)
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    jopt, opt = jadamw.AdamW(lr=1e-3), adamw.AdamW(lr=1e-3)
    jfn = jax.jit(jsteps.make_train_step(jcfg, None, jopt, compress_grads=True))
    fn = steps.make_train_step(cfg, opt, compress_grads=True)
    jout, out = (jparams, jopt.init(jparams), None), (params, opt.init(params), None)
    for _ in range(2):
        jout = jfn(jout[0], jout[1], {"tokens": jnp.asarray(tokens)})
        out = fn(out[0], out[1], {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(out[2]["loss"].item(), float(jout[2]["loss"]), rtol=0, atol=1e-5)
    (_, jst, _), (_, st, _) = jout, out
    assert sorted(st) == sorted(jst) == ["ef_residual", "m", "step", "v"]
    for name, step_of in (("m", lambda w: 4 * np.abs(w).max() / 127), ("ef_residual", lambda w: 2 * np.abs(w).max())):
        n_off = n_all = 0
        for g, w in zip(leaves(st[name]), jax.tree.leaves(jst[name])):
            g, w = g.float().numpy(), np.asarray(w, np.float32)
            off = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
            n_off, n_all = n_off + off.sum(), n_all + off.size
            assert np.all(np.abs(g - w)[off] <= step_of(w) + 1e-6), name
        assert n_off <= 1e-3 * n_all, name


# ------------------------------------------------------- resume, checkpoints
def _step4_keys(root):
    mgr = CheckpointManager(Repository(root))
    oid, step = mgr.latest()
    manifest = json.loads(mgr._tree_bytes(oid, f"checkpoints/step_{step:08d}/manifest.json"))
    return step, {p: m["key"] for p, m in manifest["leaves"].items()}


def test_a_resume_across_async_saves_through_the_launcher_is_bit_for_bit(tmp_path, monkeypatch):
    """Phase 43's resume at smoke size: 4 steps of 2 microbatches with one
    sync save, against 3 with async saves at 2 and 3 and a new run to 4
    with an async save. The step-2 save is held writing until step 3 has
    ended (its write waits for the loop's look at it after that step), so
    it is in flight through the whole step."""
    kw = dict(seq_len=16, batch=4, device="cpu", overrides={"microbatches": 2})
    unbroken = launch_train.run(QWEN, steps=4, ckpt_every=4, repo=str(tmp_path / "a"), **kw)
    assert unbroken.save_in_flight == [False] * 4 and len(unbroken.save_s) == 1

    writing, step_ended = threading.Event(), threading.Event()
    write, saving = CheckpointManager._write, CheckpointManager.saving

    def held_write(self, step, *a, **k):
        if step == 2:
            writing.set()
            assert step_ended.wait(60)
        return write(self, step, *a, **k)

    def looked_at(self):
        busy = saving(self)
        if writing.is_set():
            step_ended.set()
        return busy

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    monkeypatch.setattr(CheckpointManager, "saving", looked_at)
    root = str(tmp_path / "b")
    first = launch_train.run(QWEN, steps=3, ckpt_every=2, repo=root, async_ckpt=True, **kw)
    second = launch_train.run(QWEN, steps=4, ckpt_every=4, repo=root, async_ckpt=True, **kw)
    assert first.save_in_flight == [False, False, True] and second.save_in_flight == [False]
    assert (first.start_step, second.start_step, second.end_step) == (0, 3, 4)
    assert unbroken.losses == first.losses + second.losses
    assert _step4_keys(str(tmp_path / "a")) == _step4_keys(root)
    assert [s for _, s in CheckpointManager(Repository(root)).checkpoints()] == [4, 3, 2]


def test_a_compressed_checkpoint_resumes_bitwise_and_restores_in_jax(tmp_path):
    """One compressed step of 2 microbatches (bf16 weights, fp32 moments),
    saved; the next step from the restored state equals the next step from
    the live state bit for bit (params, m, v, step and the residual); the
    JAX package restores the saved residual to the same bytes."""
    cfg = configs.get_smoke(QWEN).replace(microbatches=2)
    opt = adamw.AdamW(lr=1e-3)
    fn = steps.make_train_step(cfg, opt, compress_grads=True)
    rng = np.random.default_rng(2)
    b0, b1 = ({"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))}
              for _ in range(2))
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.bfloat16, device="cpu")
    params, state, _ = fn(params, opt.init(params), b0)
    repo = Repository.init(str(tmp_path / "r"))
    oid = CheckpointManager(repo).save(1, params, state)
    saved = {p: v.clone() for p, v in _flatten({"params": params, "opt_state": state}).items()}
    restored, manifest = CheckpointManager(repo).restore(oid, device="cpu")
    assert manifest["leaves"]["opt_state/ef_residual/embed"]["dtype"] == "float32"
    live = fn(params, state, b1)
    again = fn(restored["params"], restored["opt_state"], b1)
    assert live[2]["loss"].item() == again[2]["loss"].item()
    got, want = _flatten({"params": again[0], "opt_state": again[1]}), _flatten({"params": live[0],
                                                                                  "opt_state": live[1]})
    assert sorted(got) == sorted(want) and any(p.startswith("opt_state/ef_residual/") for p in got)
    for p in want:
        assert got[p].dtype == want[p].dtype and torch.equal(got[p].view(-1).view(torch.uint8),
                                                             want[p].view(-1).view(torch.uint8)), p
    jstate, _ = JCheckpointManager(JRepository(repo.root)).restore(oid)
    jflat = _flatten(jstate)
    residual = [p for p in saved if p.startswith("opt_state/ef_residual/")]
    assert len(residual) == len(leaves(params))
    for p in residual:
        assert np.asarray(jflat[p]).tobytes() == saved[p].numpy().tobytes(), p
