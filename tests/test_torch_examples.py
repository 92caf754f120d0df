"""The port's counterparts of two examples of the JAX package, held against
those examples on the CPU.

- ``examples/serve_batched_torch.py``: its ``serve_batched`` at smoke size,
  on qwen3 weights JAX initialised (fp32, seed 0) and converted leaf by
  leaf, makes the greedy tokens of the JAX example's prefill and decode
  loop on the same weights and prompts, exactly (the bar
  ``tests/test_torch_serve.py`` holds qwen3's serving to). Its command line
  on ``--device cpu`` prints the JAX example's lines and ``OK``.
- ``examples/train_campaign_torch.py`` on the CPU prints the JAX example's
  lines with oids and paths masked and the modelled seconds apart. The
  saved leaves are the JAX example's bytes (equal annex keys). The
  modelled seconds are the JAX example's plus 2 ms for each metadata
  operation the port adds: two for each file it publishes through a tmp
  and a rename (ROADMAP §A item 2.6), one for each restored leaf's key
  probe, less the annex sweep the reference runs when it opens a
  repository. ``chip_smoke.py``'s phase 39 holds the card's run to this
  run's seconds.
"""
import contextlib
import importlib.util
import io
import os
import re
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.train.steps import make_decode_step as jax_decode_step  # noqa: E402
from repro.train.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import fsio  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
B, S, GEN = 8, 64, 32  # the JAX example's defaults


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(path: Path, argv: list[str], patch=None) -> str:
    """Run an example's ``__main__`` in this process; returns its stdout."""
    out, old = io.StringIO(), sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(out), (patch or contextlib.nullcontext)():
            runpy.run_path(str(path), run_name="__main__")
    except SystemExit as e:
        assert not e.code
    finally:
        sys.argv = old
    return out.getvalue()


def _labels(text: str) -> list[str]:
    return [line.split(":")[0] for line in text.splitlines()]


def test_serve_batched_gives_the_jax_example_s_tokens():
    jcfg = jconfigs.get_smoke("qwen3_0_6b")
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    # the JAX example's loop (examples/serve_batched.py:33-60), on fp32 weights
    prefill = jax.jit(jax_prefill_step(jcfg, None, cache_len=S + GEN))
    step = jax.jit(jax_decode_step(jcfg, None))
    caches, logits = prefill(jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    tok = jnp.argmax(logits[:, : jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(GEN - 1):
        logits, caches = step(jparams, caches, tok, jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(logits[:, : jcfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    ex = _load("serve_batched_torch")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    got = ex.serve_batched(configs.get_smoke("qwen3_0_6b"), params, prompts, GEN, "cpu")
    assert got["tokens"].shape == (B, GEN) and len(got["decode_s"]) == GEN - 1 and got["prefill_s"] > 0
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def test_serve_batched_prints_the_jax_example_s_lines():
    args = ["--requests", "2", "--prompt-len", "16", "--gen-tokens", "4"]
    ref = _run(EXAMPLES / "serve_batched.py", args)
    port = _run(EXAMPLES / "serve_batched_torch.py", [*args, "--device", "cpu"])
    assert _labels(port) == _labels(ref) and port.splitlines()[-1] == "OK"
    assert port.splitlines()[:2] == ref.splitlines()[:2]  # the model and the batch


def _masked(text: str) -> list[str]:
    text = re.sub(r"\b[0-9a-f]{12}\b|\b[0-9a-f]{8}\b", "<oid>", text)
    text = re.sub(r"/\S*repro_campaign_\S*/project", "<root>", text)
    return [line for line in text.splitlines() if "modeled FS time" not in line]


def _clocks(mod):
    """Record every ``SimClock`` made while the block runs."""
    made = []
    plain = mod.SimClock

    class Recorded(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    @contextlib.contextmanager
    def patch():
        mod.SimClock = Recorded
        try:
            yield
        finally:
            mod.SimClock = plain

    return made, patch


def _counting(mod, name: str):
    """Count calls of ``mod.FS.<name>`` while the block runs."""
    calls = []
    plain = getattr(mod.FS, name)

    @contextlib.contextmanager
    def patch():
        def counted(self, *a, **kw):
            calls.append(a[0])
            return plain(self, *a, **kw)

        setattr(mod.FS, name, counted)
        try:
            yield
        finally:
            setattr(mod.FS, name, plain)

    return calls, patch


def test_train_campaign_prints_the_jax_example_s_lines_and_seconds(monkeypatch):
    ref_clocks, ref_patch = _clocks(jfsio)
    ref_renames, ref_count = _counting(jfsio, "rename")
    port_clocks, port_patch = _clocks(fsio)
    port_renames, port_count = _counting(fsio, "rename")

    def both(a, b):
        @contextlib.contextmanager
        def patch():
            with a(), b():
                yield
        return patch

    ref = _run(EXAMPLES / "train_campaign.py", [], both(ref_patch, ref_count))
    port = _run(EXAMPLES / "train_campaign_torch.py", ["--device", "cpu"], both(port_patch, port_count))
    assert _masked(port) == _masked(ref) and port.splitlines()[-1] == "== OK"
    (rc,), (pc,) = ref_clocks, port_clocks
    assert (pc.bytes_read, abs(pc.bytes_written - rc.bytes_written) <= 16) == (rc.bytes_read, True)
    published = len(port_renames) - len(ref_renames)  # files the port publishes through a tmp and a rename
    restored_leaves = 4
    assert pc.meta_ops - rc.meta_ops == 2 * published + restored_leaves - 1 == 73
    meta = fsio.GPFS_STRIPED.meta_op_s
    assert pc.total == pytest.approx(rc.total + meta * (pc.meta_ops - rc.meta_ops), abs=1e-6)
    # the seconds phase 39 holds the card's run to
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (pc.meta_ops, pc.total) == (smoke.CAMPAIGN_EXAMPLE["meta_ops"],
                                       pytest.approx(smoke.CAMPAIGN_EXAMPLE["modelled_s"], abs=1e-6))


def test_train_campaign_restores_onto_the_device_it_was_asked_for():
    ex = _load("train_campaign_torch")
    with tempfile.TemporaryDirectory() as work, contextlib.redirect_stdout(io.StringIO()):
        out = ex.campaign(work, "cpu")
    embed = out["state"]["params"]["embed"]
    assert embed.dtype == torch.bfloat16 and embed.device.type == "cpu"
    assert ex.bf16_bits(embed) == out["saved_embed"] and [s for _, s in out["checkpoints"]] == [3, 2, 1]
    assert out["ingested_mib"][0] > 5 * max(out["ingested_mib"][1:])  # later saves write only the churn
    assert os.path.basename(out["manifest"]["leaves"]["params/embed"]["file"]).endswith(".npy")
