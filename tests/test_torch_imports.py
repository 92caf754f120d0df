"""The port stands alone: it imports neither jax nor anything of ``repro``,
its configs are copies of the JAX package's, it registers every
architecture of the JAX package, and the layers each family adds build."""
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
# the port's own copies of the reference's jax-free cost model, remote tier and packs
assert {"repro_torch.core.fsio", "repro_torch.core.remote", "repro_torch.core.packs"} <= set(names)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.", "jaxlib")))
import torch.distributed as dist
print(len(names), dist.is_initialized(), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports, and none imports jax or repro, or
    starts a process group (the launch tools' fake one starts only when a
    production mesh is made)."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, env=env, timeout=120, check=True).stdout.split(maxsplit=2)
    n_modules = len([p for p in (SRC / "repro_torch").rglob("*.py") if p.name != "__init__.py"])
    assert int(out[0]) >= n_modules
    assert out[1] == "False"
    assert out[2].strip() == "[]"


def test_core_exports_the_reference_names():
    """``repro_torch.core`` exports ``repro.core``'s names (and ``open``), so
    code written against the reference runs on the port with only the
    package name changed in its imports."""
    import repro.core
    import repro_torch.core

    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
    assert all(hasattr(repro_torch.core, n) for n in [*repro.core.__all__, "open"])


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_config_is_a_copy_of_the_reference(which):
    pytest.importorskip("jax")
    from repro import configs as jconfigs

    get = {"config": (configs.get, jconfigs.get),
           "smoke_config": (configs.get_smoke, jconfigs.get_smoke)}[which]
    for arch in configs.ARCH_IDS:
        ours, ref = get[0](arch), get[1](arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert [dataclasses.asdict(k) for k in ours.pattern] == [
            dataclasses.asdict(k) for k in ref.pattern]
        assert (ours.n_repeats, ours.padded_vocab, ours.param_counts()) == (
            ref.n_repeats, ref.padded_vocab, ref.param_counts())


def test_registry_names_the_roadmap_item_for_unported_archs():
    """No architecture is left unported: the port's registry holds exactly
    the JAX package's, and only an unknown name raises (KeyError)."""
    pytest.importorskip("jax")
    from repro import configs as jconfigs

    assert set(configs.ARCH_IDS) == set(jconfigs.ARCH_IDS) and len(configs.ARCH_IDS) == 10
    for arch in configs.ARCH_IDS:
        assert configs.get(arch).name == jconfigs.get(arch).name
    with pytest.raises(KeyError):
        configs.get("no_such_arch")
    with pytest.raises(KeyError):
        configs.get_smoke("no_such_arch")


def test_moe_layers_build():
    """ROADMAP.md §A item 6 is ported for plain top-k MoE: every layer's
    SwiGLU becomes the router and three stacked expert leaves, under the
    reference's names; with a dense residual (arctic) a fourth subtree,
    ``dense``, holds the SwiGLU beside them."""
    cfg = configs.get_smoke("qwen3_0_6b").replace(moe=MoEConfig(n_experts=4))
    block = T.param_defs(cfg)["blocks"]["p0"]
    assert "ffn" not in block and list(block["moe"]) == ["router", "e_w1", "e_w3", "e_w2"]
    D, F, E, n = cfg.d_model, cfg.d_ff, 4, cfg.n_repeats
    assert [d.shape for d in block["moe"].values()] == [(n, D, E), (n, E, D, F), (n, E, D, F), (n, E, F, D)]
    dense = T.param_defs(cfg.replace(moe=MoEConfig(n_experts=4, dense_residual=True)))["blocks"]["p0"]["moe"]
    assert list(dense) == ["router", "e_w1", "e_w3", "e_w2", "dense"]
    assert [d.shape for d in dense["dense"].values()] == [(n, D, F), (n, D, F), (n, F, D)]


def test_experts_beside_mamba_build():
    """Experts beside Mamba mixers (jamba): a hybrid pattern puts the MoE
    FFN on every ``every_k_layers``-th layer, Mamba or attention alike."""
    cfg = configs.get_smoke("qwen3_0_6b").replace(
        attn_period=4, attn_offset=1, moe=MoEConfig(n_experts=4, every_k_layers=2), n_layers=4)
    blocks = T.param_defs(cfg)["blocks"]
    mixers = [next(k for k in ("mamba", "attn") if k in blocks[f"p{i}"]) for i in range(4)]
    assert mixers == ["mamba", "attn", "mamba", "mamba"]
    assert ["moe" in blocks[f"p{i}"] for i in range(4)] == [False, True, False, True]


@pytest.mark.parametrize("change,added", [
    (dict(enc_dec=True, n_enc_layers=2), {"enc_blocks", "enc_final_norm"}),
    (dict(mrope_sections=(2, 3, 3)), set()),
])
def test_encoder_decoder_and_mrope_layers_build(change, added):
    """ROADMAP.md §A item 7 is ported: the changes that raised before build
    their parameters (an encoder-decoder adds the encoder and each decoder
    layer's cross-attention; M-RoPE adds no weight)."""
    base = T.param_defs(configs.get_smoke("qwen3_0_6b"))
    defs = T.param_defs(configs.get_smoke("qwen3_0_6b").replace(**change))
    assert set(defs) - set(base) == added
    assert ("xattn" in defs["blocks"]["p0"]) == bool(added)


# --------------------------------------------------------------- API parity
OPTION = "an option no caller of the port set, left out under the rule that the port keeps no unused option"
ONE_FS = ("the port runs every store operation on one FS per repository: the FS, its fault plan and its owner "
          "are reached through the repository, not passed")
GONE = "a helper no caller of the port used, left out for the same rule"
# every public parameter or member of repro.core that repro_torch.core lacks:
# {"Name.member": (the reference's parameters the port's counterpart lacks, or MISSING, reason)}
MISSING = "missing"
DEVIATIONS = {
    "AnnexStore.ingest_file": (["chunk_size"], OPTION),
    "RemoteStore.ingest_file": (["chunk_size"], OPTION),
    "RemoteStore.__init__": (["sweep_on_open"], OPTION),
    "FS.dir_entries_snapshot": (MISSING, GONE),
    "FS.write_atomic": (MISSING, "the port publishes through files.write_atomic(fs, path, data), one copy for "
                                 "every store"),
    "FaultPlan.__init__": (["max_fs_retries", "backoff_base_s"],
                           "the retry budget and backoff base are the reference's defaults, constants in the port "
                           "(faults.BACKOFF_BASE_S); " + OPTION),
    "FaultPlan.attach_fs": (["fs"], ONE_FS),
    "FaultPlan.crash_point": (["fs"], ONE_FS),
    "JournalHandle.begin": (["fs", "repro_dir"], ONE_FS),
    "FileLock.beat": (MISSING, GONE),
    "FileLock.break_if_stale": (MISSING, GONE + "; recover() and verify() break stale locks"),
    "JobDB.add_job": (MISSING, GONE + "; add_jobs takes one spec or many"),
    "JobDB.by_slurm_id": (MISSING, GONE),
    "JobDB.heartbeat": (MISSING, GONE),
    "JobDB.set_slurm_id": (MISSING, GONE + "; set_slurm_ids takes one pair or many"),
    "LocalSlurmCluster.__init__": (["sbatch_cost_s", "sacct_cost_s"],
                                   "the charges are the reference's defaults, class constants in the port; "
                                   + OPTION),
    "NetworkFaultModel.revive": (MISSING, "no caller in the reference's tests, examples or gates, nor in the "
                                          "port: a site marked dead stays dead for the model's life"),
    "RemoteStore.mark_available": (MISSING, "as NetworkFaultModel.revive, which it calls"),
    "Repository.annex_fetch_key": (["chunked"], OPTION),
    "Repository.annex_push": (MISSING, "the seed-era push to one store; the port pushes through Session.push "
                                       "(remote.push_keys: chunk by chunk, journaled, resumable)"),
    "Repository.commit_changes": (["parents", "author"], OPTION),
    "Repository.merge_octopus": (["author"], OPTION),
    "Repository.save": (["parents", "author", "allow_empty"], OPTION),
    "Repository.switch": (["checkout"], OPTION),
    "Repository.whereis": (MISSING, GONE + "; whereis_many answers one key or many"),
    "Session.fetch": (["missing_only", "journal"], OPTION),
    "Session.gc": (["delete_loose", "prune_cache", "sweep_chunks"], OPTION),
    "Session.pull": (["journal"], OPTION),
    "Session.push": (["journal"], OPTION),
    "Session.recover": (["close_unsubmitted", "max_tmp_age_s"], OPTION),
    "SlurmScheduler.finish": (["journal"], OPTION + "; the port's finish always journals"),
    "SlurmScheduler.submit_pipeline": (["run_id"], OPTION),
    "open": (["auto_repack_threshold"], OPTION + "; Session(repo, auto_repack_threshold=...) keeps it"),
}


def _parameters(fn) -> list[str] | None:
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _public_members(pkg) -> dict:
    """{"Name" or "Name.member": callable} for every public function, class
    constructor and public method of the names ``pkg.core`` exports."""
    out = {}
    for name in [*pkg.core.__all__, "open"]:
        obj = getattr(pkg.core, name)
        if inspect.isclass(obj):
            out[f"{name}.__init__"] = obj.__init__
            for m, f in inspect.getmembers(obj, callable):
                if not m.startswith("_"):
                    out[f"{name}.{m}"] = f
        elif callable(obj):
            out[name] = obj
    return out


def test_core_takes_the_reference_parameter_names():
    """For every public function, class and method that ``repro.core``
    exports, the port's counterpart exists and takes the reference's
    parameter names, but for the deviations named in ``DEVIATIONS``, each
    with its reason. The list must be exact: a gap closed or opened fails
    here until the list says so. (The port may take more parameters.)"""
    import repro
    import repro_torch

    ref, port = _public_members(repro), _public_members(repro_torch)
    found = {}
    for key, fn in ref.items():
        if key not in port:
            found[key] = MISSING
            continue
        want, got = _parameters(fn), _parameters(port[key])
        if want is not None and got is not None and (lacking := [p for p in want if p not in got]):
            found[key] = lacking
    named = {}
    for key, (params, reason) in DEVIATIONS.items():
        assert reason
        base = key.split("/")[0]
        named[base] = MISSING if params == MISSING else named.get(base, []) + params
    assert {k: sorted(v) if v != MISSING else v for k, v in found.items()} == {
        k: sorted(v) if v != MISSING else v for k, v in named.items()}


_LOAD_EXAMPLE = """
import runpy, sys
runpy.run_path(sys.argv[1])  # defines the example; its main() does not run
print(sorted(m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.", "jaxlib"))))
"""


@pytest.mark.parametrize("example", ["serve_batched_torch.py", "train_campaign_torch.py"])
def test_port_examples_load_neither_jax_nor_repro(example):
    path = SRC.parent / "examples" / example
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _LOAD_EXAMPLE, str(path)], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout
    assert out.strip() == "[]"
