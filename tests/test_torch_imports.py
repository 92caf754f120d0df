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
ONE_FS = ("the port runs every store operation on one FS per repository: the FS, its fault plan and its owner "
          "are reached through the repository, not passed")
# every public parameter or member of repro.core that repro_torch.core lacks:
# {"Name.member": (the reference's parameters the port's counterpart lacks, or MISSING, reason)}
MISSING = "missing"
DEVIATIONS = {
    "FaultPlan.attach_fs": (["fs"], ONE_FS),
    "FaultPlan.crash_point": (["fs"], ONE_FS),
    "JournalHandle.begin": (["fs", "repro_dir"], ONE_FS),
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


MESH = "a jax Mesh; the port's counterpart takes the ShardingRules (rules=), which carry their DeviceMesh"
PALLAS_LAYOUT = ("the Pallas call in its kernel's own layout; the port's CUDA kernel takes the model's layout "
                 "through its *_fwd wrapper (kernels.ops)")
INTERPRET = ("Pallas's interpret mode; the port's wrapper runs its kernel's plain version on a CPU tensor, so no "
             "flag picks it")
NAIVE = ("a lax.scan oracle; the port's step-by-step oracle is kernels.ref's plain version, which the reference "
         "keeps too")
# every public parameter, function, class or module of the reference's model
# side that the port's counterpart lacks: JAX idiom only, each with its reason
MODEL_DEVIATIONS = {
    "kernels.flash_attention:flash_attention_bhsd": (MISSING, PALLAS_LAYOUT),
    "kernels.rwkv6:rwkv6_bhsd": (MISSING, PALLAS_LAYOUT),
    "kernels.mamba:mamba_scan_bsd": (MISSING, PALLAS_LAYOUT),
    "kernels.ops:flash_attention": (["interpret"], INTERPRET),
    "kernels.ops:rwkv6": (["interpret"], INTERPRET),
    "kernels.ops:mamba_scan": (["interpret"], INTERPRET),
    "models.attention:attention": (["unroll_chunks"], "how XLA traces the query-chunk loop (unrolled or "
                                                      "lax.map); eager PyTorch runs it as a Python loop"),
    "models.params:abstract_params": (["mesh"], MESH),
    "models.params:param_shardings": (["mesh"], MESH),
    "models.ssm:rwkv6_naive": (MISSING, NAIVE),
    "models.ssm:mamba_scan_naive": (MISSING, NAIVE),
    "models.transformer:abstract_cache": (["mesh"], MESH),
    "models.transformer:Ctx.__init__": (["aux"], "jit collects the MoE layers' aux losses in the Ctx; the port's "
                                                 "apply_block returns each layer's"),
    "models.transformer:apply_block": (["rules"], "the port's Ctx carries the rules (Ctx.rules)"),
    "launch.dryrun:run_cell": (["keep_hlo"], "keeps XLA's compiled HLO text; the port plans from meta tensors, "
                                             "with no HLO"),
    "launch.hlo_stats": (MISSING, "statistics of XLA's HLO text; the port counts a plan's ops with "
                                  "launch.op_stats"),
    "launch.specs:batch_specs": (["mesh"], MESH),
    "launch.specs:decode_specs": (["mesh"], MESH),
    "launch.specs:input_specs": (["mesh"], MESH),
    "launch.specs:model_state_specs": (["mesh"], MESH),
}
MODEL_SIDE = ["configs", "kernels", "models", "launch", "train", "optim"]


def _model_modules(pkg) -> list[str]:
    """The model side's packages of ``pkg`` and their modules, as dotted
    names below ``pkg``."""
    import importlib
    import pkgutil

    out = []
    for top in MODEL_SIDE:
        out.append(top)
        out += [f"{top}.{m.name}" for m in pkgutil.iter_modules(importlib.import_module(f"{pkg}.{top}").__path__)]
    return out


def _module_members(mod) -> dict:
    """{"name" or "Class.member": callable} for every public callable a
    module defines (functions, custom-gradient wrappers, classes and their
    public methods)."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or not callable(obj) or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            out[f"{name}.__init__"] = obj.__init__
            out.update({f"{name}.{m}": f for m, f in inspect.getmembers(obj, callable) if not m.startswith("_")})
        else:
            out[name] = obj
    return out


def test_model_side_takes_the_reference_parameter_names():
    """For every public function, class and method of the reference's
    ``configs``, ``kernels``, ``models``, ``launch``, ``train`` and ``optim``
    modules, the port's module and counterpart exist and take the
    reference's parameter names, but for the JAX idiom named in
    ``MODEL_DEVIATIONS``, each with its reason. The list must be exact, as
    the core's is. (The port may take more parameters and have more
    modules.)"""
    import importlib

    from repro.train.checkpoint import CheckpointManager as JCheckpointManager
    from repro_torch.train.checkpoint import CheckpointManager

    port_modules = set(_model_modules("repro_torch"))
    found = {}
    for name in _model_modules("repro"):
        if name not in port_modules:
            found[name] = MISSING
            continue
        ref = _module_members(importlib.import_module(f"repro.{name}"))
        port = _module_members(importlib.import_module(f"repro_torch.{name}"))
        for key, fn in ref.items():
            if key not in port:
                found[f"{name}:{key}"] = MISSING
                continue
            want, got = _parameters(fn), _parameters(port[key])
            if want is not None and got is not None and (lacking := [p for p in want if p not in got]):
                found[f"{name}:{key}"] = lacking
    assert all(reason for _, reason in MODEL_DEVIATIONS.values())
    assert found == {k: params for k, (params, _) in MODEL_DEVIATIONS.items()}
    # the checkpoint manager's two constructor parameters, with the reference's defaults
    for cls in (CheckpointManager, JCheckpointManager):
        sig = inspect.signature(cls.__init__).parameters
        assert (sig["subdir"].default, sig["fetch_workers"].default) == ("checkpoints", 8)


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
