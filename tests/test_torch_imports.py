"""The port stands alone: it imports neither jax nor anything of ``repro``,
its configs are copies of the JAX package's, it registers every
architecture of the JAX package, and the layers each family adds build."""
import dataclasses
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
