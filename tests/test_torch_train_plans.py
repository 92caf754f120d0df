"""The depth cuts of ``chip_smoke.py``'s train cells (phases 41 and 42),
pinned to the one-card planner on the CPU.

Each cell, at the constants the script trains it with (``TRAIN_CELLS``,
``CELL_TRAIN``), must plan ``ok`` on meta tensors (``launch/dryrun.py
--one-card``), leave ``FREE_GIB`` of the card free and plan the flash kernel
twice an attention layer a step (the forward and remat's recompute).
internlm2-20B one layer deeper must not fit, so its cut stays the deepest
that does. The card's torch plans each step again beside its run.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch.dryrun import FREE_GIB, plan_one_card  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _plan(arch: str, cuts: dict) -> dict:
    return plan_one_card(arch, "train_4k", smoke.CELL_TRAIN["batch"], smoke.CELL_TRAIN["seq_len"], cuts)


@pytest.mark.parametrize("arch", list(smoke.TRAIN_CELLS))
def test_the_train_cell_fits_one_card(arch):
    cuts = smoke.TRAIN_CELLS[arch]
    cell = _plan(arch, cuts)
    assert cell["status"] == "ok"
    assert cell["free_bytes"] >= FREE_GIB * 2**30, cell["free_bytes"] / 2**30
    cfg = configs.get(arch).replace(**cuts)
    attn_layers = cfg.n_repeats * sum(kind.mixer == "attn" for kind in cfg.pattern)
    assert cell["kernel_calls"] == {"flash_attention_fwd": 2 * attn_layers}


def test_internlm2_one_layer_deeper_does_not_fit():
    arch = "internlm2_20b"
    deeper = smoke.TRAIN_CELLS[arch]["n_layers"] + 1
    assert deeper < configs.get(arch).n_layers
    cell = _plan(arch, {"n_layers": deeper})
    assert cell["status"] == "ok"
    assert cell["free_bytes"] < FREE_GIB * 2**30
