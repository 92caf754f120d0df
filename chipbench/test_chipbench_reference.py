"""The plain references against the port, both in fp32 on the CPU at small
widths: the port's prefill logits and KV cache (dense and MoE, the
capacity queue dropping choices) and its train step (three AdamW steps),
through the harness as a run judges them. Also the references' imports
and the fp8 rounding of the control."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from chipbench.reference import dense
from chipbench.small import ROOT, run_small, small_cell


@pytest.mark.parametrize("workload", ["phi3-prompt-16x1024", "mixtral-8l-prompt-1x8192"])
def test_reference_matches_port_prefill_in_fp32(workload):
    out = run_small(small_cell(workload, torch_dtype="float32"), readings=True)
    assert out.numbers["kv_err"] < 2e-6 and out.numbers["logit_err"] < 2e-6 and out.numbers["logit_med"] < 2e-6
    assert out.numbers["token_gap"] == 0.0 and out.numbers["served_gap"] == 0.0


def test_moe_reference_drops_choices_as_the_port_does():
    """At capacity 1.25 some expert's queue overflows in every layer of this prompt."""
    from chipbench import harness
    from chipbench.reference import moe

    cell = small_cell("mixtral-8l-prompt-1x8192", torch_dtype="float32")
    cfg = harness.model_config(cell.config)
    w = harness.layers(cfg, harness.make_weights(cfg, 3, torch.device("cpu")))
    h = torch.randn(1, 40, 64, generator=torch.Generator().manual_seed(0))
    _, experts = moe.route(h[0], w["layers"][0]["router"], cell.config, dense.Arith())
    assert torch.bincount(experts.reshape(-1), minlength=8).max() > int(1.25 * 40 * 2 / 8)
    from repro_torch.models.moe import moe_ffn

    ref = moe.expert_ffn(h, w["layers"][0], cell.config, dense.Arith())
    port, _ = moe_ffn(h, *(w["layers"][0][k] for k in ("router", "e_w1", "e_w3", "e_w2")), cfg.moe)
    assert torch.allclose(ref, port, rtol=1e-5, atol=1e-6)


def test_reference_matches_port_train_steps_in_fp32():
    out = run_small(small_cell("phi3-train-16x512", torch_dtype="float32"), readings=True)
    assert out.numbers["loss_gap"] < 1e-5
    assert out.numbers["grad_gap"] < 1e-4 and out.numbers["change_gap"] < 1e-3


def test_references_import_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import chipbench.reference.dense, chipbench.reference.moe; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    got = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    assert got.stdout.strip() == "[]"


def test_fp8_rounding_of_the_control():
    x = torch.tensor([448.0, 1.0, 1.0625, 0.0])
    assert torch.equal(dense.to_fp8(x), torch.tensor([448.0, 1.0, 1.0, 0.0]))  # 3 mantissa bits
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    assert 0.01 < (dense.Arith("fp8").mm(a, a) - a @ a).norm() / (a @ a).norm() < 0.1
