"""A run end to end on the CPU at small widths: the command's refusals, no
JAX in the process, and ``correct`` coming out false for the control and
for each fault a cell can have, with the timed path broken underneath."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from chipbench import compare
from chipbench.drivers import prompt, train
from chipbench.small import ROOT, WIDE, WORKLOADS, run_small, small_cell

COMMAND = [sys.executable, "chipbench/run.py", "--workload", "phi3-train-16x512", "--seed", "2147483659",
           "--seconds", "1", "--trace", "0"]


def test_command_refuses_without_a_card():
    got = subprocess.run(COMMAND, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and "{" not in got.stdout


def test_command_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench")
    got = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and "{" not in got.stdout


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; from chipbench.small import WORKLOADS, run_small, small_cell; "
            "[run_small(small_cell(w)) for w in WORKLOADS]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'}), "
            "'repro_torch' in sys.modules)")
    got = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.split("\n")[-2] == "[] True"


def verdict(cell, numbers):
    return compare.verdict(numbers, cell.limits)[0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload)
    out = run_small(cell, readings=True, variants=("control",))
    assert not verdict(cell, out.variant_numbers["control"])


def prompt_fault(fault):
    real = prompt.make_step

    def make_step(cfg, cache_len):
        step = real(cfg, cache_len)

        def broken(params, tokens):
            b = tokens.shape[0]
            if fault == "norms_ignored":  # a port that leaves the norms' scales out
                params = without_norms(params)
            if fault == "half_batch":  # the second half left out, the first half's answers in its place
                caches, logits, tok = step(params, tokens[: b // 2])
                twice = lambda t: torch.cat([t, t], dim=0)  # noqa: E731
                caches = {p: {k: torch.cat([c, c], dim=1) for k, c in kv.items()} for p, kv in caches.items()}
                return caches, twice(logits), twice(tok)
            caches, logits, tok = step(params, tokens)
            if fault == "state_unchanged":  # the cache comes back as it was made
                caches = {p: {k: torch.zeros_like(c) for k, c in kv.items()} for p, kv in caches.items()}
            if fault == "token_altered":
                tok = (tok + 1) % cfg.vocab_size
            return caches, logits, tok

        return broken

    return make_step


NORMS = ("ln1", "ln2", "final_norm")  # the port's norm scales, by their leaf names
# the faults each kind of cell can have; half_batch where the cell's batch has two halves
FAULTS = {"prompt": ("state_unchanged", "half_batch", "token_altered", "norms_ignored"),
          "train": ("state_unchanged", "half_batch", "answer_altered")}


def cells_and_faults():
    from chipbench import harness

    for w in WORKLOADS:
        traffic = harness.cell(w).traffic
        for fault in FAULTS.get(traffic["kind"], ()):
            if fault != "half_batch" or traffic["batch"] > 1:
                yield w, fault


def without_norms(tree: dict) -> dict:
    return {k: without_norms(v) if isinstance(v, dict) else torch.ones_like(v) if k in NORMS else v
            for k, v in tree.items()}


def train_fault(fault):
    real = train.make_step

    def make_step(cfg, opt):
        step = real(cfg, opt)

        def broken(params, state, batch):
            if fault == "state_unchanged":  # the loss is computed, nothing is updated
                from repro_torch.train.steps import make_grad_fn

                loss, _, _ = make_grad_fn(cfg)(params, batch)
                return params, state, {"loss": loss}
            if fault == "half_batch":
                return step(params, state, {"tokens": batch["tokens"][: batch["tokens"].shape[0] // 2]})
            params, state, m = step(params, state, batch)
            return params, state, {**m, "loss": m["loss"] * 1.01}  # the answer altered where it is produced

        return broken

    return make_step


@pytest.mark.parametrize("workload,fault", list(cells_and_faults()))
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = small_cell(workload, **(WIDE if fault == "token_altered" else {}))
    if cell.traffic["kind"] == "train":
        monkeypatch.setattr(train, "make_step", train_fault(fault))
    else:
        monkeypatch.setattr(prompt, "make_step", prompt_fault(fault))
    out = run_small(cell)
    assert not verdict(cell, out.numbers), out.numbers
