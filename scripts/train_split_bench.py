#!/usr/bin/env python3
"""Time a full-width train step with the stacked layer weights split once
per step (``torch.unbind``, what ``models/transformer.py`` does in train
mode) against indexing each repeat out of them (``v[i]``, what it does in
prefill and decode), on one NVIDIA GPU.

    python3 scripts/train_split_bench.py [--arch qwen3_0_6b] [--rounds 2] [--steps 3]

Indexing makes autograd build, for every repeat, a zero-filled gradient of
the whole stacked leaf and add them all up; ``unbind``'s backward is one
stack. Each variant runs ``--steps`` timed steps of ``make_train_step`` (bf16
weights, fp32 moments, remat, B=8 x 512 of ``SyntheticTokens``) after one
warm-up step, in ``--rounds`` rounds of unbind, index, index, unbind in one
process; the gradients of one step (deterministic algorithms) must be
equal between the two.
Prints the card's name and power limit beside the numbers, and a JSON line
of them last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# the gradient check runs with deterministic algorithms, which need cuBLAS's
# fixed workspace, read once when cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of unbind, index, index, unbind")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_grad_fn, make_train_step
    from repro_torch.tree import leaves

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = configs.get(args.arch)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=512, global_batch=8)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    variants = {"unbind": T._repeats, "index": lambda tree, n: [T._at(tree, i) for i in range(n)]}

    # the same gradients either way (deterministic: the embedding's backward adds with atomics)
    params = init_params(T.param_defs(cfg), seed=0, device=dev)
    grads = {}
    torch.use_deterministic_algorithms(True)
    for name, split in variants.items():
        T._repeats = split
        grads[name] = make_grad_fn(cfg)(params, batch)[2]
    torch.use_deterministic_algorithms(False)
    if not all(torch.equal(a, b) for a, b in zip(leaves(grads["unbind"]), leaves(grads["index"]))):
        sys.exit("the two splits give different gradients")
    del grads

    opt = AdamW(lr=1e-3, moment_dtype=cfg.opt_moment_dtype)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    times: dict[str, list[float]] = {name: [] for name in variants}
    order = ["unbind", "index", "index", "unbind"] * args.rounds
    for name in order:
        T._repeats = variants[name]
        params, state, _ = step_fn(params, state, batch)  # warm-up
        for _ in range(args.steps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, state, _ = step_fn(params, state, batch)
            torch.cuda.synchronize(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
    T._repeats = variants["unbind"]
    med = {name: float(np.median(t)) for name, t in times.items()}
    print(f"{args.arch} train step B=8 x 512, in turns {order}: " + "; ".join(
        f"{name} median {med[name]:.3f} ms of {[round(x, 3) for x in t]}" for name, t in times.items())
        + f"; index - unbind {med['index'] - med['unbind']:.3f} ms; {smi}")
    print(json.dumps({"card": smi, "step_ms": times, "median_ms": med}))


if __name__ == "__main__":
    main()
