#!/usr/bin/env python3
"""Time qwen3-0.6B's full-width bf16 prefill (B=8, 512-token prompts, a
544-slot cache: chip_smoke.py's phase 5 cell) in two checkouts of the repo,
in turns A, B, B, A, on one GPU.

    python3 scripts/prefill_ab.py DIR_A DIR_B [--reps 30] [--seed 0]

Each turn is a process of its own that puts DIR/src first on its path and
builds that checkout's kernels at first use. It runs two warm-up prefills,
then ``--reps`` timed ones (host clock around each, ending in a
synchronise), and prints one JSON line: the median, 10th and 90th
percentiles in ms, the flash launches per prefill, and the torch version.
Use it for a before/after of a host-side change to the prefill path; the
two turns of each checkout show the spread between processes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.train.steps import make_prefill_step

reps, seed = int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
cfg = configs.get("qwen3_0_6b")
params = init_params(T.param_defs(cfg), seed=seed, dtype=torch.bfloat16, device=dev)
batch = prompt_batch(cfg, 8, 512, seed, dev)
step = make_prefill_step(cfg, cache_len=512 + 32)
for _ in range(2):
    step(params, batch)
torch.cuda.synchronize()
flash_attention_fwd.launches = 0
ms = []
for _ in range(reps):
    t = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
print("AB=" + json.dumps({"median_ms": float(np.median(ms)), "p10_ms": float(np.percentile(ms, 10)),
                         "p90_ms": float(np.percentile(ms, 90)), "flash_per_prefill": flash_attention_fwd.launches / reps,
                         "torch": torch.__version__}))
"""


def turn(checkout: Path, reps: int, seed: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(checkout / "src"), str(reps), str(seed)],
                         capture_output=True, text=True, timeout=900)
    lines = [x for x in out.stdout.splitlines() if x.startswith("AB=")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"the turn in {checkout} failed (exit {out.returncode}):\n{out.stderr[-3000:]}")
    return json.loads(lines[0][3:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    for name, checkout in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        print(json.dumps({"turn": name, "checkout": str(checkout), **turn(checkout.resolve(), args.reps, args.seed)}),
              flush=True)


if __name__ == "__main__":
    main()
