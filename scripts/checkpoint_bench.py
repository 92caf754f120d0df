#!/usr/bin/env python3
"""Split a full-width checkpoint restore into its stages on one NVIDIA GPU,
and serve from the checkpoint commit in turns with the seed weights.

    python3 scripts/checkpoint_bench.py [--arch qwen3_0_6b] [--reps 3] [--seed 0]

The bf16 weights (initialised from ``--seed`` on the card) are saved once
into a new repository (whole-object tier). Then, ``--reps`` times, every
leaf goes through the calls ``CheckpointManager.restore`` makes for it, one
leaf after another on one thread (``restore`` itself runs them on a pool of
threads), each stage timed on its own: ``Repository.annex_fetch_key`` and
``AnnexStore.read`` (the file's bytes, verified against their key), the
same key check alone again on those bytes (the verify share of the read),
``np.load``, and ``convert.bf16_tensor_from_bits`` onto the card (a host
copy, then the host-to-device copy). Whole-restore save and restore times
are ``chip_smoke.py`` phase 12's. Last, ``serve.run`` at chip_smoke.py's
shape serves the seed weights and the checkpoint in turns (seed,
checkpoint, checkpoint, seed); its tokens must be equal. Prints the card's
name and power limit beside the numbers, and a JSON line of them last.
"""
from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(batch=8, prompt_len=512, gen=32)
STAGES = ("fetch_read_verify", "of_which_verify", "np_load", "convert_to_device")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("checkpoint_bench: torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.convert import bf16_tensor_from_bits
    from repro_torch.core.hashing import verify_annex_key
    from repro_torch.core.repo import Repository
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    params = init_params(T.param_defs(configs.get(args.arch)), seed=args.seed, dtype=torch.bfloat16, device=dev)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    out: dict = {"arch": args.arch, "bytes": n_bytes, "restore_stages_s": []}
    with tempfile.TemporaryDirectory() as root:
        repo = Repository.init(root)
        ckpt = CheckpointManager(repo)
        ckpt.save(1, params, {})
        _, manifest = ckpt.restore(device="cpu")
        for _ in range(args.reps):
            stages = dict.fromkeys(STAGES, 0.0)
            for meta in manifest["leaves"].values():
                t0 = time.perf_counter()
                data = repo.annex_fetch_key(meta["key"]).read(meta["key"])
                t1 = time.perf_counter()
                if not verify_annex_key(meta["key"], data):
                    sys.exit(f"checkpoint_bench: {meta['key']} does not verify")
                t2 = time.perf_counter()
                arr = np.load(io.BytesIO(data))
                t3 = time.perf_counter()
                bf16_tensor_from_bits(arr, dev)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                for k, a, b in zip(STAGES, (t0, t1, t2, t3), (t1, t2, t3, t4)):
                    stages[k] += b - a
            out["restore_stages_s"].append(stages)
        # serving in turns: seed weights, checkpoint, checkpoint, seed weights
        out["serve"] = []
        tokens = []
        for source in ("seed", "checkpoint", "checkpoint", "seed"):
            res = serve.run(args.arch, full=True, device=dev, seed=args.seed,
                            repo=root if source == "checkpoint" else None, **SERVE)
            tokens.append(res.tokens)
            out["serve"].append({"source": source, "prefill_ms": res.prefill_ms,
                                 "decode_p50_ms": res.decode_p50_ms, "decode_p95_ms": res.decode_p95_ms})
            print(f"serve {args.arch} from {source}: prefill {res.prefill_ms:.2f} ms, decode p50 "
                  f"{res.decode_p50_ms:.3f} ms p95 {res.decode_p95_ms:.3f} ms")
    if not all(torch.equal(t, tokens[0]) for t in tokens):
        sys.exit("checkpoint_bench: the four serves gave different tokens")

    def gbps(sec):
        return f"{sec:.3f} s ({n_bytes / sec / 1e9:.3f} GB/s)"

    for stages in out["restore_stages_s"]:
        print(f"{args.arch} bf16, {n_bytes} bytes, restore's per-leaf calls on one thread: "
              + ", ".join(f"{k} {gbps(v)}" for k, v in stages.items()))
    print(smi)
    print(json.dumps({**out, "card": smi}))


def leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
