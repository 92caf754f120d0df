"""Batched serving of a small LM on the PyTorch port: prefill + decode with
KV caches, request batching, and per-request latency stats (the
counterpart of ``examples/serve_batched.py``, on ``repro_torch``).

Runs on CUDA unless ``--device cpu`` is given; on the card every dense
attention layer's prefill goes through the hand-written flash kernel
(``repro_torch/kernels/csrc/flash_attention.cu``). The default is the smoke
config, as in the JAX example; ``--full`` serves the published width and
depth. The weights are random, from seed 0, in bf16.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--requests 8] [--device cpu] [--full]
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step


def serve_batched(cfg, params: dict, prompts: np.ndarray, gen_tokens: int, device) -> dict:
    """Greedy generation of ``gen_tokens`` tokens for each row of
    ``prompts`` [B, S]: one prefill, then ``gen_tokens - 1`` decode steps,
    each bracketed by a device synchronisation. Returns ``tokens`` [B, gen]
    (a CPU tensor), ``prefill_s`` (the first call, warm-up included, as
    the JAX example times it) and ``decode_s`` (one per decode step)."""
    dev = torch.device(device)
    B, S = prompts.shape
    prefill = make_prefill_step(cfg, cache_len=S + gen_tokens)
    step = make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    batch = {"tokens": torch.from_numpy(np.asarray(prompts, np.int64)).to(dev)}
    sync()
    t0 = time.perf_counter()
    caches, logits = prefill(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = greedy_token(cfg, logits)
    generated, lat = [tok], []
    for i in range(gen_tokens - 1):
        sync()
        t0 = time.perf_counter()
        logits, caches = step(params, caches, tok, S + i)
        sync()
        lat.append(time.perf_counter() - t0)
        tok = greedy_token(cfg, logits)
        generated.append(tok)
    return {"tokens": torch.cat(generated, dim=1).cpu(), "prefill_s": t_prefill, "decode_s": lat}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="the published width and depth (default: smoke config)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    B = args.requests
    prompts = rng.integers(0, cfg.vocab_size, (B, args.prompt_len))

    out = serve_batched(cfg, params, prompts, args.gen_tokens, dev)
    t_prefill = out["prefill_s"]
    lat_ms = np.array(out["decode_s"][1:]) * 1e3  # skip the first (warm-up)
    print(f"model          : {cfg.name} ({args.arch})")
    print(f"batch          : {B} requests x {args.prompt_len} prompt tokens")
    print(f"prefill        : {t_prefill*1e3:.1f} ms "
          f"({B*args.prompt_len/t_prefill:.0f} tok/s incl. warm-up)")
    print(f"decode/step    : p50={np.percentile(lat_ms,50):.2f} ms "
          f"p95={np.percentile(lat_ms,95):.2f} ms")
    print(f"throughput     : {B*1e3/np.mean(lat_ms):.0f} tok/s at batch {B}")
    print(f"sample request0: {out['tokens'][0].numpy()[:12]}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
