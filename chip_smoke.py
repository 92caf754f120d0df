#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the result lines are printed.
  1. device  — needs CUDA; prints the card, its power limit and versions;
               turns TF32 off for matmuls and convolutions.
  2. build   — builds every CUDA source of the port with nvcc.
  3. kernel  — holds the flash-attention kernel against its plain version
               at the serving shape and the six shapes of the kernel tests,
               and times the kernel, the plain version and PyTorch's SDPA.
  4. serve   — full-width qwen3-0.6B serving (bf16, B=8, 512-token prompts,
               32 generated tokens) through ``repro_torch.launch.serve.run``;
               the kernel must have launched once per layer per prefill.
  5. parity  — full-width fp32 prefill, kernel on against kernel off.
Then one JSON line with the kernels' numbers, the card's name and power
limit, and the final line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 outside the tensor cores
FP32_TOL = 2e-5  # tests/test_kernels.py: fp32 kernel against its reference
BF16_TOL = 2e-2  # tests/test_kernels.py: bf16
PARITY_TOL = 2e-3  # tests/test_pallas_model_parity.py: kernels on vs off, fp32 logits

# (B, Sq, Sk, H, KV, Dh, causal, window): the serving shape, then tests/test_kernels.py:29-38.
SERVE_SHAPE = (8, 512, 512, 16, 8, 128, True, None)
TEST_SHAPES = [
    (2, 128, 128, 4, 4, 64, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 128, 128, 4, 1, 128, True, None),
    (1, 256, 256, 4, 4, 64, True, 64),
    (1, 128, 128, 2, 2, 96, False, None),
    (2, 64, 64, 4, 2, 32, True, 16),
]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype_name: str, elem_bytes: int) -> tuple[float, str]:
    """Least time for causal GQA attention on an H100: each of q, k, v read
    once and o written once, against 4 * Dh flops per unmasked (row, col)
    pair per head (q k^T and p v; the exponentials are not counted)."""
    import numpy as np

    b, sq, sk, h, kv, d, causal, window = shape
    rows = np.arange(sq)
    hi = np.minimum(rows + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(rows - window + 1, 0) if (causal and window) else np.zeros(sq, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4 * d * pairs * b * h
    nbytes = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()

    # ------------------------------------------------------------ 1. device
    t0 = phase("device")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch import configs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.steps import make_prefill_step

    # ------------------------------------------------------------- 2. build
    t0 = phase("build")
    build.build_all()
    for name in build.sources():
        log = build.build_log(name)
        regs = sorted({ln.split("Used ")[1] for ln in log.splitlines() if "Used " in ln})
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        print(f"{name}: {log.splitlines()[0] if log else 'library already built'}; "
              f"ptxas: {regs}; spills: {spills or 'none'}")
    print(f"build phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 3. kernel
    t0 = phase("kernel")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def inputs(shape, dtype):
        b, sq, sk, h, kv, d = shape[:6]
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]

    serve_err = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in [SERVE_SHAPE] + TEST_SHAPES:
            causal, window = shape[6], shape[7]
            q, k, v = inputs(shape, dtype)
            got = flash_attention_fwd(q, k, v, causal=causal, window=window).float()
            torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, causal, window).float()
            err = (got - want).abs().max().item()
            ok = bool(((got - want).abs() <= tol + tol * want.abs()).all())
            print(f"  {str(dtype):15s} {shape}: max_abs_err {err:.3g} (tol {tol}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"flash kernel disagrees with attention_ref at {shape} {dtype}")
            if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                serve_err = err
    q, k, v = inputs(SERVE_SHAPE, torch.bfloat16)
    causal = SERVE_SHAPE[6]
    kernel_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal))
    plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    bound_ms, bound_by = attention_bound_ms(SERVE_SHAPE, "bfloat16", 2)
    print(f"flash_attention_fwd at {SERVE_SHAPE} bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, qt, kt, vt
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------- 4. serve
    t0 = phase("serve")
    cfg = configs.get("qwen3_0_6b")
    flash_attention_fwd.launches = 0
    res = serve.run("qwen3_0_6b", batch=8, prompt_len=512, gen=32, full=True,
                    device=dev, dtype="bfloat16", seed=args.seed)
    launches = flash_attention_fwd.launches
    print(f"serve qwen3_0_6b bf16 B=8 prompt=512 gen=32: prefill {res.prefill_ms:.2f} ms, "
          f"decode p50 {res.decode_p50_ms:.3f} ms p95 {res.decode_p95_ms:.3f} ms, "
          f"{res.tokens_per_s:.1f} tok/s, peak memory {res.peak_memory_bytes / 2**30:.3f} GiB, "
          f"flash launches {launches} over {res.prefills} prefills (warm-up included)")
    if launches != cfg.n_layers * res.prefills:
        fail(f"flash kernel launched {launches} times, expected {cfg.n_layers} per prefill")
    if res.tokens.shape != (8, 32):
        fail(f"tokens of shape {tuple(res.tokens.shape)}, expected (8, 32)")
    if not (0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size):
        fail("a generated token lies outside [0, vocab_size)")
    if not res.logits_finite:
        fail("non-finite logits while serving")
    print(f"serve phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------------ 5. parity
    t0 = phase("parity")
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    cache_len = 512 + 32
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, {"tokens": tokens})
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    logit_err = (l_on - l_off).abs().max().item()
    cache_err = max((c_on["p0"][n] - c_off["p0"][n]).abs().max().item() for n in ("k", "v"))
    first_equal = all(torch.equal(c_on["p0"][n][0], c_off["p0"][n][0]) for n in ("k", "v"))
    print(f"parity fp32 B=2 prompt=512: last logits max_abs_err {logit_err:.3g}, caches "
          f"max_abs_err {cache_err:.3g} (tol {PARITY_TOL}), layer-0 caches bit-equal {first_equal}")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on prefill logits disagree with kernel-off")
    if not first_equal or not all(
        torch.allclose(c_on["p0"][n], c_off["p0"][n], rtol=PARITY_TOL, atol=PARITY_TOL)
        for n in ("k", "v")
    ):
        fail("kernel-on prefill caches disagree with kernel-off")
    del params, c_off, c_on
    print(f"parity phase {time.perf_counter() - t0:.1f} s; all phases {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": launches,
        "launches_per_prefill": launches // res.prefills,
        "max_abs_err": serve_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
