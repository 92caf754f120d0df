#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the result lines are printed.
  1. device       — needs CUDA; prints the card, its power limit and versions;
                    turns TF32 off for matmuls and convolutions.
  2. build        — builds every CUDA source of the port with nvcc, all at once,
                    and prints each one's ptxas registers and spills.
  3. kernel flash — holds the flash-attention kernel against its plain version
                    at the serving shape and the six shapes of the kernel tests,
                    and times the kernel, the plain version and PyTorch's SDPA.
  4. kernel rwkv6 — holds the RWKV6 WKV kernel against its plain version at the
                    serving shape, the three shapes of the kernel tests and a
                    ragged length, fp32 and bf16, and times the kernel and the
                    plain version (no single PyTorch call computes the recurrence).
  5. serve qwen3  — full-width qwen3-0.6B serving (bf16, B=8, 512-token prompts,
                    32 generated tokens) through ``repro_torch.launch.serve.run``;
                    the flash kernel must have launched once per layer per prefill.
  6. parity qwen3 — full-width fp32 prefill, kernel on against kernel off.
  7. serve rwkv6  — full-width rwkv6-1.6B serving, the same shape; the RWKV6
                    kernel must have launched once per layer per prefill.
  8. parity rwkv6 — full-width fp32 prefill, B=2 x 512, kernel on against off
                    (the chunked plain path): last logits and every layer's state.
Then one JSON line with the kernels' numbers, the card's name and power
limit, and the final line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 outside the tensor cores
FP32_TOL = 2e-5  # tests/test_kernels.py: fp32 kernel against its reference
BF16_TOL = 2e-2  # tests/test_kernels.py: bf16
STATE_TOL = {"float32": 1e-4, "bfloat16": 3e-3}  # tests/test_kernels.py:110-111: the WKV state
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
# (B, S, H, Dh): rwkv6-1.6B's serving shape, tests/test_kernels.py:94-95, a ragged length.
RWKV_SERVE_SHAPE = (8, 512, 32, 64)
RWKV_SHAPES = [RWKV_SERVE_SHAPE, (2, 64, 2, 32), (1, 128, 4, 64), (1, 32, 1, 128), (2, 40, 4, 16)]
SERVE = dict(batch=8, prompt_len=512, gen=32)


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


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """(least ms on an H100, what sets it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    return bound(nbytes, flops, dtype_name)


def rwkv6_bound_ms(r, u, state0) -> tuple[float, str]:
    """Least time for the WKV recurrence on an H100: r, k, v, logw, u and
    state0 read once, out and the final state written once, against the TPU
    kernel's four fp32 products, 4 (L Dh + Dh^2) flops per step per (b, h)
    with L = 16 (at S = 512 the same count as the plain recurrence's
    5 Dh^2 per step), at the fp32 rate of the CUDA cores."""
    b, s, h, d = r.shape
    nbytes = 5 * r.numel() * r.element_size() + u.numel() * u.element_size() + 4 * b * h * d * d
    if state0 is not None:
        nbytes += state0.numel() * 4
    return bound(nbytes, 4 * (16 * d + d * d) * b * h * s, "float32")


def ptxas_report(log: str) -> list[str]:
    """'<dtype> Dh=<d>: <n> registers[, <b> B spilled]' per kernel instantiation
    in nvcc's -Xptxas -v report."""
    out, inst, spilled = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"kernelI(.*?)E+v", ln)
            inst = m.group(1).replace("13__nv_bfloat16", "bf16 ").replace("Li", "Dh=") if m else ln
            inst = "fp32 " + inst[1:] if inst.startswith("fDh=") else inst
            spilled = ""
        elif inst and "bytes spill stores" in ln:
            n = int(ln.split(" bytes spill stores")[0].split(",")[-1])
            spilled = f", {n} B spilled" if n else ""
        elif inst and "Used " in ln:
            out.append(f"{inst}: {ln.split('Used ')[1].split(' registers')[0]} registers{spilled}")
            inst = None
    return out


def check_close(torch, name: str, got, want, tol: float) -> float:
    """Max abs error; fails unless |got - want| <= tol + tol |want| everywhere."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
        fail(f"{name}: max_abs_err {err:.3g} above tol {tol}")
    return err


def serve_phase(torch, serve, configs, arch: str, counter, dev, seed: int):
    """Serve at full width with the kernel's count set to 0 just before and
    read just after; fails unless it launched once per layer per prefill."""
    cfg = configs.get(arch)
    counter.launches = 0
    res = serve.run(arch, full=True, device=dev, dtype="bfloat16", seed=seed, **SERVE)
    launches = counter.launches
    print(f"serve {arch} bf16 B=8 prompt=512 gen=32: prefill {res.prefill_ms:.2f} ms, "
          f"decode p50 {res.decode_p50_ms:.3f} ms p95 {res.decode_p95_ms:.3f} ms, "
          f"{res.tokens_per_s:.1f} tok/s, peak memory {res.peak_memory_bytes / 2**30:.3f} GiB, "
          f"{counter.__name__} launches {launches} over {res.prefills} prefills (warm-up included)")
    if launches == 0 or launches != cfg.n_layers * res.prefills:
        fail(f"{counter.__name__} launched {launches} times, expected {cfg.n_layers} per prefill")
    if res.tokens.shape != (SERVE["batch"], SERVE["gen"]):
        fail(f"tokens of shape {tuple(res.tokens.shape)}, expected (8, 32)")
    if not (0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size):
        fail("a generated token lies outside [0, vocab_size)")
    if not res.logits_finite:
        fail("non-finite logits while serving")
    return cfg, res, launches


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
    from repro_torch.kernels.rwkv6 import rwkv6_fwd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.steps import make_prefill_step

    # ------------------------------------------------------------- 2. build
    t0 = phase("build")
    build.build_all()
    for name in build.sources():
        log = build.build_log(name)
        print(f"{name}: {log.splitlines()[0] if log else 'library already built'}; ptxas: "
              + "; ".join(ptxas_report(log)))
    print(f"build phase {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # ------------------------------------------------------ 3. kernel flash
    t0 = phase("kernel flash")

    def inputs(shape, dtype):
        b, sq, sk, h, kv, d = shape[:6]
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]

    flash_err = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape in [SERVE_SHAPE] + TEST_SHAPES:
            causal, window = shape[6], shape[7]
            q, k, v = inputs(shape, dtype)
            got = flash_attention_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = check_close(torch, f"flash_attention_fwd {shape} {dtype}", got,
                              ref.attention_ref(q, k, v, causal, window), tol)
            print(f"  {str(dtype):15s} {shape}: max_abs_err {err:.3g} (tol {tol}) ok")
            if shape == SERVE_SHAPE and dtype == torch.bfloat16:
                flash_err = err
    q, k, v = inputs(SERVE_SHAPE, torch.bfloat16)
    causal = SERVE_SHAPE[6]
    flash_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=causal))
    flash_plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_library_ms = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    flash_bound_ms, flash_bound_by = attention_bound_ms(SERVE_SHAPE, "bfloat16", 2)
    print(f"flash_attention_fwd at {SERVE_SHAPE} bf16: kernel {flash_ms:.4f} ms, plain "
          f"{flash_plain_ms:.4f} ms, SDPA {flash_library_ms:.4f} ms, "
          f"bound {flash_bound_ms:.4f} ms ({flash_bound_by})")
    del q, k, v, qt, kt, vt
    print(f"kernel flash phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 4. kernel rwkv6
    t0 = phase("kernel rwkv6")

    def rwkv_inputs(shape, dtype):
        """tests/test_kernels.py's inputs: logw = -|N(0, 1)| - 0.05 in the
        dtype, u fp32, state0 ~ N(0, 0.3) fp32 (None at the ragged length)."""
        b, s, h, d = shape
        r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        logw = (-torch.randn(shape, generator=gen, device=dev).abs() - 0.05).to(dtype)
        u = torch.randn((h, d), generator=gen, device=dev)
        s0 = (0.3 * torch.randn((b, h, d, d), generator=gen, device=dev)) if s % 16 == 0 else None
        return r, k, v, logw, u, s0

    rwkv_err = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        for shape in RWKV_SHAPES:
            args_ = rwkv_inputs(shape, dtype)
            out, state = rwkv6_fwd(*args_)
            torch.cuda.synchronize()
            want_out, want_state = ref.rwkv6_ref(*args_)
            err = check_close(torch, f"rwkv6_fwd out {shape} {dtype}", out, want_out, tol)
            state_err = check_close(torch, f"rwkv6_fwd state {shape} {dtype}", state, want_state,
                                    STATE_TOL[dname])
            print(f"  {str(dtype):15s} {shape}: out max_abs_err {err:.3g} (tol {tol}), state "
                  f"{state_err:.3g} (tol {STATE_TOL[dname]}) ok")
            if shape == RWKV_SERVE_SHAPE and dtype == torch.bfloat16:
                rwkv_err = err
    args_ = rwkv_inputs(RWKV_SERVE_SHAPE, torch.bfloat16)
    rwkv_ms = time_ms(torch, lambda: rwkv6_fwd(*args_))
    rwkv_plain_ms = time_ms(torch, lambda: ref.rwkv6_ref(*args_), iters=3, warmup=1)
    rwkv_bound_ms, rwkv_bound_by = rwkv6_bound_ms(args_[0], args_[4], args_[5])
    print(f"rwkv6_fwd at {RWKV_SERVE_SHAPE} bf16: kernel {rwkv_ms:.4f} ms, plain "
          f"{rwkv_plain_ms:.4f} ms, bound {rwkv_bound_ms:.4f} ms ({rwkv_bound_by}); "
          f"no single PyTorch call computes it")
    del args_
    print(f"kernel rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 5. serve qwen3
    t0 = phase("serve qwen3")
    cfg, qwen_res, flash_launches = serve_phase(
        torch, serve, configs, "qwen3_0_6b", flash_attention_fwd, dev, args.seed)
    print(f"serve qwen3 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 6. parity qwen3
    t0 = phase("parity qwen3")
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
    print(f"parity qwen3 fp32 B=2 prompt=512: last logits max_abs_err {logit_err:.3g}, caches "
          f"max_abs_err {cache_err:.3g} (tol {PARITY_TOL}), layer-0 caches bit-equal {first_equal}")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on prefill logits disagree with kernel-off")
    if not first_equal or not all(
        torch.allclose(c_on["p0"][n], c_off["p0"][n], rtol=PARITY_TOL, atol=PARITY_TOL)
        for n in ("k", "v")
    ):
        fail("kernel-on prefill caches disagree with kernel-off")
    del params, c_off, c_on
    print(f"parity qwen3 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------- 7. serve rwkv6
    t0 = phase("serve rwkv6")
    cfg, rwkv_res, rwkv_launches = serve_phase(
        torch, serve, configs, "rwkv6_1_6b", rwkv6_fwd, dev, args.seed)
    print(f"serve rwkv6 phase {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 8. parity rwkv6
    t0 = phase("parity rwkv6")
    cfg32 = cfg.replace(use_pallas="off")
    params = init_params(T.param_defs(cfg32), seed=args.seed, dtype=torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    c_off, l_off = make_prefill_step(cfg32, cache_len)(params, {"tokens": tokens})
    rwkv6_fwd.launches = 0
    c_on, l_on = make_prefill_step(cfg32.replace(use_pallas="on"), cache_len)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    if rwkv6_fwd.launches != cfg.n_layers:
        fail(f"kernel-on prefill launched rwkv6_fwd {rwkv6_fwd.launches} times, expected {cfg.n_layers}")
    logit_err = (l_on - l_off).abs().max().item()
    state_err = {n: (c_on["p0"][n] - c_off["p0"][n]).abs().max().item()
                 for n in ("wkv", "shift_t", "shift_c")}
    print(f"parity rwkv6 fp32 B=2 prompt=512: last logits max_abs_err {logit_err:.3g}, "
          f"max_abs_err over the {cfg.n_layers} layers: "
          + ", ".join(f"{n} {e:.3g}" for n, e in state_err.items()) + f" (tol {PARITY_TOL})")
    if not bool(torch.isfinite(l_on).all()):
        fail("kernel-on rwkv6 prefill logits are not finite")
    if not torch.allclose(l_on, l_off, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail("kernel-on rwkv6 prefill logits disagree with kernel-off")
    for n in state_err:
        if not torch.allclose(c_on["p0"][n], c_off["p0"][n], rtol=PARITY_TOL, atol=PARITY_TOL):
            fail(f"kernel-on rwkv6 prefill {n} disagrees with kernel-off")
    del params, c_off, c_on
    print(f"parity rwkv6 phase {time.perf_counter() - t0:.1f} s; "
          f"all phases {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": flash_launches,
        "launches_per_prefill": flash_launches // qwen_res.prefills,
        "max_abs_err": flash_err,
        "ms": flash_ms,
        "plain_ms": flash_plain_ms,
        "bound_ms": flash_bound_ms,
        "bound_by": flash_bound_by,
        "library_ms": flash_library_ms,
    }, {
        "name": "rwkv6_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6.py:24",
        "launches": rwkv_launches,
        "launches_per_prefill": rwkv_launches // rwkv_res.prefills,
        "max_abs_err": rwkv_err,
        "ms": rwkv_ms,
        "plain_ms": rwkv_plain_ms,
        "bound_ms": rwkv_bound_ms,
        "bound_by": rwkv_bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
