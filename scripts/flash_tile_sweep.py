#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel at other tile shapes on the card.

    python3 scripts/flash_tile_sweep.py [--variants 128x128x2,128x128x3,64x64x2]

A variant MxNxS is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
kTileM = M query rows per block (64 or 128: one or two consumer
warpgroups), kTileN = N keys per K/V tile (64 or 128) and kStages = S ring
stages. Each is built with the port's nvcc flags into the git-ignored
``kernels/_build/sweep/``, all at once, held against the plain version and
timed with CUDA events (device time: the calls are queued ahead) at
qwen3's and jamba's serving shapes (bf16, B=8, S=512, causal, Dh=128; H=16
and 64, KV=8), the variants in turns and the turns repeated in reverse
order, beside PyTorch's SDPA. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402

# the wrapper module (the package exports a function of the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

SHAPES = {"qwen3": (8, 512, 16, 8, 128), "jamba": (8, 512, 64, 8, 128)}  # B, S, H, KV, Dh


def variant_source(m: int, n: int, stages: int) -> str:
    src = (build.CSRC / "flash_attention.cu").read_text()
    for name, value in (("kTileM", m), ("kTileN", n), ("kStages", stages)):
        src, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"{name} not found once in flash_attention.cu")
    return src


def build_variants(tags: list[str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{tag: (library, ptxas line of the Dh=128 wgmma instance)}, built in parallel."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag in tags:
        m, n, stages = (int(x) for x in tag.split("x"))
        cu = out_dir / f"flash_{tag}.cu"
        cu.write_text(variant_source(m, n, stages))
        so = cu.with_suffix(".so")
        procs[tag] = (so, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed to build:\n{log}")
        lines = log.splitlines()
        idx = next(i for i, ln in enumerate(lines) if "wgmma_kernelILi128E" in ln and "Compiling" in ln)
        report = " ".join(ln.split("ptxas info    : ")[-1].strip() for ln in lines[idx + 2 : idx + 4])
        libs[tag] = (ctypes.CDLL(str(so)), report)
    return libs


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one call: the stream spins ~10 ms first, so the host
    queues all calls before the events start (as chip_smoke.py times)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="128x128x2,128x128x3,64x64x2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    tags = args.variants.split(",")
    libs = build_variants(tags)
    fa._kernel()  # the port's own library, for its argument types
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times: dict[tuple[str, str], list[float]] = {}
    for shape_name, (b, s, h, kv, d) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        want = ref.attention_ref(q, k, v, True, None).float()
        for rnd, order in enumerate((tags, tags[::-1])):
            for tag in order:
                fn = libs[tag][0].flash_attention_fwd
                fn.argtypes, fn.restype = fa._fn.argtypes, fa._fn.restype
                saved, fa._fn = fa._fn, fn
                try:
                    if rnd == 0:
                        err = (fa.flash_attention_fwd(q, k, v).float() - want).abs()
                        if not bool((err <= 2e-2 + 2e-2 * want.abs()).all()):
                            raise RuntimeError(f"variant {tag} disagrees with the plain version at {shape_name}")
                    times.setdefault((tag, shape_name), []).append(
                        time_ms(lambda: fa.flash_attention_fwd(q, k, v)))
                finally:
                    fa._fn = saved
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        times[("sdpa", shape_name)] = [time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; bf16, B=8, S=512, causal, Dh=128; ms per call (two turns)")
    for tag in tags + ["sdpa"]:
        cells = ", ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in times[(tag, name)]) for name in SHAPES)
        print(f"  {tag:12s} {cells}" + (f"; ptxas Dh=128: {libs[tag][1]}" if tag in libs else ""))


if __name__ == "__main__":
    main()
