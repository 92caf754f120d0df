#!/usr/bin/env python3
"""Time the bf16 Mamba selective-scan and RWKV6 WKV kernels at other
compiled-in constants, and the Mamba kernel with parts of its work taken
out, on the card.

    python3 scripts/scan_sweep.py [--mamba P0B5,P1B5,P0B5-noexp]
                                  [--rwkv6 C64P4,C32P4] [--batches 1,2,4,8]
                                  [--baseline DIR]

A Mamba variant PpBb[-edit] is ``src/repro_torch/kernels/csrc/mamba.cu``
with kMinBlocks = b blocks per SM in the register cap, and with p eighths of
each channel's states (fixed indices) taking their decay from EXP2_POLY
below, a polynomial on the FMA pipe, instead of ex2.approx on the SFU (the
kernel itself has no such share: it lost at every p). An optional edit takes
work out, and the variant is then timed only, since its results are wrong:
  noexp    e = x: no exponential (no SFU work)
  nobc     B and C are constants: no shared-memory reads of them
  nostore  y is not written
  noscan   no state update and no y sum: loads, barriers and stores only
An RWKV6 variant CcPp is ``csrc/rwkv6.cu`` with kColsPerBlock = c value
columns per block (one mma warp each 16) and kPrepWarps = p warps that load
and prepare the next chunk.
``--baseline DIR`` adds DIR/mamba.cu and DIR/rwkv6.cu (for example an
earlier commit's sources, unpacked with ``git archive``) as the variant
"base", so two versions are compared within one run.
Each variant is built with the port's nvcc flags into the git-ignored
``kernels/_build/sweep/``, all at once, held against the plain version and
timed with CUDA events (device time: the calls are queued ahead) at the
serving shapes, bf16: Mamba B=8, S=512, Di=16384, St=16 with B and C as
strided views of one projection and no h0 (jamba's prefill); RWKV6 B=8,
S=512, H=32, Dh=64 with an fp32 state0 (rwkv6-1.6B's). The variants run in
turns, and the turns are repeated in reverse order. ``--batches`` then
times the Mamba kernel as it is at other batch sizes (128 blocks a batch
row, so the grid's waves over the SMs change while the work per block does
not), and at B=8 reads nvidia-smi's SM clock and power draw while it runs
back to back. Needs one CUDA device and nvcc.
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

# the wrapper modules (the package exports functions of the same names)
WRAPPERS = {"mamba": importlib.import_module("repro_torch.kernels.mamba"),
            "rwkv6": importlib.import_module("repro_torch.kernels.rwkv6")}
ENTRY = {"mamba": "mamba_scan_fwd", "rwkv6": "rwkv6_fwd"}
INSTANCE = {"mamba": "mamba_scan_bf16_kernelILi16E", "rwkv6": "rwkv6_chunk_kernelILi64E"}
QUEUE_AHEAD_CYCLES = 20_000_000

# 2^x on the FMA pipe, as FlashAttention-3 computes it: x clamped to
# [-126, 127] (it saturates where ex2.approx.ftz flushes to 0 or overflows),
# rounded to n + f with |f| <= 1/2 by the 1.5 * 2^23 add, a degree-5 minimax
# polynomial for 2^f (relative error 2.1e-7 in fp32, about ex2.approx's), and
# n added into the exponent bits (the shift drops the magic's own bits).
EXP2_POLY = """
__device__ __forceinline__ float exp2_poly(float x) {
  x = fminf(fmaxf(x, -126.f), 127.f);
  const float j = __fadd_rn(x, 12582912.f);
  const float f = __fsub_rn(x, __fsub_rn(j, 12582912.f));
  float q = fmaf(0x1.5c08e4p-10f, f, 0x1.3d0c54p-7f);
  q = fmaf(q, f, 0x1.c6b6e6p-5f);
  q = fmaf(q, f, 0x1.ebf918p-3f);
  q = fmaf(q, f, 0x1.62e428p-1f);
  q = fmaf(q, f, 0x1.000002p+0f);
  return __int_as_float(__float_as_int(q) + (__float_as_int(j) << 23));
}

template <int ST>
__device__ __forceinline__ float exp2_share(int n, float x) {
  return n < ST * POLY_EIGHTHS / 8 ? exp2_poly(x) : ex2_approx(x);
}

"""
# the bf16 kernel's two decay computations, e[n] = ex2_approx(...) and e[n + m] = ex2_approx(...)
DECAY = re.compile(r"e\[(n(?: \+ m)?)\] = ex2_approx\(")
# (text of the bf16 kernel, its replacement); the bf16 kernel is the last in the file
EDITS = {
    "nobc": ("        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[k][n]);\n"
             "        const float4 c4 = *reinterpret_cast<const float4*>(&c_s[k][n]);\n",
             "        const float4 b4 = make_float4(0.5f, 0.25f, 0.125f, 1.f), c4 = b4;\n"),
    "nostore": ("      y_s[cur][k][tid] = *reinterpret_cast<const uint16_t*>(&yb);\n", ""),
    "noscan": ("#pragma unroll\n      for (int n = 0; n < ST; n += 4) {\n",
               "#pragma unroll\n      for (int n = 0; n < 0; n += 4) {\n"),
}


def set_constant(src: str, name: str, value: int) -> str:
    src, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
    if count != 1:
        raise RuntimeError(f"{name} not found once")
    return src


def sub_decays(src: str, repl: str) -> str:
    src, count = DECAY.subn(repl, src)
    if count != 2:
        raise RuntimeError(f"found {count} decay computations in mamba.cu, not 2")
    return src


def mamba_source(tag: str) -> str:
    m = re.fullmatch(r"P(\d)B(\d+)(?:-(noexp|nobc|nostore|noscan))?", tag)
    if not m:
        raise SystemExit(f"Mamba variant {tag!r} is not PpBb[-noexp|-nobc|-nostore|-noscan]")
    poly, blocks, edit = int(m.group(1)), int(m.group(2)), m.group(3)
    src = set_constant((build.CSRC / "mamba.cu").read_text(), "kMinBlocks", blocks)
    if poly:
        anchor = "__device__ __forceinline__ float bf16_bits_to_float"
        src = src.replace(anchor, EXP2_POLY.replace("POLY_EIGHTHS", str(poly)) + anchor, 1)
        src = sub_decays(src, r"e[\1] = exp2_share<ST>(\1, ")
    if edit == "noexp":
        src = sub_decays(src, r"e[\1] = (")
    elif edit:
        old, new = EDITS[edit]
        if old not in src:
            raise RuntimeError(f"edit {edit} does not find its text in mamba.cu")
        head, tail = src.rsplit(old, 1)
        src = head + new + tail
    return src


def rwkv6_source(tag: str) -> str:
    m = re.fullmatch(r"C(\d+)P(\d+)", tag)
    if not m:
        raise SystemExit(f"RWKV6 variant {tag!r} is not CcPp")
    src = set_constant((build.CSRC / "rwkv6.cu").read_text(), "kColsPerBlock", int(m.group(1)))
    return set_constant(src, "kPrepWarps", int(m.group(2)))


def build_variants(kernel: str, tags: list[str], baseline: Path | None) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{tag: (library, ptxas line of the serving instance)}, built in parallel."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    make = mamba_source if kernel == "mamba" else rwkv6_source
    procs = {}
    for tag in tags + (["base"] if baseline else []):
        cu = out_dir / f"{kernel}_{tag}.cu"
        cu.write_text((baseline / f"{kernel}.cu").read_text() if tag == "base" else make(tag))
        so = cu.with_suffix(".so")
        procs[tag] = (so, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel} variant {tag} failed to build:\n{log}")
        lines = log.splitlines()
        idx = next((i for i, ln in enumerate(lines) if INSTANCE[kernel] in ln and "Compiling" in ln), None)
        report = ("" if idx is None else
                  " ".join(ln.split("ptxas info    : ")[-1].strip() for ln in lines[idx + 2 : idx + 4]))
        libs[tag] = (ctypes.CDLL(str(so)), report)
    return libs


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one call: the stream spins ~10 ms first, so the host
    queues all calls before the events start (as chip_smoke.py times)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mamba_inputs(b: int, dev, gen) -> tuple:
    """jamba's prefill at B=b: S=512, Di=16384, St=16; B and C strided views of one projection."""
    s, di, st = 512, 16384, 16
    u = torch.randn((b, s, di), generator=gen, device=dev).bfloat16()
    dt = (0.1 * torch.randn((b, s, di), generator=gen, device=dev).abs()).bfloat16()
    A = -torch.randn((di, st), generator=gen, device=dev).abs()
    dbl = torch.randn((b, s, di // 16 + 2 * st), generator=gen, device=dev).bfloat16()
    return u, dt, A, dbl[..., -2 * st : -st], dbl[..., -st:]


def serving_inputs(kernel: str, dev, gen) -> tuple:
    if kernel == "mamba":
        return mamba_inputs(8, dev, gen)
    shape = (8, 512, 32, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
    logw = (-torch.randn(shape, generator=gen, device=dev).abs() - 0.05).bfloat16()
    u = torch.randn(shape[2:], generator=gen, device=dev)
    s0 = 0.3 * torch.randn((8, 32, 64, 64), generator=gen, device=dev)
    return r, k, v, logw, u, s0


def sweep(kernel: str, tags: list[str], baseline: Path | None, smi: str, dev, gen) -> None:
    libs = build_variants(kernel, tags, baseline)
    order = list(libs)
    mod = WRAPPERS[kernel]
    mod._kernel()  # the port's own library, for its argument types
    wrapper = getattr(mod, ENTRY[kernel])
    inputs = serving_inputs(kernel, dev, gen)
    plain = ref.mamba_ref if kernel == "mamba" else ref.rwkv6_ref
    want = [t.float() for t in plain(*inputs)]
    tols = (2e-2, 1e-3) if kernel == "mamba" else (2e-2, 3e-3)
    times: dict[str, list[float]] = {}
    errs: dict[str, str] = {}
    for rnd, turn in enumerate((order, order[::-1])):
        for tag in turn:
            fn = getattr(libs[tag][0], ENTRY[kernel])
            fn.argtypes, fn.restype = mod._fn.argtypes, mod._fn.restype
            saved, mod._fn = mod._fn, fn
            try:
                if rnd == 0 and "-" in tag:
                    errs[tag] = "timing only"
                elif rnd == 0:
                    got = wrapper(*inputs)
                    found = []
                    for g, w, tol in zip(got, want, tols):
                        err = (g.float() - w).abs()
                        found.append(f"{err.max().item():.3g}")
                        if not bool((err <= tol + tol * w.abs()).all()):
                            raise RuntimeError(f"{kernel} variant {tag} disagrees with the plain version")
                    errs[tag] = "err " + ", ".join(found)
                times.setdefault(tag, []).append(time_ms(lambda: wrapper(*inputs)))
            finally:
                mod._fn = saved
    print(f"card: {smi}; {kernel} bf16 at its serving shape; ms per call (two turns); "
          f"max abs err of (out, state) against the plain version")
    for tag in order:
        print(f"  {kernel} {tag:14s} " + " / ".join(f"{t:.4f}" for t in times[tag])
              + f"; {errs[tag]}; ptxas {libs[tag][1]}")


def batches(sizes: list[int], smi: str, dev, gen) -> None:
    mod = WRAPPERS["mamba"]
    print(f"card: {smi}; mamba bf16 as it is at other batch sizes (128 blocks a batch row), ms per call:")
    for b in sizes:
        inputs = mamba_inputs(b, dev, gen)
        ms = time_ms(lambda: mod.mamba_scan_fwd(*inputs))
        print(f"  B={b:2d}: {b * 128:5d} blocks, {ms:.4f} ms, {ms / b:.4f} ms a batch row")
        if b == 8:  # the SM clock while the kernel runs back to back for a few seconds
            for _ in range(8000):
                mod.mamba_scan_fwd(*inputs)
            clocks = [subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip() for _ in range(3)]
            torch.cuda.synchronize()
            print(f"        SM clock and power while it runs back to back: {'; '.join(clocks)}")
        del inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mamba", default="P0B5,P1B5,P2B5,P3B5,P0B4")
    ap.add_argument("--rwkv6", default="C64P4,C64P2,C32P4")
    ap.add_argument("--batches", default="", help="batch sizes to time the Mamba kernel at, e.g. 1,2,4,8")
    ap.add_argument("--baseline", type=Path, default=None, help="directory with mamba.cu and rwkv6.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kernel in ("mamba", "rwkv6"):
        tags = [t for t in getattr(args, kernel).split(",") if t]
        if tags:
            sweep(kernel, tags, args.baseline, smi, dev, gen)
            torch.cuda.empty_cache()
    if args.batches:
        batches([int(b) for b in args.batches.split(",")], smi, dev, gen)


if __name__ == "__main__":
    main()
