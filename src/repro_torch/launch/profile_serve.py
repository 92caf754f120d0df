"""Where the serving time goes: ``repro_torch.launch.serve.run`` with its
timed prefill and its timed decode loop each under ``torch.profiler``, and
the device's busy and idle share of each window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full \\
        [--arch rwkv6_1_6b] [--batch 8 --prompt-len 512 --steps 8]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full \\
        --arch jamba_1_5_large_398b --n-layers 16 --no-moe
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full \\
        --arch mixtral_8x22b --n-layers 8 [--batch 1 --prompt-len 8192]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full \\
        --arch arctic_480b --n-layers 1
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --full \\
        --arch jamba_1_5_large_398b --n-layers 8 --n-experts 8

Needs a CUDA device. Busy time is the sum of the device-side events' time
(kernels, copies and fills on one stream, so they do not overlap); idle
share is 1 - busy / wall, with wall taken on the host clock around the
window, which ends in a synchronize. Busy time is also split by kind of
kernel (``profile_train.by_kind``) and, for MoE layers, by the ranges of
``models.moe.RANGES``: the device time of the kernels each range launched.
Busy time leaves out the device-side span of every range the program names
(``profile_train.device_rows``).
"""
from __future__ import annotations

import argparse
import time
from contextlib import contextmanager

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..models.moe import RANGES
from .profile_train import by_kind, device_rows
from .serve import DTYPES, add_override_args, overrides_from_args, run


@contextmanager
def _window(name: str, top: int):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = device_rows(averages)  # an aten op's host row also carries its kernels' time
    if not rows:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kinds = by_kind(rows)
    ranges = [e for e in averages if e.key in RANGES and e.device_type == DeviceType.CPU]
    print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows)} device ops; by kind: "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})" for k, v in kinds.items())
          + "".join(f"; {e.key} {e.device_time_total / 1e3:.3f} ms over {e.count} calls" for e in ranges))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen3_0_6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8, help="decode steps in the decode window")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--top", type=int, default=12)
    add_override_args(ap)
    args = ap.parse_args(argv)

    shape = f"B={args.batch} S={args.prompt_len}"
    run(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.steps + 1,
        full=args.full, device="cuda", dtype=args.dtype, overrides=overrides_from_args(args),
        window=lambda name: _window(
            f"{name} {shape}" + (f" {args.steps} steps" if name == "decode" else ""), args.top))


if __name__ == "__main__":
    main()
