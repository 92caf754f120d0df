"""Where a training step's time goes: one step of ``make_train_step`` at
the launcher's shape, split into its forward, backward and optimizer on the
host clock (each piece ends in a synchronise), then a whole step under
``torch.profiler`` with the device's busy and idle share and its time by
kind of kernel.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --full \\
        [--arch qwen3_0_6b] [--batch 8 --seq-len 512] \\
        [--n-layers N] [--n-experts N | --no-moe]

Needs a CUDA device. Busy time is the sum of the device-side events' time
(one stream, so they do not overlap); idle share is 1 - busy / wall. The
backward includes remat's recompute of every repeat's forward and the
kernel ops' backwards, each through its plain version (flash through
``attention_ref``, WKV through ``rwkv6_ref``, Mamba through
``mamba_ref``); their device and host times come from their profiler
ranges, ``ops.BACKWARD_RANGES``. Busy time leaves out the device-side span
of every range the program names (``spans.py``), which covers kernels
counted already. ``--n-layers``, ``--n-experts`` and ``--no-moe`` cut the
config as in ``launch.serve``. It runs with PyTorch's deterministic
algorithms, as ``launch.train``'s command line does.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs, resolve_device
from ..data.tokens import SyntheticTokens
from ..kernels.ops import BACKWARD_RANGES
from ..models import transformer as T
from ..models.params import init_params
from ..optim.adamw import AdamW
from ..train.loop import check_token_only
from ..train.steps import make_train_step, masked_loss
from ..tree import leaves, unflatten
from .serve import add_override_args, overrides_from_args

# kernel-name fragments of each kind, checked in order; the rest is "elementwise and other".
# fp32 GEMMs come from attention_ref's products (TF32 off); the bf16 ones from the model's.
KINDS = [("flash kernel", ("flash_fwd",)),
         ("WKV kernel", ("rwkv6_",)),
         ("Mamba kernel", ("mamba_scan_",)),
         ("fp32 GEMM", ("sgemm", "f32f32")),
         ("bf16 GEMM", ("gemm", "nvjet", "cutlass", "xmma", "splitkreduce"))]


def by_kind(rows) -> dict[str, float]:
    """Device ms of the profiler's device-side ``rows`` by kind of kernel."""
    kinds = {name: 0.0 for name, _ in KINDS} | {"elementwise and other": 0.0}
    for e in rows:
        key = e.key.lower()
        kind = next((name for name, frags in KINDS if any(f in key for f in frags)), "elementwise and other")
        kinds[kind] += e.self_device_time_total / 1e3
    return kinds


def device_rows(averages) -> list:
    """The device-side rows of the profiler's ``key_averages()``, less each
    user annotation's own: a ``record_function`` range's span on the device
    covers kernels that have rows of their own, and ranges nest."""
    names = {e.key for e in averages if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False)}
    return [e for e in averages if e.device_type == DeviceType.CUDA and e.key not in names]


def _timed(dev, fn) -> tuple[float, object]:
    """(ms of ``fn()`` on the host clock, ending in a synchronise; its result)."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3, out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen3_0_6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--reps", type=int, default=3, help="steps timed per piece")
    ap.add_argument("--top", type=int, default=12)
    add_override_args(ap)
    args = ap.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # read when cuBLAS starts
    torch.use_deterministic_algorithms(True)
    dev = resolve_device("cuda")
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    cfg = cfg.replace(**overrides_from_args(args))
    check_token_only(cfg)
    params = init_params(T.param_defs(cfg), seed=0, device=dev)
    opt = AdamW(lr=1e-3, moment_dtype=cfg.opt_moment_dtype)
    state = opt.init(params)
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch)
    batch = {"tokens": torch.from_numpy(ds.global_batch_at(0)).to(dev)}
    step = make_train_step(cfg, opt)
    for _ in range(2):  # warm-up: kernel build, cuBLAS and allocator start-up
        params, state, _ = step(params, state, batch)

    # the step's three pieces, as make_train_step runs them
    flat = [p.requires_grad_() for p in leaves(params)]

    def forward():
        return masked_loss(T.forward_train(cfg, params, batch)[0], batch["tokens"], cfg.vocab_size)

    times: dict[str, list[float]] = {"step": [], "forward": [], "backward": [], "optimizer": []}
    for _ in range(args.reps):
        ms, loss = _timed(dev, forward)
        times["forward"].append(ms)
        ms, grads = _timed(dev, lambda: torch.autograd.grad(loss, flat))
        times["backward"].append(ms)
        times["optimizer"].append(_timed(dev, lambda: opt.update(unflatten(params, grads), state, params))[0])
        del loss, grads  # a model that fills the card holds one set of gradients at a time
        times["step"].append(_timed(dev, lambda: step(params, state, batch))[0])
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    shape = f"{args.arch} B={args.batch} S={args.seq_len}"
    print(f"train step {shape} (bf16 weights, {cfg.opt_moment_dtype} moments, remat {cfg.remat}): "
          f"step {mean['step']:.3f} ms; forward {mean['forward']:.3f} ms, backward {mean['backward']:.3f} ms "
          f"(remat recompute and the kernel ops' backwards included), optimizer {mean['optimizer']:.3f} ms "
          f"(host clock, mean of {args.reps})")

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = device_rows(averages)
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kinds = by_kind(rows)
    # each kernel op's backward: device time, host time and calls of its range
    ranges = {e.key: {"device_ms": e.device_time_total / 1e3, "host_ms": e.cpu_time_total / 1e3, "calls": e.count}
              for e in averages if e.key in BACKWARD_RANGES and e.device_type == DeviceType.CPU}
    print(f"profiled step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows)} device ops; by kind: "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})" for k, v in kinds.items())
          + "; " + ", ".join(f"{k}: {r['device_ms']:.3f} ms device time, {r['host_ms']:.3f} ms host time over "
                             f"{r['calls']} calls" for k, r in ranges.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    return {**{f"{k}_ms": v for k, v in mean.items()}, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "kinds_ms": kinds, "backward_ranges": ranges}


if __name__ == "__main__":
    main()
