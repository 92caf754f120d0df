"""Where a training step's time goes: one step of ``make_train_step`` at
the launcher's shape, split into its forward, backward and optimizer on the
host clock (each piece ends in a synchronise), then a whole step under
``torch.profiler`` with the device's busy and idle share and its time by
kind of kernel.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --full \\
        [--arch qwen3_0_6b] [--batch 8 --seq-len 512]

Needs a CUDA device. Busy time is the sum of the device-side events' time
(one stream, so they do not overlap); idle share is 1 - busy / wall. The
backward includes remat's recompute of every repeat's forward and the flash
op's backward through ``attention_ref``; the latter's device time comes
from its profiler range, ``ops.BACKWARD_RANGE``.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import configs, resolve_device
from ..data.tokens import SyntheticTokens
from ..kernels.ops import BACKWARD_RANGE
from ..models import transformer as T
from ..models.params import init_params
from ..optim.adamw import AdamW
from ..train.loop import check_token_only
from ..train.steps import make_train_step, masked_loss
from ..tree import leaves, unflatten

# kernel-name fragments of each kind, checked in order; the rest is "elementwise and other".
# fp32 GEMMs come from attention_ref's products (TF32 off); the bf16 ones from the model's.
KINDS = [("flash kernel", ("flash_fwd",)),
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
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
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
        times["step"].append(_timed(dev, lambda: step(params, state, batch))[0])
        del loss, grads
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    shape = f"{args.arch} B={args.batch} S={args.seq_len}"
    print(f"train step {shape} (bf16 weights, {cfg.opt_moment_dtype} moments, remat {cfg.remat}): "
          f"step {mean['step']:.3f} ms; forward {mean['forward']:.3f} ms, backward {mean['backward']:.3f} ms "
          f"(remat recompute and the attention_ref backward included), optimizer {mean['optimizer']:.3f} ms "
          f"(host clock, mean of {args.reps})")

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # device-side rows only, less the range's own device span, which covers kernels counted already
    rows = [e for e in averages if e.device_type == DeviceType.CUDA and e.key != BACKWARD_RANGE]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    kinds = by_kind(rows)
    ref_bwd = [e for e in averages if e.key == BACKWARD_RANGE and e.device_type == DeviceType.CPU]
    ref_bwd_ms = ref_bwd[0].device_time_total / 1e3 if ref_bwd else float("nan")
    print(f"profiled step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows)} device ops; by kind: "
          + ", ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%})" for k, v in kinds.items())
          + f"; flash op backward through attention_ref {ref_bwd_ms:.3f} ms device time over "
          f"{ref_bwd[0].count if ref_bwd else 0} calls")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    return {**{f"{k}_ms": v for k, v in mean.items()}, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "kinds_ms": kinds, "attention_ref_backward_ms": ref_bwd_ms}


if __name__ == "__main__":
    main()
