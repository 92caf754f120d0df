"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell, on the single-pod 16x16 mesh
and the 2x16x16 multi-pod mesh (``mesh.make_production_mesh``, over a fake
process group): the real ``make_train_step``, ``make_prefill_step`` or
``make_decode_step(..., rules=...)`` runs once on stand-ins of its inputs
(``specs``: meta tensors, as DTensors on the mesh), under
``op_stats.OpStats``, which counts rank 0's FLOPs, bytes, collectives, ops
and peak live memory. No card and no weights: a meta tensor has no
storage, and the kernel ops take their fake implementations and FLOP
formulas (``kernels/ops.py``). Results are cached as JSON under
``results_dryrun_torch/`` for ``launch/roofline.py``.

The stand-ins are meta tensors rather than fake CUDA tensors
(``FakeTensorMode``): where torch is built without CUDA, autograd aborts the
process on a fake CUDA tensor (the engine asks CUDA for a stream), and a
meta tensor runs the same ops, faster, on any build. The model takes its
kernels for a meta tensor as it does for a CUDA one (``use_pallas="auto"``).

The port loops over its layers in Python, so every layer's ops are counted
where they run. The reference lowers a scanned stack whose loop body XLA
counts once, and so extrapolates from 1 and 2 repeats (``_extrapolate``)
and adds the recurrences' FLOPs by hand (``_recurrence_correction``); here
neither is needed, and the kernel ops' formulas count the recurrences.

``--one-card`` plans a cell's kind of step unsharded, on one card, at
each ``--batch`` x ``--seq-len`` (model state, batch and every temporary on
one device): rank 0's peak against ``mesh.HBM_BYTES``, and the largest
batch whose peak leaves ``FREE_GIB`` of the card free (``plan_one_card``);
with ``--compress-grads`` the train step is the one with int8
error-feedback gradients (``make_train_step(..., compress_grads=True)``).

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2_20b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    python -m repro_torch.launch.dryrun --arch X --shape Y --tag blah \\
        --override seq_shard_residual=False
    python -m repro_torch.launch.dryrun --arch jamba_1_5_large_398b --shape train_4k \\
        --one-card --batch 8 4 2 1 --seq-len 512 --override moe=None --override n_layers=8
    python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k --one-card \\
        --batch 64 --seq-len 512 --override microbatches=8 --compress-grads
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from .. import configs
from ..distributed.sharding import rules_for
from ..train.steps import make_decode_step, make_prefill_step, make_train_step
from . import specs
from .mesh import HBM_BYTES, make_production_mesh, start_fake_world
from .op_stats import OpStats, op_histogram

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results_dryrun_torch"
FREE_GIB = 4  # --one-card: the card's memory a fit leaves for the plan's error and the allocator's slack


def _parse_override(s: str):
    key, _, val = s.partition("=")
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val in ("True", "False"):
        return key, val == "True"
    if val == "None":
        return key, None
    return key, val


def plan_step(cfg, shape: configs.Shape, rules=None, *, cache_len: int | None = None,
              pos: int | None = None, compress_grads: bool = False) -> dict:
    """Run ``shape``'s step of ``cfg`` once on stand-ins (with ``rules``, as
    DTensors on its mesh) under ``OpStats``; ``cache_len`` and ``pos`` set a
    prefill's cache length and a decode step's cache length and position
    (default: the shape's length, and its last position); ``compress_grads``
    plans a train step with int8 error-feedback gradients, its residual
    among the optimizer state's stand-ins. Returns rank 0's
    counts: ``flops``, ``bytes``, collectives, ``ops`` (every op's count),
    ``memory`` and ``plan_s``, the host time of the run."""
    t0 = time.perf_counter()
    if shape.kind == "train":
        params, opt_state = specs.model_state_specs(cfg, rules, True, compress_grads)
        args = (params, opt_state, specs.batch_specs(cfg, shape, rules))
        fn = make_train_step(cfg, specs.make_optimizer(cfg), compress_grads, rules=rules)
    elif shape.kind == "prefill":
        params, _ = specs.model_state_specs(cfg, rules, False)
        args = (params, specs.batch_specs(cfg, shape, rules))
        fn = make_prefill_step(cfg, cache_len=cache_len or shape.seq_len, rules=rules)
    else:
        params, _ = specs.model_state_specs(cfg, rules, False)
        args = (params, *specs.decode_specs(cfg, shape, rules, cache_len=cache_len, pos=pos))
        fn = make_decode_step(cfg, rules=rules)
    stats = OpStats()
    stats.track(args)
    arg_bytes = stats.live
    with stats:
        out = fn(*args)
    end_bytes = stats.live  # the arguments and the outputs, all still held
    del out
    return {
        "flops": stats.flops,
        "bytes": stats.bytes,
        "collective_bytes": stats.collective_bytes,
        "collective_by_type": dict(stats.collective_by_type),
        "collective_by_link": dict(stats.collective_by_link),
        "collective_count": stats.collective_count,
        "collectives": stats.collectives,
        "ops": dict(stats.ops),
        "memory": {
            "peak_bytes": stats.peak,
            "argument_bytes": arg_bytes,
            "output_bytes": end_bytes - arg_bytes,
            "temp_bytes": stats.peak - end_bytes,
        },
        "plan_s": time.perf_counter() - t0,
    }


def kernel_calls(ops: dict) -> dict:
    """The kernel ops' calls among an op count: {'flash_attention_fwd': n, ...}."""
    return {name.split(".", 1)[1]: n for name, n in sorted(ops.items()) if name.startswith("repro_torch.")}


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict | None = None) -> dict:
    shape = configs.SHAPES[shape_name]
    cfg = configs.get(arch)
    if overrides:
        overrides = dict(overrides)
        cap = overrides.pop("capacity_factor", None)
        if cap is not None and cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
        if overrides:
            cfg = cfg.replace(**overrides)
    runnable, reason = configs.cell_runnable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": 512 if multi_pod else 256,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "overrides": overrides or {},
        "status": "skipped" if not runnable else "pending",
        "skip_reason": reason,
        "torch": torch.__version__,
    }
    if not runnable:
        return cell
    started = start_fake_world(cell["chips"])
    try:
        rules = rules_for(cfg, make_production_mesh(multi_pod=multi_pod))
        st = plan_step(cfg, shape, rules)
    finally:
        if started:
            dist.destroy_process_group()
    n = cfg.param_counts()
    cell.update(
        status="ok",
        plan_s=round(st["plan_s"], 2),
        flops_per_device=st["flops"],
        bytes_per_device=st["bytes"],
        collective_bytes_per_device=st["collective_bytes"],
        collective_by_type=st["collective_by_type"],
        collective_bytes_by_link=st["collective_by_link"],
        collective_count=st["collective_count"],
        memory=st["memory"],
        params_total=n["total"],
        params_active=n["active"],
        op_histogram=op_histogram(st["ops"]),
        kernel_calls=kernel_calls(st["ops"]),
    )
    return cell


def plan_one_card(arch: str, shape_name: str, batch: int, seq_len: int, overrides: dict | None = None,
                  compress_grads: bool = False) -> dict:
    """``shape_name``'s kind of step of the full config (with ``overrides``)
    at ``batch`` x ``seq_len``, unsharded, as one card would run it:
    rank 0's counts from ``plan_step`` (no process group, no mesh) and the
    card's memory left free at the planned peak. ``compress_grads`` as in
    ``plan_step``."""
    kind = configs.SHAPES[shape_name].kind
    cfg = configs.get(arch).replace(**(overrides or {}))
    st = plan_step(cfg, configs.Shape(f"{kind}_{seq_len}x{batch}", kind, seq_len, batch),
                   compress_grads=compress_grads)
    return {"arch": arch, "kind": kind, "global_batch": batch, "seq_len": seq_len, "overrides": overrides or {},
            "compress_grads": compress_grads, "chips": 1, "status": "ok", "plan_s": round(st["plan_s"], 2),
            "flops_per_device": st["flops"], "bytes_per_device": st["bytes"], "memory": st["memory"],
            "free_bytes": HBM_BYTES - st["memory"]["peak_bytes"], "kernel_calls": kernel_calls(st["ops"]),
            "torch": torch.__version__}


def one_card_main(args, overrides: dict | None) -> None:
    """``--one-card``: plan each batch, print its peak and the card's memory
    left free, then the largest batch that leaves ``FREE_GIB`` GiB."""
    fits = []
    for b in args.batch:
        cell = plan_one_card(args.arch, args.shape, b, args.seq_len, overrides, args.compress_grads)
        peak, free = cell["memory"]["peak_bytes"], cell["free_bytes"]
        if free >= FREE_GIB * 2**30:
            fits.append(b)
        print(json.dumps(cell, sort_keys=True))
        compressed = ", int8 error-feedback gradients" if args.compress_grads else ""
        print(f"{args.arch} {cell['kind']} B={b} x {args.seq_len} {overrides or {}}{compressed} on one card: "
              f"planned peak {peak} B ({peak / 2**30:.3f} GiB) of {HBM_BYTES / 2**30:.3f} GiB, "
              f"{free / 2**30:.3f} GiB free; kernel calls {cell['kernel_calls']}; planned in {cell['plan_s']} s",
              flush=True)
    print(f"largest batch leaving {FREE_GIB} GiB free: {max(fits) if fits else None}")


def cell_path(arch, shape_name, mesh_name, tag="") -> Path:
    suffix = f".{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}.{shape_name}.{mesh_name}{suffix}.json"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for result files (hillclimb runs)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field overrides, e.g. seq_shard_residual=False")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--one-card", action="store_true", help="plan unsharded on one card at --batch x --seq-len")
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--compress-grads", action="store_true",
                    help="--one-card: plan the train step with int8 error-feedback gradients")
    args = ap.parse_args()

    overrides = dict(_parse_override(s) for s in args.override) or None
    if args.one_card:
        if not (args.arch and args.shape):
            ap.error("--one-card needs --arch and --shape")
        return one_card_main(args, overrides)
    if args.compress_grads:
        ap.error("--compress-grads plans with --one-card")
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                out = cell_path(arch, shape, mesh_name, args.tag)
                if out.exists() and not args.force:
                    print(f"[cached] {arch} x {shape} x {mesh_name}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
                try:
                    cell = run_cell(arch, shape, multi, overrides)
                except Exception as e:  # a failure here is a fault of the port, recorded and counted
                    failures += 1
                    cell = {
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                        "torch": torch.__version__,
                    }
                    print(f"  FAILED: {cell['error'][:500]}")
                out.write_text(json.dumps(cell, indent=1, sort_keys=True))
                if cell["status"] == "ok":
                    print(f"  ok: plan={cell['plan_s']}s flops/dev={cell['flops_per_device']:.3e} "
                          f"coll/dev={cell['collective_bytes_per_device']:.3e}B "
                          f"peak={cell['memory']['peak_bytes'] / 2**30:.2f}GiB kernels={cell['kernel_calls']}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
