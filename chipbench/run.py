"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the workload in ``BENCHMARK.json``
and its configuration, traffic, driver, reference and limits by name,
runs the driver (set-up, then the window of ``--seconds``; with
``--trace 1`` the profiler over its first steps), checks the outputs of the
timed path against the plain reference, and prints one JSON line last on
standard output. The numbers compared, with their limits, are the last
lines on standard error. It exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell's chips), without the program
(``src/repro_torch``), or when ``jax``, ``jaxlib``, ``flax`` or ``repro`` is
loaded in the process.
"""
import time

T0 = time.perf_counter()  # the process's start, as near as a script can take it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # the harness as the package ``chipbench``, not its files as top-level modules
sys.path.insert(1, str(ROOT / "src"))  # the program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from chipbench import compare, harness

    if harness.forbidden_modules():
        print(f"refusing to run: {harness.forbidden_modules()} already loaded", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    os.environ["USE_FLAX"] = "0"
    cache = ROOT / ".chipbench_cache"  # fixed paths inside the checkout: only a checkout's first run builds
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    drv = harness.driver(cell.traffic["kind"])
    os.environ.update(getattr(drv, "ENV", {}))  # the driver's settings, read when the card starts
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: {args.workload} needs {cell.chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no result: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 4
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=dev,
                      t0=T0)
    out = drv.run(run)
    if harness.forbidden_modules():
        print(f"no result: {harness.forbidden_modules()} loaded in this process", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips}
    line = harness.result(cell, out, bool(args.trace), device)
    for name, value in out.metrics.items():
        print(f"metric {name} {value!r}", file=sys.stderr)
    compare.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
