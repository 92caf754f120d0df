"""The readings that the limits of ``correct`` are set from: for each seed,
the numbers of a sound run of the program, and for the variant seeds also
those of each variant put in its place (``control``: the reference in fp8;
``half_batch``: the fp32 reference on half of each batch), all judged
against the fp32 reference as a run judges the program.

    python3 chipbench/readings.py --workload <name> --seeds 1 2 ... \\
        [--variant-seeds 7 8 9 --variants control half_batch] [--override key=json ...]

A reading takes no measured window: the first ``sample_batches`` batches
(a prompt phase) or the ``checked_steps`` (training), at the cell's own
size. One JSON line a seed on standard output, also appended to
``chiprun_out/readings_<workload>.jsonl``. ``--override`` replaces keys of
the configuration (a witness at another size or dtype). Needs a CUDA card.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--override", nargs="*", default=[], help="key=json value of the configuration")
    args = ap.parse_args(argv)

    import os

    from chipbench import harness

    cell = harness.cell(args.workload)
    overrides = {k: json.loads(v) for k, v in (o.split("=", 1) for o in args.override)}
    cell.config = {**cell.config, **overrides}
    drv = harness.driver(cell.traffic["kind"])
    os.environ.update(getattr(drv, "ENV", {}))  # the driver's settings, read when the card starts
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    out_file = ROOT / "chiprun_out" / f"readings_{args.workload}.jsonl"
    out_file.parent.mkdir(exist_ok=True)
    for seed in [*args.seeds, *args.variant_seeds]:
        t0 = time.perf_counter()
        variants = tuple(args.variants) if seed in args.variant_seeds else ()
        run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=dev, t0=t0, readings=True,
                          variants=variants)
        out = drv.run(run)
        line = {"workload": args.workload, "override": overrides, "seed": seed, "program": out.numbers, **out.variant_numbers,
                "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(dev),
                "memory_peak_bytes": out.memory_peak_bytes}
        print(json.dumps(line), flush=True)
        with out_file.open("a") as f:
            f.write(json.dumps(line) + "\n")
        del out, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
