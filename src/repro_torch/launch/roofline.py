"""Roofline analysis from the dry-run's results (port of ``repro.launch.roofline``).

Per (arch x shape x mesh) cell, with the H100 constants of ``launch/mesh.py``
and rank 0's counts from ``launch/dryrun.py`` (every rank runs the same
program on its shard, so one rank's time is the step's):

    compute_s    = flops_per_device / 989e12
    memory_s     = bytes_per_device / 3.35e12
    collective_s = nvlink bytes / 450e9 + nic bytes / 50e9

A cell without the split by link (``collective_bytes_by_link``) is charged
at the NIC, as every group of the production meshes crosses nodes. The
dominant term is the bottleneck; roofline fraction = dominant /
(compute + memory + collective) measures how balanced the cell is, and
MODEL_FLOPS / counted FLOPs (6 N D train, 2 N D inference, N the active
params) how much of the counted compute is "useful" (remat's recompute,
the backward's recompute through the plain attention, and attention's own
products, which the parameter count ignores). These are outputs of a model
with data-sheet constants, not measurements.

Usage: python -m repro_torch.launch.roofline [--tag TAG] [--markdown]
"""
from __future__ import annotations

import argparse
import json

from . import dryrun
from .mesh import HBM_BW, HBM_BYTES, LINK_BW, NIC_BW, PEAK_FLOPS_BF16


def model_flops(cell: dict) -> float:
    """6 N D (train) / 2 N D (inference) with N = active params, D = global
    tokens processed by the step."""
    n_active = cell["params_active"]
    if cell["kind"] == "train":
        tokens = cell["global_batch"] * cell["seq_len"]
        return 6.0 * n_active * tokens
    if cell["kind"] == "prefill":
        tokens = cell["global_batch"] * cell["seq_len"]
        return 2.0 * n_active * tokens
    tokens = cell["global_batch"]  # decode: one token per sequence
    return 2.0 * n_active * tokens


def collective_seconds(cell: dict) -> float:
    by_link = cell.get("collective_bytes_by_link")
    if by_link is None:
        return cell["collective_bytes_per_device"] / NIC_BW
    return sum(n / LINK_BW[link] for link, n in by_link.items() if link in LINK_BW)


def analyze(cell: dict) -> dict:
    chips = cell["chips"]
    compute_s = cell["flops_per_device"] / PEAK_FLOPS_BF16
    memory_s = cell["bytes_per_device"] / HBM_BW
    coll_s = collective_seconds(cell)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    total_flops = cell["flops_per_device"] * chips
    mf = model_flops(cell)
    mem = cell["memory"]
    hbm_bytes = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    return {
        **{k: cell.get(k) for k in ("arch", "shape", "mesh", "kind", "chips")},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "bound_step_s": terms[dominant],
        "roofline_fraction": terms[dominant] / (compute_s + memory_s + coll_s),
        "model_flops": mf,
        "useful_compute_ratio": mf / total_flops if total_flops else 0.0,
        "hbm_gib_per_device": hbm_bytes / 2**30,
        "fits_h100_80g": hbm_bytes < HBM_BYTES,
        "collective_by_type": cell.get("collective_by_type", {}),
    }


def load_cells(tag: str = "") -> list[dict]:
    cells = []
    for path in sorted(dryrun.RESULTS_DIR.glob("*.json")):
        parts = path.name[:-5].split(".")
        cell_tag = parts[3] if len(parts) > 3 else ""
        if cell_tag != tag:
            continue
        cells.append(json.loads(path.read_text()))
    return cells


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | dominant | "
           "MODEL/counted | HBM GiB/dev | fits 80 GB |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_compute_ratio']:.2f} | {r['hbm_gib_per_device']:.2f} | "
            f"{'yes' if r['fits_h100_80g'] else 'NO'} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()
    cells = load_cells(args.tag)
    rows, skips, fails = [], [], []
    for c in cells:
        if c["status"] == "ok":
            rows.append(analyze(c))
        elif c["status"] == "skipped":
            skips.append(c)
        else:
            fails.append(c)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    if args.markdown:
        print(markdown_table(rows))
        if skips:
            print("\nSkipped cells (assignment rule):")
            for s in skips:
                print(f"- {s['arch']} x {s['shape']}: {s['skip_reason']}")
        if fails:
            print("\nFAILED cells:")
            for s in fails:
                print(f"- {s['arch']} x {s['shape']} x {s['mesh']} (torch {s.get('torch')}): {s.get('error')}")
    else:
        for r in rows:
            print(json.dumps(r))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
