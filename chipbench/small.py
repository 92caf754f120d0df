"""Small cells for the CPU tests: each cell of ``BENCHMARK.json`` with its
family, its published structure (heads in the same ratio, its experts and
their capacity) and its limits, at widths and lengths a test run holds,
cut by the kind of its traffic."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SMALL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
         "num_hidden_layers": 2, "vocab_size": 500}
WORKLOADS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
# a logit's spread grows with the width (the head's 0.02 x sqrt(hidden)); at this width and the
# published vocabulary a token taken at random lies as far below the best as at the cell's own
WIDE = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 256,
        "vocab_size": 32768}


def small_cell(workload: str, **config):
    from chipbench import harness

    c = harness.cell(workload)
    c.config = {**c.config, **SMALL, **config}
    small = harness.driver(c.traffic["kind"]).SMALL  # the traffic kind's shape at a test's size
    c.traffic = {**c.traffic, **small, "batch": min(c.traffic["batch"], small["batch"])}
    return c


def run_small(cell, seed: int = 2**31 + 11, **kw):
    """A run of ``cell`` on the CPU: the driver, the window and the check."""
    import time

    import torch

    from chipbench import harness

    kw.setdefault("seconds", 0.2)
    r = harness.Run(cell=cell, seed=seed, trace=False, device=torch.device("cpu"), t0=time.perf_counter(), **kw)
    return harness.driver(cell.traffic["kind"]).run(r)
