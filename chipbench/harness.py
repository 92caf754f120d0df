"""The benchmark's spine: ``BENCHMARK.json`` and the files it names, the
port's config built from a configuration file, the weights and the seeds.

Everything that belongs to one configuration, traffic mix, per-layer metric
or architecture family sits in a file of its own, found by name:

- ``configs/<config>.json`` (the file named in ``BENCHMARK.json``): the
  published config's keys as run, and ``family``, ``reduced``, ``assumed``;
- ``traffic/<traffic>.json``: the mix, with ``kind`` naming its driver;
- ``drivers/<kind>.py``: ``run(run: Run) -> Outcome``;
- ``metrics/<metric>.py``: ``read(trace) -> float | None``;
- ``reference/<family>.py``: the plain fp32 reference;
- ``limits/<workload>.json``: the limit of each number ``correct`` compares.

The weights are inputs: made here from the seed, on the device, in the type
they are served in, one ``torch.randn`` a leaf of the port's parameter tree
(about a dozen leaves, each stacking its layers), from one generator. The
port takes the tree; the reference takes the same tensors, unstacked by
``layers`` into its own per-layer dicts.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process, compared whole
# ("repro_torch", the port, begins with "repro" and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each stream drawn from ``seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "big") & (2**63 - 1)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list[dict]  # the end-to-end metrics this cell reports
    per_layer: list[dict]  # the per-layer metrics this cell reports


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The workload ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        config=read_json(root / conf["file"]),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{workload}.json"),
        chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def driver(kind: str):
    return importlib.import_module(f"chipbench.drivers.{kind}")


def reference(family: str):
    return importlib.import_module(f"chipbench.reference.{family}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ the port's config
def model_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file: every published
    key it holds, as run, mapped onto the port's fields."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    heads = conf["num_attention_heads"]
    moe = None
    if "num_local_experts" in conf:
        moe = MoEConfig(n_experts=conf["num_local_experts"], top_k=conf["num_experts_per_tok"],
                        capacity_factor=conf["capacity_factor"],
                        router_aux_weight=conf["router_aux_loss_coef"])
    return ModelConfig(
        name=conf["name"], family="moe" if moe else "dense",
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"], n_heads=heads,
        n_kv_heads=conf["num_key_value_heads"], d_ff=conf["intermediate_size"],
        vocab_size=conf["vocab_size"], d_head=conf.get("head_dim") or conf["hidden_size"] // heads,
        rope_theta=float(conf["rope_theta"]), sliding_window=conf["sliding_window"],
        norm_eps=conf["rms_norm_eps"], tie_embeddings=conf["tie_word_embeddings"], moe=moe,
        dtype=conf["torch_dtype"],
    )


# ------------------------------------------------------------------ weights
def iter_weights(cfg, seed: int, device):
    """(path, tensor) of every leaf of the port's parameter tree for ``cfg``,
    in sorted path order, drawn from one generator on ``device`` seeded from
    ``seed``: a normal leaf is ``randn`` in the model dtype times the port's
    init scale (1/sqrt(fan_in), or the leaf's own); a norm's scale is
    uniform in [0.5, 1.5), so that a norm weight left out or misapplied
    changes the outputs."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_paths

    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    for path, d in tree_paths(T.param_defs(cfg)):
        if d.init == "ones":
            yield path, torch.rand(d.shape, generator=gen, dtype=dtype, device=device).add_(0.5)
        elif d.init == "zeros":
            yield path, torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "normal":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else fan_in**-0.5
            yield path, torch.randn(d.shape, generator=gen, dtype=dtype, device=device).mul_(scale)
        else:
            raise NotImplementedError(f"{path}: init {d.init!r} has no maker here")


def make_weights(cfg, seed: int, device) -> dict:
    """The nested parameter tree the port takes, from ``iter_weights``."""
    tree: dict = {}
    for path, leaf in iter_weights(cfg, seed, device):
        *parents, name = path.strip("/").split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def layer_slices(cfg, path: str, leaf):
    """(per-layer name, tensor) of one leaf of the port's tree: a stacked
    block leaf ``blocks/p{i}/<rest>`` [R, ...] gives ``L{r * P + i}/<rest>``
    for each repeat r of the P-layer pattern; a top-level leaf is itself."""
    parts = path.strip("/").split("/")
    if parts[0] != "blocks":
        yield "/".join(parts), leaf
        return
    pos, rest = int(parts[1][1:]), "/".join(parts[2:])
    period = len(cfg.pattern)
    for r in range(leaf.shape[0]):
        yield f"L{r * period + pos}/{rest}", leaf[r]


def flat_leaves(tree: dict, prefix: str = "") -> list[tuple[str, object]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flat_leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(f"{prefix}/{k}", v)])
    return out


def layers(cfg, tree: dict) -> dict:
    """The reference's view of the weights: ``{"embed", "lm_head",
    "final_norm", "layers": [{name: tensor}]}``, each layer's dict keyed by
    the leaf's last name (``wq``, ``ln1``, ``w1``, ``router``, ``e_w1``...).
    Views of the same tensors: nothing is copied or derived."""
    out: dict = {"layers": [dict() for _ in range(cfg.n_layers)]}
    for path, leaf in flat_leaves(tree):
        for name, t in layer_slices(cfg, path, leaf):
            if name.startswith("L"):
                idx, rest = name[1:].split("/", 1)
                out["layers"][int(idx)][rest.rsplit("/", 1)[-1]] = t
            else:
                out[name] = t
    return out


# ------------------------------------------------------------------ one run
@dataclass
class Run:
    """What a driver is given: the cell, the run's arguments, the device and
    the process's start on the host clock (``time.perf_counter``)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    readings: bool = False  # a correctness reading: the sample from the first batches, no window
    # readings only: others put in the program's place, each judged as the program is
    # ("control": the reference in fp8; "half_batch": the fp32 reference on half of each batch)
    variants: tuple = ()


@dataclass
class Outcome:
    """What a driver hands back: end-to-end metrics (seconds and rates on the
    host clock), requests or steps attempted and failed, the numbers
    ``correct`` compares, and with ``--trace 1`` the trace."""
    metrics: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    numbers: dict = field(default_factory=dict)
    variant_numbers: dict = field(default_factory=dict)  # {variant: numbers}, readings only
    memory_peak_bytes: int = 0
    trace: object = None


# ------------------------------------------------------------------ the result line
def result(cell: Cell, out: Outcome, trace: bool, device: dict) -> dict:
    """The run's last line: ``correct`` from the numbers against the cell's
    limits, the cell's end-to-end metrics (``--trace 0``) or the per-layer
    metrics its readers find (``--trace 1``), and the numbers compared with
    their limits under ``checks``, last."""
    from . import compare, tracing

    correct, shown = compare.verdict(out.numbers, cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {**device, "busy_s": out.trace.busy_s(), "window_s": out.trace.window_s}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": {**device, "memory_peak_bytes": out.memory_peak_bytes}}
    if trace:
        line["breakdown"] = tracing.breakdown(out.trace)
    line["checks"] = shown
    return line
