"""BENCHMARK.json against the benchmark's contract, and every workload's
files found by name."""
from __future__ import annotations

import json
import re

import pytest
from chipbench.small import ROOT, WORKLOADS

from chipbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file() and BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("chipbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and "bound" not in m


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in WORKLOADS:
        cell = harness.cell(w)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:  # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in reported, (w, m["name"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) == len({layer.split(":")[0] for layer in layers})


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_files_resolve(workload):
    cell = harness.cell(workload)
    assert (ROOT / "chipbench" / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    assert callable(harness.driver(cell.traffic["kind"]).run)
    ref = harness.reference(cell.config["family"])
    assert callable(ref.prefill) and callable(ref.train)
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    assert cell.limits and set(cell.limits) <= set(harness.driver(cell.traffic["kind"]).NUMBERS)
    assert all(0 <= v < 1e3 for v in cell.limits.values())  # 0: an exact comparison


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_published_one_as_run(config):
    """The file's widths are the port registry's, its reduced keys differ from
    the published values it keeps, and the port's config is built from it."""
    from repro_torch import configs

    conf = json.loads((ROOT / config["file"]).read_text())
    assert conf["name"] == config["name"] and conf["source"] == config["source"]
    assert conf["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert conf["published"][key] != conf[key]
    cfg, reg = harness.model_config(conf), configs.get(conf["port_registry"])
    for field in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "head_dim", "rope_theta", "norm_eps"):
        assert getattr(cfg, field) == getattr(reg, field), field
    assert (cfg.moe is None) == (reg.moe is None)
    if cfg.moe:
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor) == (
            reg.moe.n_experts, reg.moe.top_k, reg.moe.capacity_factor)
    assert cfg.n_layers == conf["num_hidden_layers"] and cfg.sliding_window == conf["sliding_window"]
