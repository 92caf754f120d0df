"""The port's dry-run (``repro_torch.launch.dryrun``) end to end.

The counterparts of tests/test_dryrun_smoke.py's four cells run, each in a
subprocess of its own (the fake process group of 256 or 512 ranks belongs
to the whole process), all four started together. So do qwen3's and
mixtral's decode_32k with the KV cache's slots over tp
(``decode_kv_shard=seq``) on both meshes, held against the same cells
with head_dim over tp by the collectives each plan counts, and the command
line of such a cell. A smoke config's step,
unsharded and with the kernels off, counts exactly the FLOPs that
``FlopCounterMode`` counts over the same step run on CPU tensors; on a (1, 1)
mesh (a fake process group for the plan, a gloo one for the run, in a
subprocess) too. The command line writes a cell and a failing cell, and
importing the launch tools starts no process group.
"""
import json
import os
import subprocess
from collections import Counter
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.dryrun import kernel_calls, plan_step  # noqa: E402
from repro_torch.launch.serve import prompt_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.train.steps import greedy_token, make_decode_step, make_prefill_step, make_train_step  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [("qwen3_0_6b", "train_4k", "single"), ("qwen3_0_6b", "decode_32k", "single"),
         ("rwkv6_1_6b", "long_500k", "single"), ("qwen3_0_6b", "train_4k", "multi")]
# ROADMAP §C4: train steps whose query heads (56, 28) do not split over the 16 tp
# ranks, planned at full width with 1 layer (argv's fourth entry)
C4_CELLS = [("arctic_480b", "train_4k", "single"), ("qwen2_vl_7b", "train_4k", "single")]
CELL_TIMEOUT = 240  # s; the slowest cell (train_4k on 512 ranks) plans in ~20 s alone
_CELL = """
import json, sys
from repro_torch.launch.dryrun import run_cell
overrides = {"n_layers": int(sys.argv[4])} if len(sys.argv) > 4 else None
cell = run_cell(sys.argv[1], sys.argv[2], multi_pod=(sys.argv[3] == "multi"), overrides=overrides)
print("CELL=" + json.dumps(cell))
"""
_MESH = """
import json, sys, tempfile
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[1])
import test_torch_dryrun as t
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for
from repro_torch.launch.dryrun import plan_step
from repro_torch.launch.mesh import start_fake_world
torch.set_num_threads(1)
cfg = configs.get_smoke("qwen3_0_6b").replace(use_pallas="off")
mesh = lambda: init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
start_fake_world(1)
plans = {k: plan_step(cfg, s, rules_for(cfg, mesh()))["flops"] for k, s in t.KINDS.items()}
dist.destroy_process_group()
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0, world_size=1)
    runs = {k: t._run_step(cfg, k, s, rules_for(cfg, mesh())) for k, s in t.KINDS.items()}
    dist.destroy_process_group()
print("FLOPS=" + json.dumps({"plan": plans, "run": runs}))
"""

# decode from a sequence-sharded KV cache: qwen3 (B=128 over dp, 16/8 heads, Dh 128, 32768 slots)
# and mixtral (48/8 heads, a 4096-slot ring) on both production meshes
SEQ_CELLS = [(a, m) for a in ("qwen3_0_6b", "mixtral_8x22b") for m in ("single", "multi")]
_SEQ = """
import collections, json, sys, tempfile
from pathlib import Path
import repro_torch.launch.dryrun as d
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for
from repro_torch.launch.mesh import make_production_mesh
arch, multi = sys.argv[1], sys.argv[2] == "multi"
out = {}
if arch == "qwen3_0_6b" and not multi:  # the command line, before the mesh's fake group starts
    with tempfile.TemporaryDirectory() as tmp:
        d.RESULTS_DIR = Path(tmp)
        sys.argv = ["dryrun", "--arch", arch, "--shape", "decode_32k", "--override", "decode_kv_shard=seq"]
        try:
            d.main()
        except SystemExit as e:
            out["cli"] = [e.code, json.loads((Path(tmp) / f"{arch}.decode_32k.pod16x16.json").read_text())]
mesh = make_production_mesh(multi_pod=multi)
for kv in ("seq", "head_dim"):
    cfg = configs.get(arch).replace(decode_kv_shard=kv)
    st = d.plan_step(cfg, configs.SHAPES["decode_32k"], rules_for(cfg, mesh))
    out[kv] = {"collectives": st["collectives"], "kernel_calls": d.kernel_calls(st["ops"]),
               "peak": st["memory"]["peak_bytes"]}
print("SEQ=" + json.dumps(out))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}


def _start(code: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *args], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, prefix: str):
    """(exit code, the JSON the process printed after ``prefix``, its stderr's tail)."""
    try:
        stdout, stderr = proc.communicate(timeout=CELL_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    line = [x for x in stdout.splitlines() if x.startswith(prefix)]
    return proc.returncode, json.loads(line[0][len(prefix):]) if line else None, stderr[-3000:]


@pytest.fixture(scope="module")
def planned():
    """The four cells, the two §C4 cells and the one-rank mesh's FLOPs, in
    seven processes at once."""
    procs = {c: _start(_CELL, *c) for c in CELLS}
    procs.update({c: _start(_CELL, *c, "1") for c in C4_CELLS})
    procs["mesh"] = _start(_MESH, str(Path(__file__).parent))
    procs.update({("seq", *c): _start(_SEQ, *c) for c in SEQ_CELLS})
    prefix = {"mesh": "FLOPS="}
    return {c: _result(p, "SEQ=" if c[0] == "seq" else prefix.get(c, "CELL=")) for c, p in procs.items()}


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_dryrun_cell_plans(planned, arch, shape, mesh):
    rc, cell, stderr = planned[(arch, shape, mesh)]
    assert rc == 0 and cell is not None, stderr
    assert cell["status"] == "ok"
    assert cell["chips"] == (512 if mesh == "multi" else 256)
    assert cell["flops_per_device"] > 0 and cell["bytes_per_device"] > 0
    assert cell["memory"]["peak_bytes"] >= cell["memory"]["argument_bytes"] > 0
    assert cell["collective_bytes_per_device"] == sum(cell["collective_by_type"].values()) > 0
    assert cell["params_total"] == configs.get(arch).param_counts()["total"]
    # the kernel ops ran on the stand-ins: every layer's flash attention, and remat's recompute
    want = {"train_4k": 2 * 28, "decode_32k": 0, "long_500k": 0}[shape]
    assert cell["kernel_calls"].get("flash_attention_fwd", 0) == want


@pytest.mark.parametrize("arch,shape,mesh", C4_CELLS)
def test_dryrun_plans_a_train_step_whose_heads_do_not_split_over_tp(planned, arch, shape, mesh):
    """The backward of the attention output's reshape, which DTensor refused
    for these cells before ``transformer._merge_heads`` (ROADMAP §C4)."""
    rc, cell, stderr = planned[(arch, shape, mesh)]
    assert rc == 0 and cell is not None, stderr
    assert cell["status"] == "ok" and cell["overrides"] == {"n_layers": 1}
    assert configs.get(arch).n_heads % 16 != 0 and cell["chips"] == 256
    assert cell["flops_per_device"] > 0 and cell["memory"]["peak_bytes"] >= cell["memory"]["argument_bytes"] > 0
    assert cell["kernel_calls"] == {"flash_attention_fwd": 2}  # the forward and remat's recompute


@pytest.mark.parametrize("arch,mesh", SEQ_CELLS)
def test_dryrun_plans_decode_from_a_sequence_sharded_cache(planned, arch, mesh):
    """A decode step whose KV cache has its slots over tp: against the same
    step with head_dim over tp, each layer's score all-reduce (B x H x S
    fp32 a rank) gives way to three all-reduces, of the parts' maxima and
    exponential sums (B x H fp32 each) and of their weighted v (B x H x Dh),
    and nothing else changes among the collectives. qwen3's command line
    plans the cell and exits 0."""
    rc, out, stderr = planned[("seq", arch, mesh)]
    assert rc == 0 and out is not None, stderr
    cfg, shape = configs.get(arch), configs.SHAPES["decode_32k"]
    b = shape.global_batch // (512 // 16 if mesh == "multi" else 16)  # rank 0's batch rows over dp
    slots = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    h, dh, layers = cfg.n_heads, cfg.head_dim, cfg.n_layers

    def all_reduces(kv):  # (operand bytes, link) of each; the tp group crosses nodes on these meshes
        return Counter((nbytes, link) for kind, nbytes, link in out[kv]["collectives"] if kind == "all_reduce")

    seq, head_dim = all_reduces("seq"), all_reduces("head_dim")
    assert seq - head_dim == Counter({(4 * b * h, "nic"): 2 * layers, (4 * b * h * dh, "nic"): layers})
    assert head_dim - seq == Counter({(4 * b * h * slots, "nic"): layers})
    others = [Counter(tuple(c) for c in out[kv]["collectives"] if c[0] != "all_reduce") for kv in ("seq", "head_dim")]
    assert others[0] == others[1]
    assert out["seq"]["kernel_calls"] == out["head_dim"]["kernel_calls"] == {}
    if "cli" in out:
        code, cell = out["cli"]
        assert code == 0 and cell["status"] == "ok" and cell["overrides"] == {"decode_kv_shard": "seq"}
        assert cell["collective_by_type"]["all_reduce"] == sum(k * n for (k, _), n in seq.items())


KINDS = {"train": configs.Shape("smoke_train", "train", 32, 4),
         "prefill": configs.Shape("smoke_prefill", "prefill", 24, 4),
         "decode": configs.Shape("smoke_decode", "decode", 24, 4)}


def _run_step(cfg, kind, shape, rules=None, device="cpu"):
    """The step of ``kind`` once on seed weights under FlopCounterMode (a
    decode step after a prefill of the shape's length, at its last slot)."""
    params = init_params(T.param_defs(cfg, rules), seed=0, dtype=torch.bfloat16, device=device, rules=rules)
    batch = prompt_batch(cfg, shape.global_batch, shape.seq_len, 0, torch.device(device))
    if kind == "decode":
        caches, logits = make_prefill_step(cfg, shape.seq_len, rules=rules)(params, batch)
        token = greedy_token(cfg, logits)
        with FlopCounterMode(display=False) as fc:
            make_decode_step(cfg, rules=rules)(params, caches, token, shape.seq_len - 1)
        return fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = specs.make_optimizer(cfg)
            make_train_step(cfg, opt, rules=rules)(params, opt.init(params), batch)
        else:
            make_prefill_step(cfg, shape.seq_len, rules=rules)(params, batch)
    return fc.get_total_flops()


# jamba's train step is left out: its Mamba layers' sequential plain scan
# takes ~15 s here, run and plan; its prefill and decode are in
SMOKE = [(a, k) for a in ("qwen3_0_6b", "rwkv6_1_6b", "seamless_m4t_large_v2") for k in sorted(KINDS)] + [
    ("jamba_1_5_large_398b", "prefill"), ("jamba_1_5_large_398b", "decode")]


@pytest.mark.parametrize("arch,kind", SMOKE)
def test_smoke_plan_counts_the_flops_of_a_real_cpu_run(arch, kind):
    cfg = configs.get_smoke(arch).replace(use_pallas="off")
    plan = plan_step(cfg, KINDS[kind])
    assert plan["flops"] == _run_step(cfg, kind, KINDS[kind]) > 0
    assert kernel_calls(plan["ops"]) == {}
    assert plan["memory"]["peak_bytes"] >= plan["memory"]["argument_bytes"] + plan["memory"]["output_bytes"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plan_on_a_one_rank_mesh_counts_the_flops_of_a_real_run(planned, kind):
    rc, flops, stderr = planned["mesh"]
    assert rc == 0 and flops is not None, stderr
    assert flops["plan"][kind] == flops["run"][kind] > 0


_CLI = """
import contextlib, io, json, sys
from pathlib import Path
import repro_torch.launch.dryrun as d
from repro_torch.launch import roofline
d.RESULTS_DIR = Path(sys.argv[1])
codes = []
for argv in (["--arch", "rwkv6_1_6b", "--shape", "long_500k"],
             ["--arch", "qwen3_0_6b", "--shape", "decode_32k", "--tag", "bad", "--override", "n_kv_heads=3"]):
    sys.argv = ["dryrun"] + argv
    try:
        d.main()
    except SystemExit as e:
        codes.append(e.code)
table = io.StringIO()
with contextlib.redirect_stdout(table):
    for argv in (["--markdown"], ["--markdown", "--tag", "bad"]):
        sys.argv = ["roofline"] + argv
        roofline.main()
print("CLI=" + json.dumps({"codes": codes, "table": table.getvalue()}))
"""


def test_command_line_writes_cells_and_fails_on_a_failing_one(tmp_path):
    """``main`` writes the cell's JSON and exits 0; a cell that raises is
    written with status FAILED, its error and the torch version, and the
    run exits 1. The roofline's table holds the first and lists the second."""
    proc = _start(_CLI, str(tmp_path))
    rc, out, stderr = _result(proc, "CLI=")
    assert rc == 0 and out is not None and out["codes"] == [0, 1], stderr
    cell = json.loads((tmp_path / "rwkv6_1_6b.long_500k.pod16x16.json").read_text())
    assert cell["status"] == "ok" and cell["torch"] == torch.__version__
    failed = json.loads((tmp_path / "qwen3_0_6b.decode_32k.pod16x16.bad.json").read_text())
    assert failed["status"] == "FAILED" and failed["error"] and failed["torch"] == torch.__version__
    table = out["table"]
    assert "| rwkv6_1_6b | long_500k | pod16x16 |" in table
    assert "FAILED cells:" in table and f"torch {torch.__version__}" in table


def test_importing_the_launch_tools_starts_no_process_group():
    """The counterpart of test_default_process_sees_one_device: the fake
    process group starts only when a production mesh is made."""
    code = """
import torch.distributed as dist
import repro_torch.launch.dryrun, repro_torch.launch.roofline, repro_torch.launch.mesh
import repro_torch.launch.specs, repro_torch.launch.op_stats
print(dist.is_initialized())
"""
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["False"]
    assert not torch.distributed.is_initialized()
