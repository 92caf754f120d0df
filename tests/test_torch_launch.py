"""The port's launch tools against the JAX package's: the shape grid and its
skip rule, the input stand-ins leaf by leaf (unsharded, and each rank-0
shard on the production meshes), the roofline terms; and, against values
computed by hand, the per-device FLOP rule on a sharded product, the
collective bytes and op histogram of a redistribution, the memory peak, and
the three kernel ops' fake implementations and FLOP formulas.

The production meshes are built here over a fake process group (no card,
no processes), started for the tests that need one and destroyed after.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import make_rules as jax_make_rules  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.sharding import placements, rules_for  # noqa: E402
from repro_torch.kernels import costs, ops  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import roofline, specs  # noqa: E402
from repro_torch.launch.op_stats import OpStats, op_histogram  # noqa: E402

PAIRS = list(itertools.product(configs.ARCH_IDS, configs.SHAPES))
_JAX_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cell_runnable_equals_the_reference(arch, shape):
    assert configs.SHAPES[shape] == configs.Shape(*vars(jconfigs.SHAPES[shape]).values())
    assert configs.cell_runnable(configs.get(arch), configs.SHAPES[shape]) == jconfigs.cell_runnable(
        jconfigs.get(arch), jconfigs.SHAPES[shape])
    assert configs.is_subquadratic(configs.get(arch)) == jconfigs.is_subquadratic(jconfigs.get(arch))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _port_inputs(arch, shape, rules):
    cfg = configs.get(arch)
    return specs.input_specs(cfg, configs.SHAPES[shape], rules)


def _ref_inputs(arch, shape, mesh):
    cfg = jconfigs.get(arch)
    rules = None if mesh is None else jax_make_rules(
        mesh, seq_shard_residual=cfg.seq_shard_residual, kv_shard=cfg.decode_kv_shard,
        expert_axis=cfg.moe_expert_axis, fsdp=cfg.fsdp_params)
    return jspecs.input_specs(cfg, jconfigs.SHAPES[shape], mesh, rules)


def _split_decode(port, ref):
    """(port leaves, reference leaves) by path; the decode position apart:
    the port's is an int (its decode_step takes one), the reference's a
    0-d int32 stand-in."""
    if isinstance(port, tuple):
        (pc, pt, ppos), (rc, rt, rpos) = port, ref
        assert rpos.shape == () and rpos.dtype == jnp.int32
        return ppos, dict(_flat({"caches": pc, "token": pt})), dict(_flat({"caches": rc, "token": rt}))
    return None, dict(_flat(port)), dict(_flat(ref))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_equal_the_reference_unsharded(arch, shape):
    """Every leaf's shape and dtype, and nothing allocated: meta tensors."""
    pos, port, ref = _split_decode(_port_inputs(arch, shape, None), _ref_inputs(arch, shape, None))
    assert sorted(port) == sorted(ref)
    for path, r in ref.items():
        t = port[path]
        assert (tuple(t.shape), t.dtype, t.device.type) == (r.shape, _JAX_DTYPES[r.dtype.type], "meta"), path
    if pos is not None:
        assert pos == configs.SHAPES[shape].seq_len - 1


@pytest.fixture(scope="module", params=["single", "multi"])
def production(request):
    """The production mesh on a fake process group of 256 or 512 ranks, and
    the JAX package's AbstractMesh of the same axes."""
    multi = request.param == "multi"
    assert not dist.is_initialized()
    mesh = launch_mesh.make_production_mesh(multi_pod=multi)
    try:
        shape, axes = launch_mesh.mesh_shape(multi)
        yield mesh, AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


def test_production_mesh_is_the_reference_shape(production):
    mesh, jmesh = production
    assert tuple(mesh.mesh_dim_names) == tuple(jmesh.axis_names)
    assert tuple(mesh.shape) == tuple(jmesh.shape.values())
    assert dist.get_world_size() == mesh.size() and dist.get_rank() == 0 and dist.get_backend() == "fake"
    with pytest.raises(RuntimeError, match="already started"):
        launch_mesh.start_fake_world(7)


@pytest.mark.parametrize("shape", list(configs.SHAPES))
def test_sharded_input_specs_equal_the_reference(production, shape):
    """On each production mesh, under the config's rules, every leaf of
    every architecture: its global shape and dtype, its placements (the
    reference's spec), and rank 0's local shard (the reference's shard
    shape). long_500k's single sequence is replicated."""
    mesh, jmesh = production
    for arch in configs.ARCH_IDS:
        pos, port, ref = _split_decode(_port_inputs(arch, shape, rules_for(configs.get(arch), mesh)),
                                       _ref_inputs(arch, shape, jmesh))
        assert sorted(port) == sorted(ref)
        for path, r in ref.items():
            t = port[path]
            assert isinstance(t, DTensor) and t._local_tensor.device.type == "meta", path
            assert (tuple(t.shape), t.dtype) == (r.shape, _JAX_DTYPES[r.dtype.type]), path
            assert t.placements == placements(r.sharding.spec, mesh), path
            assert tuple(t._local_tensor.shape) == r.sharding.shard_shape(r.shape), path
        tokens = port.get("/tokens", port.get("/token"))
        if configs.SHAPES[shape].global_batch == 1:
            assert all(isinstance(p, Replicate) for p in tokens.placements)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x22b"])
def test_sequence_sharded_kv_cache_specs_equal_the_reference(production, arch):
    """decode_32k's stand-ins with the KV cache's slots over tp
    (``decode_kv_shard="seq"``, the reference's ``P(dp, tp, None, None)``):
    every leaf's placements and rank 0's shard shape equal the reference's
    on the AbstractMesh of the same axes."""
    mesh, jmesh = production
    shape = configs.SHAPES["decode_32k"]
    cfg = configs.get(arch).replace(decode_kv_shard="seq")
    jcfg = jconfigs.get(arch).replace(decode_kv_shard="seq")
    jrules = jax_make_rules(jmesh, seq_shard_residual=jcfg.seq_shard_residual, kv_shard="seq",
                            expert_axis=jcfg.moe_expert_axis, fsdp=jcfg.fsdp_params)
    _, port, ref = _split_decode(specs.input_specs(cfg, shape, rules_for(cfg, mesh)),
                                 jspecs.input_specs(jcfg, jconfigs.SHAPES["decode_32k"], jmesh, jrules))
    assert sorted(port) == sorted(ref)
    dp = ("pod", "data") if len(jmesh.axis_names) == 3 else "data"
    kv_paths = [p for p in ref if p.endswith(("/k", "/v"))]
    assert kv_paths
    for path, r in ref.items():
        t = port[path]
        assert (tuple(t.shape), t.dtype) == (r.shape, _JAX_DTYPES[r.dtype.type]), path
        assert t.placements == placements(r.sharding.spec, mesh), path
        assert tuple(t._local_tensor.shape) == r.sharding.shard_shape(r.shape), path
        if path in kv_paths:
            assert tuple(r.sharding.spec) == (None, dp, "model", None, None), path


def _probe_product(mesh):
    """A bf16 [4096,1024] @ [1024,1024] on the (data, model) dims, the first
    (Shard(0), Replicate()), the second (Replicate(), Shard(1)): its output
    is (Shard(0), Shard(1)). A pod dim in front replicates all three."""
    pod = [Replicate()] * (mesh.ndim - 2)
    a = DTensor.from_local(torch.empty(256, 1024, dtype=torch.bfloat16, device="meta"), mesh,
                           pod + [Shard(0), Replicate()], run_check=False, shape=(4096, 1024), stride=(1024, 1))
    b = DTensor.from_local(torch.empty(1024, 64, dtype=torch.bfloat16, device="meta"), mesh,
                           pod + [Replicate(), Shard(1)], run_check=False, shape=(1024, 1024), stride=(1024, 1))
    return pod, a, b


def test_per_device_flops_of_a_sharded_product(production):
    """FlopCounterMode counts a DTensor op at its global shape; OpStats
    counts rank 0's share: the global FLOPs over the size of every mesh dim
    where the output is sharded (data and model, 256), and not over the
    pod dim, where it is replicated (every pod computes it)."""
    mesh, _ = production
    pod, a, b = _probe_product(mesh)
    with FlopCounterMode(display=False) as fc:
        a @ b
    with OpStats() as st:
        c = a @ b
    assert fc.get_total_flops() == 2 * 4096 * 1024 * 1024 == 8_589_934_592
    assert c.placements == (*pod, Shard(0), Shard(1))
    assert st.flops == 8_589_934_592 // 256
    assert st.collective_count == 0 and st.ops["aten.mm"] == 1


def test_redistribute_collective_bytes_and_histogram(production):
    """(Shard(0), Shard(1)) -> (Shard(0), Replicate()): one all-gather over
    the 'model' group of the bf16 [256, 64] shard, 32,768 operand bytes,
    across nodes (16 consecutive ranks)."""
    mesh, _ = production
    pod, a, b = _probe_product(mesh)
    c = a @ b
    st = OpStats()
    st.track(c)
    with st:
        d = c.redistribute(mesh, pod + [Shard(0), Replicate()])
    assert tuple(d._local_tensor.shape) == (256, 1024)
    assert dict(st.collective_by_type) == {"all_gather_into_tensor": 256 * 64 * 2} == {"all_gather_into_tensor": 32768}
    assert dict(st.collective_by_link) == {"nic": 32768}
    assert st.collective_count == 1 and st.collective_bytes == 32768
    hist = op_histogram(st.ops)
    assert hist["_c10d_functional.all_gather_into_tensor"] == 1
    assert list(hist.values()) == sorted(hist.values(), reverse=True)
    assert st.peak >= st.live >= 256 * 1024 * 2  # the gathered shard is live in d


def test_link_of_a_group():
    assert launch_mesh.link_of([0]) == "local"
    assert launch_mesh.link_of(list(range(8))) == "nvlink"
    assert launch_mesh.link_of(list(range(16))) == "nic"
    assert launch_mesh.link_of(list(range(0, 256, 16))) == "nic"


def test_memory_peak_of_a_known_sequence():
    """Live bytes rise with each new storage (rounded up to 512 bytes) and
    fall when its last reference dies; a view adds nothing."""
    st = OpStats()
    a = torch.empty(1 << 20, device="meta")  # 4 MiB, made before: tracked as an argument
    st.track({"a": a})
    with st:
        b = a * 2  # 8 MiB live
        v = b.view(-1, 4)  # a view: no new storage
        del b
        c = v + 1  # 12 MiB live at the peak
        del v
        d = torch.empty(3, device="meta")  # 12 bytes: one 512-byte block
    assert st.peak == 3 * 4 << 20
    assert st.live == 2 * (4 << 20) + 512
    assert st.bytes == 2 * (4 << 20) * 2  # two elementwise ops read 4 MiB and write 4 MiB; empty moves nothing
    del c, d


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (64, 64, True, 16), (512, 512, True, 4096), (8192, 8192, True, 4096),
    (40, 17, True, None), (17, 40, True, 8), (40, 17, True, 8), (128, 128, False, None), (1, 300, True, None),
])
def test_attention_pairs_count_every_unmasked_pair(sq, sk, causal, window):
    rows = np.arange(sq)
    hi = np.minimum(rows + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(rows - window + 1, 0) if (causal and window) else np.zeros(sq, np.int64)
    assert costs.attention_pairs(sq, sk, causal, window) == int(np.maximum(hi - lo, 0).sum())


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", [
    (8, 512, 512, 16, 8, 128, True, None), (2, 128, 128, 16, 16, 64, False, None), (1, 300, 300, 48, 8, 128, True, 64),
])
def test_flash_op_fake_and_formula(dtype, b, sq, sk, h, kv, d, causal, window):
    q, k = _meta((b, sq, h, d), dtype), _meta((b, sk, kv, d), dtype)
    with FlopCounterMode(display=False) as fc:
        o = ops.flash_attention(q, k, k, causal, window)
    assert (tuple(o.shape), o.dtype, o.device.type, o.is_contiguous()) == ((b, sq, h, d), dtype, "meta", True)
    assert fc.get_total_flops() == costs.attention_flops(b, sq, sk, h, d, causal, window)
    with FakeTensorMode():  # a fake tensor reaches the op's fake implementation too
        o = ops.flash_attention_fwd(torch.empty(b, sq, h, d, dtype=dtype), torch.empty(b, sk, kv, d, dtype=dtype),
                                    torch.empty(b, sk, kv, d, dtype=dtype), causal=causal, window=window)
    assert (tuple(o.shape), o.dtype) == ((b, sq, h, d), dtype)
    assert costs.attention_flops(8, 512, 512, 16, 128) == 4 * 128 * (512 * 513 // 2) * 8 * 16


@pytest.mark.parametrize("b,s,h,d,state", [(8, 512, 32, 64, False), (2, 17, 4, 96, True)])
def test_rwkv6_op_fake_and_formula(b, s, h, d, state):
    r = _meta((b, s, h, d))
    with FlopCounterMode(display=False) as fc:
        out, st = ops.rwkv6(r, r, r, r, _meta((h, d), torch.float32),
                            _meta((b, h, d, d), torch.float32) if state else None)
    assert (tuple(out.shape), out.dtype) == ((b, s, h, d), torch.bfloat16)
    assert (tuple(st.shape), st.dtype, st.device.type) == ((b, h, d, d), torch.float32, "meta")
    assert fc.get_total_flops() == costs.rwkv6_flops(b, s, h, d) == 4 * (16 * d + d * d) * b * h * s
    with FakeTensorMode():
        x = torch.empty(b, s, h, d, dtype=torch.bfloat16)
        out, st = ops.rwkv6_fwd(x, x, x, x, torch.empty(h, d), None)
    assert (tuple(out.shape), tuple(st.shape), st.dtype) == ((b, s, h, d), (b, h, d, d), torch.float32)


@pytest.mark.parametrize("b,s,di,st,state", [(8, 512, 16384, 16, False), (1, 40, 200, 4, True)])
def test_mamba_op_fake_and_formula(b, s, di, st, state):
    u, bc = _meta((b, s, di)), _meta((b, s, st))
    with FlopCounterMode(display=False) as fc:
        y, h = ops.mamba_scan(u, u, _meta((di, st), torch.float32), bc, bc,
                              _meta((b, di, st), torch.float32) if state else None)
    assert (tuple(y.shape), y.dtype) == ((b, s, di), torch.bfloat16)
    assert (tuple(h.shape), h.dtype, h.device.type) == ((b, di, st), torch.float32, "meta")
    assert fc.get_total_flops() == costs.mamba_flops(b, s, di, st) == 6 * b * s * di * st
    with FakeTensorMode():
        x, bc = torch.empty(b, s, di, dtype=torch.bfloat16), torch.empty(b, s, st, dtype=torch.bfloat16)
        y, h = ops.mamba_scan_fwd(x, x, torch.empty(di, st), bc, bc, None)
    assert (tuple(y.shape), tuple(h.shape), h.dtype) == ((b, s, di), (b, di, st), torch.float32)


def test_kernel_ops_have_no_cpu_implementation():
    """A CPU tensor takes the plain version in the wrapper; given to the op
    itself it raises, and never falls back."""
    x = torch.zeros(1, 4, 1, 16)
    with pytest.raises(NotImplementedError):
        ops.flash_attention_fwd(x, x, x, causal=True, window=None)
    with pytest.raises(NotImplementedError):
        ops.mamba_scan_fwd(x[0], x[0], torch.zeros(16, 4), torch.zeros(4, 1, 4), torch.zeros(4, 1, 4), None)


CELLS = [
    dict(arch="x", shape="train_4k", mesh="pod16x16", kind="train", chips=256, seq_len=4096, global_batch=256,
         flops_per_device=197e12, bytes_per_device=819e9 * 2, collective_bytes_per_device=50e9 * 0.5,
         params_active=1e9, params_total=1e9,
         memory={"argument_bytes": 2**30, "temp_bytes": 2**30, "output_bytes": 0}),
    dict(arch="y", shape="decode_32k", mesh="pod2x16x16", kind="decode", chips=512, seq_len=32768,
         global_batch=128, flops_per_device=4.3e9, bytes_per_device=2.2e10, collective_bytes_per_device=4.7e8,
         params_active=6e8, params_total=6e8,
         memory={"argument_bytes": 19 * 2**30, "temp_bytes": 3 * 2**29, "output_bytes": 2**20}),
    dict(arch="z", shape="prefill_32k", mesh="pod16x16", kind="prefill", chips=256, seq_len=32768,
         global_batch=32, flops_per_device=3.4e13, bytes_per_device=1e11, collective_bytes_per_device=0.0,
         params_active=3e9, params_total=4e10,
         memory={"argument_bytes": 90 * 2**30, "temp_bytes": 0, "output_bytes": 0}),
]


@pytest.mark.parametrize("cell", CELLS, ids=[c["kind"] for c in CELLS])
def test_roofline_terms_equal_the_reference_with_h100_constants(cell, monkeypatch):
    """The reference's ``analyze`` with its TPU constants swapped for the
    H100's (its one link for the NIC, which every production-mesh group
    crosses) gives the port's terms; 'fits' is held at 80 GB."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", launch_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", launch_mesh.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", launch_mesh.NIC_BW)
    got, want = roofline.analyze(cell), jroofline.analyze(cell)
    for key in ("arch", "shape", "mesh", "kind", "chips", "dominant", "collective_by_type"):
        assert got[key] == want[key], key
    for key in ("compute_s", "memory_s", "collective_s", "bound_step_s", "roofline_fraction", "model_flops",
                "useful_compute_ratio", "hbm_gib_per_device"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert roofline.model_flops(cell) == jroofline.model_flops(cell)
    assert got["fits_h100_80g"] == (want["hbm_gib_per_device"] * 2**30 < launch_mesh.HBM_BYTES)
    assert abs(got["compute_s"] - cell["flops_per_device"] / 989e12) < 1e-12


def test_roofline_charges_each_link_its_rate():
    cell = {**CELLS[0], "collective_bytes_by_link": {"nvlink": 450e9, "nic": 50e9, "local": 1e12}}
    assert roofline.analyze(cell)["collective_s"] == pytest.approx(2.0)
    assert roofline.fmt_s(2.5) == "2.50s" and roofline.fmt_s(0.0025) == "2.5ms" and roofline.fmt_s(2.5e-5) == "25us"
    table = roofline.markdown_table([roofline.analyze(c) for c in CELLS])
    assert table.count("\n") == 1 + len(CELLS) and "**collective**" in table and "**compute**" in table
