"""Each per-layer metric's reader on a synthetic trace."""
from __future__ import annotations

import pytest

from chipbench import costs, harness, tracing

ATTN = {"b": 1, "s": 8192, "h": 48, "kv": 8, "d": 128, "window": None, "elem_bytes": 2}


def trace(kind="prompt", **info):
    # two steps on the profiler's clock (us): per step a GEMM, a flash launch, an
    # elementwise kernel, with a 100 us gap between the steps; 10,000 us of wall time
    kernels = []
    for t0 in (0.0, 3000.0):
        kernels += [("sm90_xmma_gemm_bf16", t0, 1000.0), ("flash_fwd_kernel", t0 + 1000, 1500.0),
                    ("vectorized_elementwise_kernel", t0 + 2500, 400.0)]
    host = [("aten::mm", 0.0, 2900.0), ("aten::copy_", 2900.0, 100.0), ("aten::mm", 3000.0, 3000.0)]
    return tracing.Trace(kind=kind, kernels=kernels, ranges={"moe dispatch": 600.0, "moe combine": 200.0,
                                                             "flash_attention backward (attention_ref)": 900.0},
                         steps=2, window_s=0.01, host=host,
                         info={"attn": ATTN, "flops_per_step": 1e12, "run_steps": 10, "run_window_s": 0.5, **info})


def read(name, t):
    return harness.metric_reader(name).read(t)


def test_kinds_and_union():
    assert tracing.kind_of("sm90_xmma_gemm_bf16bf16") == "bf16 GEMM"
    assert tracing.kind_of("void flash_fwd_kernel<...>") == "flash kernel"
    assert tracing.kind_of("ampere_sgemm_128x64") == "fp32 GEMM"
    assert tracing.kind_of("elementwise_kernel") == tracing.ELEMENTWISE
    assert tracing.merged([("a", 0, 10), ("b", 5, 10), ("c", 20, 1)]) == [(0, 15), (20, 21)]
    assert trace().busy_s() == pytest.approx(5800e-6)


def test_readers_on_their_kind():
    t = trace()
    assert read("device_idle.serve", t) == pytest.approx(100 * (1 - 5800e-6 / 2 / (0.5 / 10)))
    assert read("elementwise_ms.serve", t) == pytest.approx(0.4)
    assert read("moe_route_ms.serve", t) == pytest.approx(0.4)  # (600 + 200) us over 2 steps
    assert read("mfu.serve", t) == pytest.approx(100 * 1e12 * 10 / 0.5 / costs.PEAK_BF16_FLOPS)
    bound = costs.attention_bound_s(1, 8192, 8192, 48, 8, 128, 2)
    assert read("flash_roofline.serve", t) == pytest.approx(100 * bound * 2 / 3000e-6)
    tt = trace("train")
    assert read("attn_backward_ms.train", tt) == pytest.approx(0.45)
    assert read("mfu.train", tt) == read("mfu.serve", t)


def test_readers_find_nothing_elsewhere():
    t = trace()
    for name in ("device_idle.train", "elementwise_ms.train", "mfu.train", "flash_roofline.train",
                 "attn_backward_ms.train"):
        assert read(name, t) is None
    bare = trace(run_steps=0)
    bare.kernels = [k for k in bare.kernels if "flash" not in k[0]]
    bare.ranges = {}
    assert read("flash_roofline.serve", bare) is None and read("moe_route_ms.serve", bare) is None
    assert read("mfu.serve", bare) is None and read("device_idle.serve", bare) is None


def test_breakdown_names_the_host_in_each_gap():
    b = tracing.breakdown(trace())
    assert b["device_ops"][0] == ["flash_fwd_kernel", 3000e-6]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(100e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
