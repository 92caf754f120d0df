"""What the per-layer metric files (``metrics/<name>.py``) compute, each from
a ``tracing.Trace`` of the driver kind the metric belongs to. Each returns
None where the trace holds nothing to read, and the harness then leaves the
metric out of the line; a share is never given as 0 for want of a reading.
"""
from __future__ import annotations

from . import costs
from .tracing import ELEMENTWISE, Trace

FLASH = "flash_fwd"  # the flash kernel's forward launches carry this in their name


def mfu(trace: Trace, kind: str) -> float | None:
    """% of the bf16 peak: the model FLOPs of the window's untraced steps
    over their time on the host clock (from the profiler's stop on)."""
    i = trace.info
    if trace.kind != kind or not i.get("run_steps"):
        return None
    return 100.0 * i["flops_per_step"] * i["run_steps"] / i["run_window_s"] / costs.PEAK_BF16_FLOPS


def flash_roofline(trace: Trace, kind: str) -> float | None:
    """% of its roofline the flash forward reaches: over every launch, the
    least time the launch could take (``costs.attention_bound_s`` of the
    cell's attention shape) over its device time, summed."""
    launches = [d for n, _, d in trace.kernels if FLASH in n]
    if trace.kind != kind or not launches:
        return None
    a = trace.info["attn"]
    bound = costs.attention_bound_s(a["b"], a["s"], a["s"], a["h"], a["kv"], a["d"], a["elem_bytes"],
                                    True, a["window"])
    return 100.0 * bound * len(launches) / (sum(launches) / 1e6)


def elementwise_ms(trace: Trace, kind: str) -> float | None:
    """Device ms a step of the kernels that are neither a GEMM nor a hand-written kernel."""
    return trace.kind_ms(ELEMENTWISE) if trace.kind == kind else None


def device_idle(trace: Trace, kind: str) -> float | None:
    """% of a step's wall time in which nothing ran on the device: 1 - the
    traced steps' device busy time a step over the mean step of the window's
    untraced rest on the host clock. The profiler's host work stretches the
    traced steps' wall time, not their kernels, so their own wall time would
    read the profiler's overhead as idle."""
    i = trace.info
    if trace.kind != kind or not i.get("run_steps"):
        return None
    return 100.0 * (1.0 - (trace.busy_s() / trace.steps) / (i["run_window_s"] / i["run_steps"]))


def range_ms(trace: Trace, kind: str, *names: str) -> float | None:
    """Device ms a step of the kernels launched inside the program's named ranges."""
    return trace.range_ms(*names) if trace.kind == kind else None
