"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the first
steps of the window, reduced to what the metric readers take.

``Trace`` holds the device's operations (kernels, copies and fills, with
their start and length on the profiler's clock), the device time of each
range the program names with ``record_function`` (the kernels launched
inside it, from the host side), the host's operations (to name what the
host was doing in a device gap), the number of steps traced and their wall
time on the host clock. ``kind_of`` is a frozen copy of
``repro_torch/launch/profile_train.py::by_kind``'s classes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# kernel-name fragments of each kind, checked in order; the rest is "elementwise and other".
# fp32 GEMMs come from attention_ref's products (the flash backward); the bf16 ones from the model's.
KINDS = [("flash kernel", ("flash_fwd",)),
         ("WKV kernel", ("rwkv6_",)),
         ("Mamba kernel", ("mamba_scan_",)),
         ("fp32 GEMM", ("sgemm", "f32f32")),
         ("bf16 GEMM", ("gemm", "nvjet", "cutlass", "xmma", "splitkreduce"))]
ELEMENTWISE = "elementwise and other"


def kind_of(name: str) -> str:
    key = name.lower()
    return next((kind for kind, frags in KINDS if any(f in key for f in frags)), ELEMENTWISE)


@dataclass
class Trace:
    kind: str  # the driver's kind: "train" or "prompt"
    kernels: list[tuple[str, float, float]]  # device ops: (name, start us, length us)
    ranges: dict[str, float]  # range name -> device us of the kernels launched inside it
    steps: int  # steps or prompt phases traced
    window_s: float  # their wall time on the host clock
    info: dict = field(default_factory=dict)  # the driver's shapes and counts (see the drivers)
    host: list[tuple[str, float, float]] = field(default_factory=list)  # host ops: (name, start us, length us)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in merged(self.kernels)) / 1e6

    def kind_ms(self, kind: str) -> float:
        """Device ms of the kernels of one kind, per step."""
        return sum(d for n, _, d in self.kernels if kind_of(n) == kind) / 1e3 / self.steps

    def range_ms(self, *names: str) -> float | None:
        """Device ms per step of the kernels launched inside the named ranges;
        None where the trace holds none of them."""
        found = [self.ranges[n] for n in names if n in self.ranges]
        return sum(found) / 1e3 / self.steps if found else None


def merged(kernels) -> list[tuple[float, float]]:
    """The union of the device ops' intervals, as sorted (start, end) us."""
    out: list[list[float]] = []
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(s, e) for s, e in out]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host operation running at the gap's middle."""
    by_name: dict[str, float] = {}
    for n, _, d in trace.kernels:
        by_name[n] = by_name.get(n, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = merged(trace.kernels)
    gaps = sorted(((spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [(d, n) for n, hs, d in trace.host if hs <= mid <= hs + d]
        named.append([min(inside)[1] if inside else "(no host op)", (e - s) / 1e6])
    return {"device_ops": [[n[:160], d / 1e6] for n, d in ops], "idle_gaps": named}


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped by
    the driver around the traced steps (each ends in a synchronise)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def trace(self, kind: str, steps: int, window_s: float, info: dict) -> Trace:
        from torch.autograd import DeviceType

        events = self.prof.events()
        annotations = {e.name for e in events
                       if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False)}
        kernels, host, ranges = [], [], {}
        for e in events:
            start, length = e.time_range.start, e.time_range.end - e.time_range.start
            if e.device_type == DeviceType.CUDA:
                if e.name not in annotations:  # a range's own span on the device covers kernels counted already
                    kernels.append((e.name, start, length))
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, start, length))
                if e.name in annotations:
                    ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total
        if not kernels:
            raise RuntimeError("the profiler recorded no device time")
        return Trace(kind=kind, kernels=kernels, ranges=ranges, steps=steps, window_s=window_s,
                     info=info, host=host)
