"""Device time of the operations a program span enqueued, each matched to
the host call that enqueued it by order.

``tracing.Trace.ranges`` takes a range's device time from the profiler's
tree of host events (``device_time_total``), and that tree counts a kernel
twice where the host blocked on a full launch queue: the profiler's
``Command Buffer Full`` host event carries the kernels of the op it
interrupted, and nests inside that op. On an H100 with torch 2.11 the tree
read AdamW's 330 ms a phi3-mini step (B=16 x 512) as 571 ms, and a phi3-mini
prompt batch's attention and feed-forward (319 of its 330 ms) as 417 ms;
ranges whose host keeps no more than a queue's length ahead of the device
read right.

Here no tree is used. The port runs on one stream, where the device runs
its operations in the order the host enqueued them, so the n-th enqueue
call on the host's clock (a launch, an async copy or fill) is the n-th
device operation. A span holds the device operations enqueued inside its
host interval, on whichever thread. Where the two counts differ the match
is unknown, and nothing is read.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right

from .tracing import Trace, merged


def enqueues(name: str) -> bool:
    """Whether a host event is a CUDA runtime or driver call that puts one
    operation on the stream: a kernel launch (``cudaLaunchKernel``, cuBLAS's
    ``cuLaunchKernelEx``, ...), a copy or a fill."""
    return name.startswith("cu") and any(w in name for w in ("Launch", "Memcpy", "Memset"))


def span_ms(trace: Trace, kind: str, *names: str) -> float | None:
    """Device ms a step of the operations enqueued inside the host spans
    ``names`` (their union, so nested spans count once); None on another
    driver kind, without such a span, or where enqueues and device
    operations do not pair one to one."""
    if trace.kind != kind:
        return None
    spans = merged((n, s, d) for n, s, d in trace.host if n in names)
    enqueued = sorted(s for n, s, _ in trace.host if enqueues(n))
    ops = sorted(trace.kernels, key=lambda k: k[1])
    if not spans or len(enqueued) != len(ops):
        return None
    total = 0.0
    for start, end in spans:
        total += sum(d for _, _, d in ops[bisect_left(enqueued, start):bisect_right(enqueued, end)])
    return total / 1e3 / trace.steps


def device_ms(trace: Trace) -> float:
    """Device ms a step of every operation in the trace."""
    return sum(d for _, _, d in trace.kernels) / 1e3 / trace.steps
