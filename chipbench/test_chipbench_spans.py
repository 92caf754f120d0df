"""The readers of the port's program spans on a synthetic trace: each device
operation is matched to the host call that enqueued it by order, each reader
gives its value on its driver's kind, and None on the other kind, where its
span is missing, or where enqueues and device operations do not pair."""
from __future__ import annotations

import pytest

from chipbench import harness, launched, tracing

TRAIN = ("forward_ms.train", "optimizer_ms.train", "backward_ms.train")
SERVE = ("attention_ms.serve", "ffn_ms.serve", "kv_cache_ms.serve")
# per step: (device op, its length in us, the spans its enqueue lies in)
STEP = {"train": [("gemm", 1000.0, ("train forward",)), ("elementwise", 200.0, ("train forward",)),
                  ("sgemm", 1500.0, ()), ("elementwise", 400.0, ()),
                  ("elementwise", 600.0, ("adamw update",)), ("elementwise", 100.0, ("adamw update",))],
        "prompt": [("gemm", 800.0, ("block attention",)), ("flash_fwd", 300.0, ("block attention",)),
                   ("copy", 50.0, ("block attention", "prefill kv cache")),
                   ("gemm", 1200.0, ("block feed-forward",)), ("cat", 60.0, ("prefill kv cache",)),
                   ("gemm", 90.0, ())]}

# the call that enqueues a device op, where not ``cudaLaunchKernel``: cuBLAS launches through the driver
ENQUEUE = {"gemm": "cuLaunchKernelEx", "copy": "cudaMemcpyAsync"}


def trace(kind, drop=(), extra_ops=0):
    """Two steps. Host: a 10 us enqueue call every 100 us, and a span event around each run of
    consecutive enqueues it holds; the device runs each op 1,000 us after its enqueue, or when
    the one before it ends. ``ranges`` holds what the profiler's tree of host events gives where
    the host blocked on a full launch queue, a double count: the readers must not take it."""
    host, kernels, runs = [], [], {}
    t_dev = 0.0
    for i, (name, length, spans) in enumerate(STEP[kind] * 2):
        t_host = 100.0 * i
        host += [(ENQUEUE.get(name, "cudaLaunchKernel"), t_host, 10.0), ("cudaStreamIsCapturing", t_host + 20.0, 1.0)]
        kernels.append((name, max(t_dev, t_host + 1000.0), length))
        t_dev = kernels[-1][1] + length
        for s in spans:
            if s in runs and runs[s][-1][1] == t_host - 100.0:
                runs[s][-1][1] = t_host
            else:
                runs.setdefault(s, []).append([t_host, t_host])
    host += [(s, a - 5.0, b - a + 20.0) for s, rs in runs.items() if s not in drop for a, b in rs]
    kernels += [("memset", t_dev + 10.0 * i, 1.0) for i in range(extra_ops)]  # with no enqueue on the host
    return tracing.Trace(kind=kind, kernels=kernels, ranges={s: 1e6 for s in runs}, steps=2, window_s=0.01,
                         host=host)


def read(name, t):
    return harness.metric_reader(name).read(t)


def test_train_readers():
    t = trace("train")
    assert read("forward_ms.train", t) == pytest.approx(1.2)  # 1,000 + 200 us a step
    assert read("optimizer_ms.train", t) == pytest.approx(0.7)
    assert read("backward_ms.train", t) == pytest.approx(1.9)  # the rest: 1,500 + 400 us
    assert sum(read(n, t) for n in TRAIN) == pytest.approx(launched.device_ms(t))


def test_prompt_readers():
    t = trace("prompt")
    assert read("attention_ms.serve", t) == pytest.approx(1.15)  # the cache build nests inside
    assert read("ffn_ms.serve", t) == pytest.approx(1.2)
    assert read("kv_cache_ms.serve", t) == pytest.approx(0.11)  # the build and the stack


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_reader_finds_nothing_on_the_other_kind(name):
    assert read(name, trace("prompt" if name.endswith(".train") else "train")) is None


@pytest.mark.parametrize("name, missing", [
    ("forward_ms.train", "train forward"), ("optimizer_ms.train", "adamw update"),
    ("backward_ms.train", "train forward"), ("backward_ms.train", "adamw update"),
    ("attention_ms.serve", "block attention"), ("ffn_ms.serve", "block feed-forward"),
    ("kv_cache_ms.serve", "prefill kv cache")])
def test_reader_finds_nothing_without_its_span(name, missing):
    assert read(name, trace("train" if name.endswith(".train") else "prompt", drop=(missing,))) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_reader_finds_nothing_where_enqueues_and_operations_do_not_pair(name):
    assert read(name, trace("train" if name.endswith(".train") else "prompt", extra_ops=1)) is None
