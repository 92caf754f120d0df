"""The port's program spans: ``torch.profiler.record_function`` ranges that
name a piece of a step in a profile, entered only while a profiler runs.

A span is a host event in the same ``torch.profiler`` session as the
kernels, on the same clock; the profiler hangs each kernel on the host op
that launched it, so a span's device time is that of the kernels launched
inside it on its own thread. ``span(name)`` costs one flag check when no
profiler runs (``record_function`` itself costs several microseconds on the
host even then), so a span may sit on the decode path and inside loops over
layers.

Every span in the port, and what reads it (``chipbench/metrics/<name>.py``
for a benchmark metric):

- ``train forward`` (``TRAIN_FORWARD``, ``train/steps.py``): the model's
  forward, the loss and the weighted aux loss of one microbatch; with remat
  the forward alone, since the recompute runs in the backward. Read by
  ``forward_ms.train``, and with ``adamw update`` by ``backward_ms.train``,
  the step's kernels less the two. The backward has no span: on CUDA the
  autograd engine runs it on its own device thread, and a range opened
  around ``torch.autograd.grad`` on the calling thread holds none of its
  kernels.
- ``adamw update`` (``ADAMW_UPDATE``, ``optim/adamw.py``): the whole of
  ``AdamW.update`` (placement, clip, sliced update), once a step. Read by
  ``optimizer_ms.train``.
- ``block attention`` (``BLOCK_ATTENTION``, ``models/transformer.py``): an
  attention layer's self-attention sub-layer in every mode (norm, QKV,
  RoPE, attention, output projection; in prefill the cache build). Read by
  ``attention_ms.serve``.
- ``block feed-forward`` (``BLOCK_FFN``, ``models/transformer.py``): the
  feed-forward sub-layer of an attention or Mamba layer (norm, SwiGLU or
  the MoE layer, whose ranges nest inside it). Read by ``ffn_ms.serve``.
- ``prefill kv cache`` (``PREFILL_KV_CACHE``, ``models/transformer.py``):
  each attention layer's cache build in prefill, nested in ``block
  attention``, and the stack of each pattern position's decode state over
  its repeats after the last block, outside every block. Read by
  ``kv_cache_ms.serve``.
- ``moe dispatch``, ``moe experts``, ``moe combine`` (``models/moe.py``,
  ``moe.RANGES``): the router and the dispatch (twice a MoE layer), the
  expert GEMMs, the combine. ``moe_route_ms.serve`` reads dispatch and
  combine; ``launch/profile_serve.py`` reports all three.
- ``flash_attention backward (attention_ref)``, ``rwkv6 backward
  (rwkv6_ref)``, ``mamba_scan backward (mamba_ref)`` (``kernels/ops.py``,
  ``ops.BACKWARD_RANGES``): each kernel op's backward, entered on the
  autograd thread. ``attn_backward_ms.train`` reads the first;
  ``launch/profile_train.py`` reports all three.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.profiler import record_function

TRAIN_FORWARD = "train forward"
ADAMW_UPDATE = "adamw update"
BLOCK_ATTENTION = "block attention"
BLOCK_FFN = "block feed-forward"
PREFILL_KV_CACHE = "prefill kv cache"

_OFF = nullcontext()  # holds no state, so one serves every span, nested or not


def span(name: str):
    """A context that names its work ``name`` in a running profile: a
    ``record_function`` range while a profiler runs, else a no-op."""
    return record_function(name) if torch.autograd._profiler_enabled() else _OFF
