"""attention_ms.serve: device ms a prompt phase of what the port enqueues
inside its ``block attention`` span (``repro_torch/models/transformer.py``:
each attention layer's norm, QKV projections, RoPE, flash, output projection
and the KV cache build, which ``kv_cache_ms.serve`` also reads)."""
from chipbench import launched

RANGE = "block attention"


def read(trace):
    return launched.span_ms(trace, "prompt", RANGE)
