"""kv_cache_ms.serve: device ms a prompt phase of what the port enqueues inside
its ``prefill kv cache`` span (``repro_torch/models/transformer.py``: each
attention layer's cache build, inside ``block attention``, and the stack of
the caches over the layers after the last block)."""
from chipbench import launched

RANGE = "prefill kv cache"


def read(trace):
    return launched.span_ms(trace, "prompt", RANGE)
