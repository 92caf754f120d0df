"""ffn_ms.serve: device ms a prompt phase of what the port enqueues inside its
``block feed-forward`` span (``repro_torch/models/transformer.py``: each
layer's norm and SwiGLU, or its MoE layer, whose routing
``moe_route_ms.serve`` also reads)."""
from chipbench import launched

RANGE = "block feed-forward"


def read(trace):
    return launched.span_ms(trace, "prompt", RANGE)
