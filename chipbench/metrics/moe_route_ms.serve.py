"""moe_route_ms.serve: device ms a prompt phase inside the port's MoE ranges
that route (``models/moe.py``: the router, the capacity queue, the one-hot
dispatch and the gather into the expert buffer; the combine back to tokens)."""
from chipbench import readers

RANGES = ("moe dispatch", "moe combine")


def read(trace):
    return readers.range_ms(trace, "prompt", *RANGES)
