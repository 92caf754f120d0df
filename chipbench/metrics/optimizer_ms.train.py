"""optimizer_ms.train: device ms a train step of what the port enqueues inside
its ``adamw update`` span (``repro_torch/optim/adamw.py``: the whole of
``AdamW.update``, the gradients' placement, the clip by global norm and the
sliced update of the weights and moments)."""
from chipbench import launched

RANGE = "adamw update"


def read(trace):
    return launched.span_ms(trace, "train", RANGE)
