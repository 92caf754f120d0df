"""forward_ms.train: device ms a train step of what the port enqueues inside
its ``train forward`` span (``repro_torch/train/steps.py``: the model's
forward, the loss and the weighted aux loss, once a microbatch; with remat
the forward alone, since the recompute runs in the backward)."""
from chipbench import launched

RANGE = "train forward"


def read(trace):
    return launched.span_ms(trace, "train", RANGE)
