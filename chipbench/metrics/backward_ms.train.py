"""backward_ms.train: device ms a train step of every device operation outside
the port's ``train forward`` and ``adamw update`` spans: the step's
operations less the two (each matched to its span by ``launched.span_ms``).
That is remat's recompute, every vector-Jacobian product, the flash op's
backward (``attn_backward_ms.train`` is a part of it) and the driver's one
``randint`` a step. The backward has no span of its own: on CUDA the
autograd engine runs it on its own thread, and a range around
``torch.autograd.grad`` would hold none of its kernels."""
from chipbench import launched

FORWARD, OPTIMIZER = "train forward", "adamw update"


def read(trace):
    forward = launched.span_ms(trace, "train", FORWARD)
    optimizer = launched.span_ms(trace, "train", OPTIMIZER)
    if forward is None or optimizer is None:
        return None
    return launched.device_ms(trace) - forward - optimizer
