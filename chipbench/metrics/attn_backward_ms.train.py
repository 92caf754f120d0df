"""attn_backward_ms.train: device ms a train step inside the port's range
around the flash op's backward (``kernels/ops.py``: a recompute through the
plain attention and its vector-Jacobian product)."""
from chipbench import readers

RANGE = "flash_attention backward (attention_ref)"


def read(trace):
    return readers.range_ms(trace, "train", RANGE)
