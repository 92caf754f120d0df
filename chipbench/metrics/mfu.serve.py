"""mfu.serve: a prompt phase's model FLOPs (``costs.prefill_flops``) over the
window's untraced time, as a % of the bf16 peak."""
from chipbench import readers


def read(trace):
    return readers.mfu(trace, "prompt")
