"""mfu.train: the train step's model FLOPs (``costs.train_flops``) over the
window's untraced time, as a % of the bf16 peak."""
from chipbench import readers


def read(trace):
    return readers.mfu(trace, "train")
