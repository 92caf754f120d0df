"""device_idle.train: % of a train step's wall time with nothing on the device (its device
busy time in the trace over the mean untraced train step of the window)."""
from chipbench import readers


def read(trace):
    return readers.device_idle(trace, "train")
