"""device_idle.serve: % of a prompt phase's wall time with nothing on the device (its device
busy time in the trace over the mean untraced prompt phase of the window)."""
from chipbench import readers


def read(trace):
    return readers.device_idle(trace, "prompt")
