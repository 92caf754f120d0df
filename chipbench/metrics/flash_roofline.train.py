"""flash_roofline.train: the flash forward's share of its roofline in a
train step (forward and remat's recompute launches)."""
from chipbench import readers


def read(trace):
    return readers.flash_roofline(trace, "train")
