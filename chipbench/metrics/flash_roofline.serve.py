"""flash_roofline.serve: the flash forward's share of its roofline in a
prompt phase."""
from chipbench import readers


def read(trace):
    return readers.flash_roofline(trace, "prompt")
