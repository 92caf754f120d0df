from . import attention, layers, params, transformer
from .transformer import decode_step, forward_train, param_defs, prefill

__all__ = [
    "attention", "layers", "params", "transformer",
    "decode_step", "forward_train", "param_defs", "prefill",
]
