from .checkpoint import CheckpointManager
from .steps import make_decode_step, make_prefill_step, make_train_step, masked_loss

__all__ = [
    "CheckpointManager",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "masked_loss",
]
