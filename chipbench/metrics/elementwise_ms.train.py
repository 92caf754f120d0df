"""elementwise_ms.train: device ms a train step of the kernels that are
neither a GEMM nor a hand-written kernel (norms, SwiGLU, RoPE, softmax,
casts, AdamW's slices, the loss)."""
from chipbench import readers


def read(trace):
    return readers.elementwise_ms(trace, "train")
