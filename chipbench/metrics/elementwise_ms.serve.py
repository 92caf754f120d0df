"""elementwise_ms.serve: device ms a prompt phase of the kernels that are
neither a GEMM nor a hand-written kernel (norms, SwiGLU, RoPE, the MoE
one-hots and cumsum, casts, the cache's copies)."""
from chipbench import readers


def read(trace):
    return readers.elementwise_ms(trace, "prompt")
