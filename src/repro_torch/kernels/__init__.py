"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  csrc/<name>.cu — the CUDA C++ kernel, built with nvcc on first use (build.py),
  <name>.py      — its ctypes wrapper (checks, launch, launch count),
  ops.py         — model-layout wrappers: plain version on CPU, kernel on CUDA
                   (a custom op with a fake implementation for meta tensors),
  ref.py         — the plain versions the kernels are held against,
  costs.py       — their FLOP and byte counts (the ops' FLOP formulas, the bounds).
"""
from . import ops, ref
from .ops import flash_attention, mamba_scan, rwkv6

__all__ = ["ops", "ref", "flash_attention", "mamba_scan", "rwkv6"]
