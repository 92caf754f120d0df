"""Operation and byte counts of the kernel ops, from their shapes alone.

One definition for every reader: the FLOP formulas that ``ops.py``
registers with ``torch.utils.flop_counter`` (so ``FlopCounterMode`` and
the dry-run's ``launch/op_stats.py`` count a kernel op), and the bounds
that ``chip_smoke.py`` holds each kernel's time against. The counts are
the work the function needs, not what a kernel does again: each input
read once and each output written once, and no exponential counted.
Pure Python: a formula is evaluated inside a dispatch mode, where a
tensor op would be seen as one of the program's.
"""
from __future__ import annotations

RWKV_CHUNK = 16  # the TPU kernel's chunk length, whose four products the count follows


def _tri(n: int) -> int:
    return n * (n + 1) // 2 if n > 0 else 0


def attention_pairs(sq: int, sk: int, causal: bool = True, window: int | None = None) -> int:
    """Unmasked (row, col) pairs of one head: row i sees cols up to i when
    causal, and from i - window + 1 with a window."""
    if not causal:
        return sq * sk
    # rows past sk + window - 1 see nothing; below that, hi(i) = min(i + 1, sk)
    # and lo(i) = max(i - window + 1, 0)
    n = min(sq, sk + window) if window else sq
    hi = _tri(min(n, sk)) + max(n - sk, 0) * sk
    lo = _tri(n - window) if window else 0
    return hi - lo


def attention_flops(b: int, sq: int, sk: int, h: int, d: int, causal: bool = True,
                    window: int | None = None) -> int:
    """4 * Dh flops per unmasked (row, col) pair per head: q k^T and p v."""
    return 4 * d * attention_pairs(sq, sk, causal, window) * b * h


def attention_bytes(b: int, sq: int, sk: int, h: int, kv: int, d: int, elem_bytes: int) -> int:
    """q, k and v read once, o written once."""
    return elem_bytes * (2 * b * sq * h * d + 2 * b * sk * kv * d)


def rwkv6_flops(b: int, s: int, h: int, d: int) -> int:
    """The TPU kernel's four products, 4 (L Dh + Dh^2) flops per step per
    (b, h) with L = 16 (at S = 512 the plain recurrence's 5 Dh^2 a step)."""
    return 4 * (RWKV_CHUNK * d + d * d) * b * h * s


def rwkv6_bytes(b: int, s: int, h: int, d: int, elem_bytes: int, u_elem_bytes: int,
                with_state0: bool) -> int:
    """r, k, v, logw, u (and state0) read once; out and the fp32 state written once."""
    state = 4 * b * h * d * d
    return 5 * b * s * h * d * elem_bytes + h * d * u_elem_bytes + state + (state if with_state0 else 0)


def mamba_flops(b: int, s: int, di: int, st: int) -> int:
    """6 fp32 operations per state update: dt A, its exponential, the decay,
    dt u B, the add and h C."""
    return 6 * b * s * di * st


def mamba_bytes(b: int, s: int, di: int, st: int, elem_bytes: int, with_h0: bool) -> int:
    """u, dt, B, C and A (and h0) read once; y and the fp32 h written once."""
    h = 4 * b * di * st
    return 3 * b * s * di * elem_bytes + 2 * b * s * st * elem_bytes + 4 * di * st + h + (h if with_h0 else 0)
