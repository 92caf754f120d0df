"""Content-defined chunking for the annex data plane (DESIGN.md §12); the
port's copy of ``repro.core.chunks``, so the same bytes cut into the same
chunks, hence the same chunk keys, in either package.

Large annex objects are cut into *chunks* at boundaries chosen by the
content itself, so an insertion or a localized overwrite only changes the
chunks it touches — every other chunk keeps its byte string, hence its
content address, hence its storage. This is what makes step N+1 of a
checkpoint campaign ingest only its delta.

Boundary rule
-------------
The cutter slides an 8-byte window over the stream. At position ``i`` the
window value is the little-endian integer of ``bytes[i-7..i]`` (zero-padded
at stream start), mixed by a 64-bit multiplicative hash:

    H_i = sum_{k=0..7} b[i-k] << 8k          (== (H_{i-1} << 8 | b[i]) mod 2^64)
    G_i = (H_i * 0x9E3779B97F4A7C15) mod 2^64

Position ``i`` is a *candidate* boundary iff the top ``avg_bits`` bits of
``G_i`` are all ones — probability 2^-avg_bits per position, so candidate
gaps are geometric with mean 2^avg_bits. Requiring the all-ones residue
(not zero) means runs of constant bytes — zero pages in checkpoints —
produce *no* candidates and fall through to the fixed-size ``max_size``
fallback, instead of degenerating into a boundary at every offset.

Cut selection is greedy: the first candidate at least ``min_size`` bytes
after the previous cut wins; if none appears within ``max_size`` bytes the
cutter forces a fixed-size cut there (the fallback also bounds manifest
size and reassembly memory). Boundaries are a pure function of stream
content — independent of how the stream is split into ``feed()`` blocks —
which the tests assert by re-feeding the same bytes in random block sizes.

The hot path is vectorized with numpy (8 shift-adds + 1 multiply + 1
compare per byte, no gathers); blocks under 1 KiB take a bit-identical
pure-Python scan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_WINDOW = 8
_MIX = 0x9E3779B97F4A7C15
_M64 = (1 << 64) - 1

DEFAULT_MIN_SIZE = 1 << 16   # 64 KiB
DEFAULT_AVG_BITS = 17        # mean candidate gap 128 KiB
DEFAULT_MAX_SIZE = 1 << 20   # 1 MiB fixed-size fallback


@dataclass(frozen=True)
class ChunkParams:
    """Cutter parameters. Part of a store's configuration — two stores
    exchanging *manifests* need not agree on them (chunk keys are content
    addresses regardless of who cut them), but deterministic dedup across
    sessions of one repository requires the repo-wide values persisted in
    ``config.json``."""

    min_size: int = DEFAULT_MIN_SIZE
    avg_bits: int = DEFAULT_AVG_BITS
    max_size: int = DEFAULT_MAX_SIZE

    def __post_init__(self):
        if not (0 < self.min_size <= self.max_size):
            raise ValueError(
                f"need 0 < min_size <= max_size, got {self.min_size}/{self.max_size}"
            )
        if not (1 <= self.avg_bits <= 48):
            raise ValueError(f"avg_bits out of range: {self.avg_bits}")

    def to_json(self) -> dict:
        return {
            "min_size": self.min_size,
            "avg_bits": self.avg_bits,
            "max_size": self.max_size,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ChunkParams":
        return cls(
            min_size=int(d["min_size"]),
            avg_bits=int(d["avg_bits"]),
            max_size=int(d["max_size"]),
        )


def _candidates_numpy(data: bytes, bits: int) -> list[int]:
    s = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    h = s.copy()
    for k in range(1, _WINDOW):
        h[k:] += s[:-k] << np.uint64(8 * k)
    g = h * np.uint64(_MIX)
    mask = np.uint64(((1 << bits) - 1) << (64 - bits))
    return np.nonzero((g & mask) == mask)[0].tolist()


def _candidates_python(data: bytes, bits: int, h: int = 0) -> list[int]:
    out = []
    target = (1 << bits) - 1
    shift = 64 - bits
    for i, b in enumerate(data):
        h = ((h << 8) | b) & _M64
        if ((h * _MIX) & _M64) >> shift == target:
            out.append(i)
    return out


class Cutter:
    """Streaming re-segmenter: ``feed()`` arbitrary byte blocks, receive
    content-defined chunks; ``finish()`` flushes the tail (possibly shorter
    than ``min_size``). Memory is bounded by ``max_size`` plus one block."""

    def __init__(self, params: ChunkParams | None = None):
        self.params = params or ChunkParams()
        self._pending = bytearray()   # stream bytes not yet emitted
        self._emitted = 0             # absolute offset of _pending[0]
        self._fed = 0                 # absolute offset of next byte to feed
        self._carry = b""             # last _WINDOW-1 stream bytes (window context)
        self._cands: list[int] = []   # absolute cut offsets (prefix lengths), ascending
        self._ci = 0                  # consumed prefix of _cands

    def _scan(self, block: bytes) -> None:
        """Append candidate cut offsets found in ``block`` (with window
        context carried across blocks so segmentation never shifts them)."""
        bits = self.params.avg_bits
        if self._ci > 1024:  # shed the consumed prefix on long streams
            del self._cands[: self._ci]
            self._ci = 0
        carry = self._carry
        buf = carry + block
        if len(block) >= 1024:
            idx = _candidates_numpy(buf, bits)
            # positions inside the carry were scanned by the previous call
            base = self._fed - len(carry)
            self._cands.extend(base + i + 1 for i in idx if i >= len(carry))
        else:
            h = 0
            for b in carry:  # rebuild window state, emit nothing
                h = ((h << 8) | b) & _M64
            idx = _candidates_python(block, bits, h)
            self._cands.extend(self._fed + i + 1 for i in idx)
        self._fed += len(block)
        self._carry = bytes(buf[-(_WINDOW - 1):])

    def _emit(self, final: bool = False) -> list[bytes]:
        p = self.params
        out: list[bytes] = []
        while True:
            start = self._emitted
            avail = len(self._pending)
            while self._ci < len(self._cands) and self._cands[self._ci] - start < p.min_size:
                self._ci += 1
            if self._ci == len(self._cands):  # keep the list bounded
                self._cands = []
                self._ci = 0
            cut = None
            if self._ci < len(self._cands) and self._cands[self._ci] - start <= p.max_size:
                cut = self._cands[self._ci]
            elif avail >= p.max_size:
                cut = start + p.max_size  # fixed-size fallback
            if cut is None or cut - start > avail:
                if final and avail:
                    out.append(bytes(self._pending))
                    self._pending.clear()
                    self._emitted = start + avail
                return out
            n = cut - start
            out.append(bytes(self._pending[:n]))
            del self._pending[:n]
            self._emitted = cut

    def feed(self, block: bytes) -> list[bytes]:
        if not isinstance(block, bytes):
            block = bytes(block)  # accept memoryview/bytearray blocks
        if not block:
            return []
        self._scan(block)
        self._pending.extend(block)
        return self._emit()

    def finish(self) -> list[bytes]:
        """Flush the tail chunk (if any). The cutter is exhausted after."""
        return self._emit(final=True)

