"""Content hashing and annex keys (port of ``repro.core.hashing``).

A whole object's key is ``SHA256-s<size>--<hex>``; a chunk of the chunk
tier has ``SHA256C-s<size>--<hex>``. The key alone verifies the content.
"""
from __future__ import annotations

import hashlib
import re

_ANY_KEY_RE = re.compile(r"^SHA256C?-s(?P<size>\d+)--(?P<hex>[0-9a-f]{64})$")


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def make_annex_key(hx: str, size: int) -> str:
    return f"SHA256-s{size}--{hx}"


def annex_key_for_bytes(data: bytes) -> str:
    return make_annex_key(sha256_bytes(data), len(data))


def chunk_key_for_bytes(data: bytes) -> str:
    return f"SHA256C-s{len(data)}--{sha256_bytes(data)}"


def is_chunk_key(key: str) -> bool:
    return key.startswith("SHA256C-")


def parse_annex_key(key: str) -> tuple[int, str]:
    """(size, hex) of a whole-object or chunk key; ValueError otherwise."""
    m = _ANY_KEY_RE.match(key)
    if not m:
        raise ValueError(f"not a valid annex key: {key!r}")
    return int(m.group("size")), m.group("hex")


def verify_annex_key(key: str, data: bytes) -> bool:
    size, hx = parse_annex_key(key)
    return size == len(data) and sha256_bytes(data) == hx
