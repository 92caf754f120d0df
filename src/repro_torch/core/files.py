"""Whole-file publication: write a temporary file, then rename it into place,
so a reader sees either no file or all of it, never a partial one."""
from __future__ import annotations

import os
import uuid
from collections.abc import Iterable, Iterator


def tmp_name(directory: str) -> str:
    """A fresh temporary path in ``directory``, stamped with the writer's pid
    (the reference's ``tmp-<pid>-<token>-<hex>`` form, token 0)."""
    return os.path.join(directory, f"tmp-{os.getpid()}-0-{uuid.uuid4().hex[:12]}")


def write_atomic(path: str, blocks: bytes | Iterable[bytes], tmp_dir: str | None = None) -> int:
    """Write ``blocks`` (bytes, or an iterable of byte blocks) to ``path``
    through a temporary file in ``tmp_dir`` (default: ``path``'s directory,
    which must be on the same filesystem). Returns the bytes written."""
    if isinstance(blocks, (bytes, bytearray, memoryview)):
        blocks = (blocks,)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp_dir = tmp_dir or os.path.dirname(path)
    os.makedirs(tmp_dir, exist_ok=True)
    tmp = tmp_name(tmp_dir)
    try:
        n = 0
        with open(tmp, "wb") as f:
            for b in blocks:
                f.write(b)
                n += len(b)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return n


def file_blocks(path: str, block: int = 1 << 20) -> Iterator[bytes]:
    """A file's bytes in blocks of ``block``, streamed."""
    with open(path, "rb") as f:
        while data := f.read(block):
            yield data


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
