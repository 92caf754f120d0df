"""Whole-file publication: write a temporary file, then rename it into place,
so a reader sees either no file or all of it, never a partial one.

Temporary files are named ``tmp-<pid>-<token>-<hex>`` (the reference's
form): ``token`` is the writer's incarnation (:mod:`.faults`), so that a
sweep can prove its owner dead. A writer whose incarnation a crash killed
writes, renames and unlinks nothing more: its tmp file stays behind, as a
killed process's would, for :func:`sweep_stale_tmps`.
"""
from __future__ import annotations

import os
import time
import uuid
from collections.abc import Iterable, Iterator

from .faults import ensure_live, is_crash, owner_is_dead


def tmp_name(directory: str, token: str | None = None) -> str:
    """A fresh temporary path in ``directory``, stamped with the writer's pid
    and incarnation token (``0`` for an unstamped writer)."""
    return os.path.join(directory, f"tmp-{os.getpid()}-{token or '0'}-{uuid.uuid4().hex[:12]}")


def write_atomic(path: str, blocks: bytes | Iterable[bytes], tmp_dir: str | None = None,
                 token: str | None = None, fsync: bool = False) -> int:
    """Write ``blocks`` (bytes, or an iterable of byte blocks) to ``path``
    through a temporary file in ``tmp_dir`` (default: ``path``'s directory,
    which must be on the same filesystem). Returns the bytes written."""
    if isinstance(blocks, (bytes, bytearray, memoryview)):
        blocks = (blocks,)
    ensure_live(token)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp_dir = tmp_dir or os.path.dirname(path)
    os.makedirs(tmp_dir, exist_ok=True)
    tmp = tmp_name(tmp_dir, token)
    try:
        n = 0
        with open(tmp, "wb") as f:
            for b in blocks:
                f.write(b)
                n += len(b)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        ensure_live(token)
        os.replace(tmp, path)
    except BaseException as e:
        if is_crash(e):
            raise  # a dead process runs no cleanup: the tmp leaks
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return n


def append_text(path: str, text: str, token: str | None = None) -> None:
    """Append ``text`` to ``path`` (one write)."""
    ensure_live(token)
    with open(path, "a") as f:
        f.write(text)


def unlink(path: str, token: str | None = None) -> None:
    """Remove ``path`` if it exists."""
    ensure_live(token)
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def file_blocks(path: str, block: int = 1 << 20) -> Iterator[bytes]:
    """A file's bytes in blocks of ``block``, streamed."""
    with open(path, "rb") as f:
        while data := f.read(block):
            yield data


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- the crash sweep ----------------------------------------------------------


def tmp_owner(name: str) -> tuple[int | None, str | None]:
    """(pid, token) from a tmp name; (None, None) for a name without an
    owner stamp."""
    parts = name.split("-")
    if len(parts) >= 4 and parts[1].isdigit():
        return int(parts[1]), parts[2]
    return None, None


def stale_tmps(directory: str, max_age_s: float | None = 3600.0) -> list[str]:
    """The ``tmp-*`` files directly in ``directory`` whose writer is provably
    dead (dead pid, dead incarnation) or whose mtime is older than
    ``max_age_s``. With ``max_age_s=None`` ages do not count, but a name
    with no owner stamp, which cannot be proven live, does (the reference's
    forced sweep)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if not name.startswith("tmp-"):
            continue
        path = os.path.join(directory, name)
        pid, token = tmp_owner(name)
        stale = pid is not None and owner_is_dead(pid, token)
        if not stale and max_age_s is not None:
            try:
                stale = (time.time() - os.stat(path).st_mtime) > max_age_s
            except OSError:
                continue  # swept by a racing sweeper
        if not stale and max_age_s is None and pid is None:
            stale = True
        if stale:
            out.append(path)
    return out


def sweep_stale_tmps(directory: str, max_age_s: float | None = 3600.0, token: str | None = None) -> int:
    """Unlink :func:`stale_tmps` of ``directory``; returns the count swept."""
    ensure_live(token)
    swept = 0
    for path in stale_tmps(directory, max_age_s):
        try:
            os.unlink(path)
            swept += 1
        except OSError:
            pass  # a racing sweeper got it first
    return swept
