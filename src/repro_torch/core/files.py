"""Whole-file publication: write a temporary file, then rename it into place,
so a reader sees either no file or all of it, never a partial one.

Every operation goes through the repository's :class:`~.fsio.FS`, which
charges it on the simulated clock and checks the fault plan first. Temporary
files are named ``tmp-<pid>-<token>-<hex>`` (the reference's form):
``token`` is the writer's incarnation (the FS's, :mod:`.faults`), so that a
sweep can prove its owner dead. A writer whose incarnation a crash killed
writes, renames and unlinks nothing more (its FS's plan refuses every
operation): its tmp file stays behind, as a killed process's would, for
:func:`sweep_stale_tmps`.
"""
from __future__ import annotations

import os
import time
import uuid
from collections.abc import Iterable

from .faults import is_crash, owner_is_dead
from .fsio import FS


def tmp_name(directory: str, token: str | None = None) -> str:
    """A fresh temporary path in ``directory``, stamped with the writer's pid
    and incarnation token (``0`` for an unstamped writer)."""
    return os.path.join(directory, f"tmp-{os.getpid()}-{token or '0'}-{uuid.uuid4().hex[:12]}")


def write_atomic(fs: FS, path: str, blocks: bytes | Iterable[bytes], tmp_dir: str | None = None,
                 fsync: bool = False) -> int:
    """Write ``blocks`` (bytes, or an iterable of byte blocks) to ``path``
    through a temporary file in ``tmp_dir`` (default: ``path``'s directory,
    which must be on the same filesystem). Returns the bytes written."""
    if isinstance(blocks, (bytes, bytearray, memoryview)):
        blocks = (blocks,)
    tmp = tmp_name(tmp_dir or os.path.dirname(path), fs.token)
    try:
        n = fs.write_chunks(tmp, blocks, fsync=fsync)
        fs.rename(tmp, path)
    except BaseException as e:
        if is_crash(e):
            raise  # a dead process runs no cleanup: the tmp leaks
        fs.unlink(tmp)
        raise
    return n


# -- the crash sweep ----------------------------------------------------------


def tmp_owner(name: str) -> tuple[int | None, str | None]:
    """(pid, token) from a tmp name; (None, None) for a name without an
    owner stamp."""
    parts = name.split("-")
    if len(parts) >= 4 and parts[1].isdigit():
        return int(parts[1]), parts[2]
    return None, None


def stale_tmps(fs: FS, directory: str, max_age_s: float | None = 3600.0) -> list[str]:
    """The ``tmp-*`` files directly in ``directory`` whose writer is provably
    dead (dead pid, dead incarnation) or whose mtime is older than
    ``max_age_s``. With ``max_age_s=None`` ages do not count, but a name
    with no owner stamp, which cannot be proven live, does (the reference's
    forced sweep). The listing is charged; the mtime probes are not, as in
    the reference's annex sweep."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in fs.listdir(directory):
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


def sweep_stale_tmps(fs: FS, directory: str, max_age_s: float | None = 3600.0) -> int:
    """Unlink :func:`stale_tmps` of ``directory``; returns the count swept."""
    swept = 0
    for path in stale_tmps(fs, directory, max_age_s):
        try:
            fs.unlink(path)
            swept += 1
        except OSError:
            pass  # a racing sweeper got it first
    return swept
