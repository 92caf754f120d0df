"""Cross-process advisory locks (port of ``repro.core.recovery``'s
``LockHeld`` and ``FileLock``; the intent journals, ``recover`` and
``verify`` are not ported, ROADMAP.md §A item 2).

A lock is a file under ``.repro/locks/`` created with O_CREAT|O_EXCL and
stamped with its owner, ``{"pid", "token", "host", "heartbeat"}``, the
reference's payload (``token`` is the reference's simulated-crash
incarnation; the port has none and writes null). A lock whose owner pid is
dead, whose payload does not parse (torn by a crash), or whose heartbeat is
older than ``ttl_s`` is stale and is broken on acquire, so a crashed holder
cannot wedge the repository. Either package's holder excludes the other's.
"""
from __future__ import annotations

import json
import os
import socket
import time

LOCKS_DIR = "locks"


class LockHeld(RuntimeError):
    """The lock is held by a live owner and the wait budget ran out."""


def _pid_alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except (OverflowError, ValueError, TypeError):
        return False
    return True


class FileLock:
    """An exclusive file stamped with its owner; complements the in-process
    ``Repository.ref_lock``, which threads take first, so this file only
    arbitrates across processes."""

    _GONE = object()  # sentinel: the lock file vanished between probe and read

    def __init__(self, path: str, ttl_s: float | None = 600.0):
        self.path = path
        self.ttl_s = ttl_s
        self._held = False

    def _payload(self) -> bytes:
        return json.dumps({
            "pid": os.getpid(),
            "token": None,
            "host": socket.gethostname(),
            "heartbeat": time.time(),
        }).encode()

    def read_info(self):
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return self._GONE
        try:
            info = json.loads(data)
            return info if isinstance(info, dict) else None
        except (ValueError, UnicodeDecodeError):
            return None  # torn payload -> crashed writer -> stale

    def is_stale(self, info) -> bool:
        if info is self._GONE:
            return False
        if info is None:
            return True
        pid = info.get("pid")
        if pid is not None and not _pid_alive(pid):
            return True
        hb = info.get("heartbeat")
        if self.ttl_s is not None and isinstance(hb, (int, float)):
            return (time.time() - hb) > self.ttl_s
        return False

    def break_lock(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def _create(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        try:
            os.write(fd, self._payload())
            os.fsync(fd)
        finally:
            os.close(fd)

    def acquire(self, wait_s: float = 30.0, poll_s: float = 0.02) -> "FileLock":
        deadline = time.monotonic() + wait_s
        while True:
            try:
                self._create()
                self._held = True
                return self
            except FileExistsError:
                info = self.read_info()
                if info is self._GONE:
                    continue  # released between probe and read: retry now
                if self.is_stale(info):
                    self.break_lock()
                    continue
                if time.monotonic() >= deadline:
                    raise LockHeld(f"{self.path} held by pid {info.get('pid')} on {info.get('host')}") from None
                time.sleep(poll_s)

    def release(self) -> None:
        if self._held:
            self._held = False
            self.break_lock()

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
