"""Cross-process advisory locks (port of ``repro.core.recovery``'s
``LockHeld`` and ``FileLock``).

A lock is a file under ``.repro/locks/`` created with O_CREAT|O_EXCL and
stamped with its owner, ``{"pid", "token", "host", "heartbeat"}``, the
reference's payload (``token`` is the owner's incarnation, :mod:`.faults`).
A lock whose owner is provably dead (dead pid, or a dead incarnation of
this process), whose payload does not parse (torn by a crash), or whose
heartbeat is older than ``ttl_s`` (the cross-host fallback) is stale and
is broken on acquire, so a crashed holder cannot wedge the repository.
Every operation goes through an :class:`~.fsio.FS` (the repository's, for
its locks), charged as the reference's are.
Across processes either package's holder excludes the other's. Inside one
process it does not: each package keeps its own set of live incarnations
(:func:`~.faults.owner_is_dead`), so each takes the other's lock there for
a dead one and breaks it. A holder whose incarnation a crash killed
releases nothing (its FS's plan refuses every operation): its lock stays
for ``recover`` or the next acquire to break.
"""
from __future__ import annotations

import json
import os
import socket
import time

from .faults import CrashInjected, owner_is_dead
from .fsio import FS

LOCKS_DIR = "locks"


class LockHeld(RuntimeError):
    """The lock is held by a live owner and the wait budget ran out."""


class FileLock:
    """An exclusive file stamped with its owner; complements the in-process
    ``Repository.ref_lock``, which threads take first, so this file only
    arbitrates across processes and across crash boundaries."""

    _GONE = object()  # sentinel: the lock file vanished between probe and read

    def __init__(self, path: str, ttl_s: float | None = 600.0, token: str | None = None, fs: FS | None = None):
        self.path = path
        self.ttl_s = ttl_s
        # the repository's FS stamps its own incarnation; a bare lock (no FS
        # given) is stamped with ``token``, or with none
        self.fs = fs if fs is not None else FS()
        self.token = fs.token if fs is not None and token is None else token
        self._held = False

    def _payload(self) -> bytes:
        return json.dumps({
            "pid": os.getpid(),
            "token": self.token,
            "host": socket.gethostname(),
            "heartbeat": time.time(),
        }).encode()

    def read_info(self):
        try:
            data = self.fs.read_bytes(self.path)
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
        if owner_is_dead(info.get("pid"), info.get("token")):
            return True
        hb = info.get("heartbeat")
        if self.ttl_s is not None and isinstance(hb, (int, float)):
            return (time.time() - hb) > self.ttl_s
        return False

    def break_lock(self) -> None:
        self.fs.unlink(self.path)

    def break_if_stale(self) -> bool:
        """Break the lock iff its owner is provably dead or its heartbeat is
        older than ``ttl_s`` (the recovery sweep's test); True if broken."""
        info = self.read_info()
        if info is self._GONE or not self.is_stale(info):
            return False
        self.break_lock()
        return True

    def beat(self) -> None:
        """Refresh a held lock's heartbeat (a long holder's proof of life
        across hosts), published through a tmp and a rename."""
        if self._held:
            self.fs.write_atomic(self.path, self._payload(), fsync=False)

    def acquire(self, wait_s: float = 30.0, poll_s: float = 0.02) -> "FileLock":
        deadline = time.monotonic() + wait_s
        while True:
            try:
                self.fs.create_exclusive(self.path, self._payload())
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
        """Unlink the lock; a holder whose incarnation is dead raises
        :class:`~.faults.CrashInjected` and leaves it, as a dead process
        would."""
        if self._held:
            self._held = False
            try:
                self.break_lock()
            except CrashInjected:
                raise
            except Exception:
                # the charged unlink failed while an error unwinds: unlink
                # uncharged rather than mask that error or leave a live
                # lock that wedges the next holder until its ttl
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and issubclass(exc_type, CrashInjected):
            return  # killed: the lock stays held
        self.release()
