"""Read side of pack files (port of the reading half of ``repro.core.packs``).

A pack is ``objects/pack/pack-<id>.pack``, the concatenated loose-file
bytes (zlib-compressed ``<kind> <len>\\0<payload>`` frames) of many objects,
with ``pack-<id>.idx``, ``{"version": 1, "objects": {oid: [offset,
length]}}``. A pack exists once its index does. The port reads packs that
the JAX package's ``ObjectStore.repack`` wrote; it writes none. Reads go
through the store's :class:`~.fsio.FS` and are charged as the reference's
are (a load: one ``isdir``, one ``listdir`` and one read per index; an
object: one ranged read).
"""
from __future__ import annotations

import bisect
import json
import os
import threading

from .fsio import FS

PACK_DIR = "pack"
INDEX_VERSION = 1


class PackError(IOError):
    pass


class PackManager:
    """In-memory index over every published pack under ``objects/pack/``,
    loaded on first use and reloaded when the directory changes."""

    def __init__(self, root: str, fs: FS):
        self.root = root  # .../objects/pack
        self.fs = fs
        self._lock = threading.Lock()
        self._loaded = False
        self._where: dict[str, tuple[str, int, int]] = {}  # oid -> (data path, offset, length)
        self._sorted_oids: list[str] | None = None
        self._mtime_at_load: float | None = None

    def _mtime(self) -> float | None:
        try:
            return os.path.getmtime(self.root)
        except OSError:
            return None

    def load(self, force: bool = False) -> None:
        """Scan the pack directory's indexes and replace the in-memory state."""
        with self._lock:
            if self._loaded and not force:
                return
            mtime = self._mtime()  # before the scan: a racing publish then rescans once
            where: dict[str, tuple[str, int, int]] = {}
            if self.fs.isdir(self.root):
                for name in self.fs.listdir(self.root):
                    if not name.endswith(".idx"):
                        continue
                    pack_id = name[len("pack-"):-len(".idx")]
                    index = json.loads(self.fs.read_bytes(os.path.join(self.root, name)))
                    if index.get("version") != INDEX_VERSION:
                        raise PackError(f"unsupported pack index version in pack-{pack_id}")
                    data = os.path.join(self.root, f"pack-{pack_id}.pack")
                    for oid, (off, length) in index["objects"].items():
                        where[oid] = (data, off, length)
            self._where, self._sorted_oids = where, None
            self._mtime_at_load, self._loaded = mtime, True

    def maybe_reload(self) -> bool:
        """Rescan only if the pack directory changed since the last load (one
        charged stat)."""
        try:
            current = self.fs.stat_mtime(self.root)
        except OSError:
            return False
        if current == self._mtime_at_load:
            return False
        self.load(force=True)
        return True

    def has(self, oid: str) -> bool:
        self.load()
        with self._lock:
            return oid in self._where

    def read(self, oid: str) -> bytes:
        """The packed object's compressed frame (the loose file's bytes)."""
        self.load()
        with self._lock:
            loc = self._where.get(oid)
        if loc is None:
            raise KeyError(f"object {oid} is not packed")
        path, off, length = loc
        return self.fs.read_range(path, off, length)

    def oids_with_prefix(self, prefix: str) -> list[str]:
        self.load()
        with self._lock:
            if self._sorted_oids is None:
                self._sorted_oids = sorted(self._where)
            oids = self._sorted_oids
        out = []
        for i in range(bisect.bisect_left(oids, prefix), len(oids)):
            if not oids[i].startswith(prefix):
                break
            out.append(oids[i])
        return out
