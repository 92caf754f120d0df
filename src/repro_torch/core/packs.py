"""Pack files: many immutable objects in one file, so the loose shards stay
small (port of ``repro.core.packs``, DESIGN.md §8).

On a parallel filesystem every metadata operation pays ``dir_degrade *
(entries - degrade_threshold)`` against the directory it touches (:mod:`.fsio`),
and loose objects pile up one file each in the 256 ``objects/<2-hex>/``
shards. ``ObjectStore.repack`` moves them into a pack and empties the
shards, so new writes go back to the base cost however many objects the
repository has ever stored.

Format, byte for byte the reference's:

``objects/pack/pack-<id>.pack``  the objects' loose-file bytes (zlib-compressed
                                 ``<kind> <len>\\0<payload>`` frames), concatenated;
``objects/pack/pack-<id>.idx``   ``{"objects": {oid: [offset, length]}, "version": 1}``
                                 (sorted keys).

``<id>`` is the first 16 hex digits of the sha256 of the pack data, so packing
the same objects in the same order gives the same pack in both packages.

A pack exists once its index does. :meth:`PackManager.add_pack` streams the
data to ``incoming-<pid>-<hex>.tmp``, renames it to ``pack-<id>.pack``
(crash point ``repack:data-renamed``), then publishes the index through a
``.tmp`` and a rename; the caller unlinks the loose copies only after that.
A crash therefore leaves either an unindexed data file or tmp (garbage for
:meth:`PackManager.sweep_garbage` once a day old) with every object still
loose, or an index with loose duplicates (dead weight for the next repack),
never a missing object.

The manager is bound to its store's :class:`~.fsio.FS` when it is made (the
reference's takes the FS per call); every probe and read is charged through
it as the reference's are: a load is one ``isdir``, one ``listdir`` and one
read per index, an object one ranged read, and lookups after a load are
in-memory.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
import uuid

from .faults import is_crash
from .fsio import FS

PACK_DIR = "pack"
INDEX_VERSION = 1
GARBAGE_MIN_AGE_S = 86400.0  # a younger unindexed file may be a live repack's


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
        # every registered pack, also one whose oids a newer pack all serves
        # (a crash mid-consolidation): consolidation must still fold its files
        self._pack_ids: set[str] = set()
        self._sorted_oids: list[str] | None = None
        self._mtime_at_load: float | None = None

    def _data_path(self, pack_id: str) -> str:
        return os.path.join(self.root, f"pack-{pack_id}.pack")

    def _index_path(self, pack_id: str) -> str:
        return os.path.join(self.root, f"pack-{pack_id}.idx")

    def _mtime(self) -> float | None:
        try:
            return os.path.getmtime(self.root)
        except OSError:
            return None

    # -- loading -------------------------------------------------------------
    def load(self, force: bool = False) -> None:
        """Scan the pack directory's indexes and replace the in-memory state
        (a reload also forgets packs another process folded away)."""
        with self._lock:
            if self._loaded and not force:
                return
            mtime = self._mtime()  # before the scan: a racing publish then rescans once
            where: dict[str, tuple[str, int, int]] = {}
            ids: set[str] = set()
            if self.fs.isdir(self.root):
                for name in self.fs.listdir(self.root):
                    if not name.endswith(".idx"):
                        continue
                    pack_id = name[len("pack-"):-len(".idx")]
                    index = json.loads(self.fs.read_bytes(os.path.join(self.root, name)))
                    if index.get("version") != INDEX_VERSION:
                        raise PackError(f"unsupported pack index version in pack-{pack_id}")
                    ids.add(pack_id)
                    data = self._data_path(pack_id)
                    for oid, (off, length) in index["objects"].items():
                        where[oid] = (data, off, length)
            self._where, self._pack_ids, self._sorted_oids = where, ids, None
            self._mtime_at_load, self._loaded = mtime, True

    def maybe_reload(self) -> bool:
        """Rescan only if the pack directory changed since the last load (one
        charged stat); True if it rescanned."""
        try:
            current = self.fs.stat_mtime(self.root)
        except OSError:
            return False
        if current == self._mtime_at_load:
            return False
        self.load(force=True)
        return True

    def _register(self, pack_id: str, index: dict[str, list[int]]) -> None:
        """Serve ``index``'s oids from the new pack. The load stamp is left
        alone: our own publish moved the directory's mtime too, and a
        restamp would hide a foreign pack published since the last load."""
        data = self._data_path(pack_id)
        with self._lock:
            self._pack_ids.add(pack_id)
            for oid, (off, length) in index.items():
                self._where[oid] = (data, off, length)
            self._sorted_oids = None

    # -- queries -------------------------------------------------------------
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

    def n_packed(self) -> int:
        self.load()
        with self._lock:
            return len(self._where)

    def pack_ids(self) -> list[str]:
        self.load()
        with self._lock:
            return sorted(self._pack_ids)

    def pack_data_size(self, pack_id: str) -> int:
        return self.fs.stat_size(self._data_path(pack_id))

    def read_pack_objects(self, pack_id: str):
        """Yield ``(oid, frame)`` for every object ``pack_id`` serves: one
        whole-file read, sliced lazily."""
        self.load()
        data_path = self._data_path(pack_id)
        with self._lock:
            spans = [(oid, off, length) for oid, (path, off, length) in self._where.items() if path == data_path]
        if not spans:
            return
        data = self.fs.read_bytes(data_path)
        for oid, off, length in spans:
            yield oid, data[off:off + length]

    # -- maintenance -----------------------------------------------------------
    def sweep_garbage(self) -> int:
        """Unlink the leftovers of crashed repacks: ``*.tmp`` files and data
        files without an index, once their mtime is a day old (a younger one
        may be a live repack's, between its data rename and its index
        publish). Returns the count removed."""
        if not self.fs.isdir(self.root):
            return 0
        names = self.fs.listdir(self.root)
        indexed = {n[len("pack-"):-len(".idx")] for n in names if n.endswith(".idx")}
        swept = 0
        for n in names:
            orphan_data = n.endswith(".pack") and n[len("pack-"):-len(".pack")] not in indexed
            if not (n.endswith(".tmp") or orphan_data):
                continue
            path = os.path.join(self.root, n)
            try:
                if time.time() - self.fs.stat_mtime(path) < GARBAGE_MIN_AGE_S:
                    continue
            except OSError:
                continue  # gone already: its owner finished or cleaned up
            self.fs.unlink(path)
            swept += 1
        return swept

    def drop_pack_files(self, pack_id: str) -> None:
        """Unlink a folded pack, whose oids a newer pack already serves:
        index first, then data, so a crash between leaves garbage, never an
        index over missing data."""
        self.fs.unlink(self._index_path(pack_id))
        self.fs.unlink(self._data_path(pack_id))
        with self._lock:
            self._pack_ids.discard(pack_id)

    def add_pack(self, objects) -> str | None:
        """Write and publish one pack of ``objects``, an iterable of ``(oid,
        compressed frame)`` consumed lazily (one frame in memory at a time).
        Returns the pack id, or None if there was nothing to pack. The caller
        unlinks loose copies only after this returns."""
        self.load()
        index: dict[str, list[int]] = {}
        digest = hashlib.sha256()
        offset = 0

        def stream():
            nonlocal offset
            for oid, frame in objects:
                index[oid] = [offset, len(frame)]
                offset += len(frame)
                digest.update(frame)
                yield frame

        # the id is known only once the data is hashed: stream to a unique tmp
        tmp_data = os.path.join(self.root, f"incoming-{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
        try:
            self.fs.write_chunks(tmp_data, stream())
        except BaseException as e:
            if is_crash(e):
                raise  # a dead process cleans up nothing: sweep_garbage's job
            self.fs.unlink(tmp_data)
            raise
        if not index:
            self.fs.unlink(tmp_data)
            return None
        pack_id = digest.hexdigest()[:16]
        self.fs.rename(tmp_data, self._data_path(pack_id))
        self.fs.crash_point("repack:data-renamed")  # data in place, no index yet
        tmp = self._index_path(pack_id) + ".tmp"
        self.fs.write_bytes(tmp, json.dumps({"version": INDEX_VERSION, "objects": index}, sort_keys=True).encode())
        self.fs.rename(tmp, self._index_path(pack_id))
        self._register(pack_id, index)
        return pack_id
