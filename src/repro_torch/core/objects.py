"""Content-addressed object store: blobs, trees, commits (port of
``repro.core.objects``).

An object is ``<kind> <len>\\0<payload>``, named by the SHA-256 of that
frame and stored zlib-compressed (level 1) under ``objects/<2-hex>/<62-hex>``.
Trees and commits are canonical JSON (sorted keys, no whitespace).

Tree entries: ``{"t": "blob", "oid": ...}``, ``{"t": "tree", "oid": ...}``,
``{"t": "annex", "key": ..., ["chunked": true]}``. Commits: ``{"tree",
"parents", "author", "timestamp", "message", ["spec"]}``.

Writes land loose, published through a tmp and a rename (two metadata
operations more than the reference's direct write, which a crash can tear);
reads ask the pack index first, then the loose file, and a read that loses
a race with another process's repack reloads the index and tries both
again. Every operation goes through the repository's :class:`~.fsio.FS`.

Packs (DESIGN.md §8, :mod:`.packs`): ``repack`` moves every loose object
into one pack, publishes it, and only then unlinks the loose files, so a
crash leaves duplicates, never a missing object; it folds the smaller half
of the packs into the new one once there are ``max_packs``. One repack runs
at a time: a thread lock, and across processes (and crashes) the
:class:`~.locks.FileLock` ``.repro/locks/repack.lock``, which a killed
repack leaves for ``recover()`` or the next acquire to break.
``put_commits_packed`` writes a batch of commits as one pack (the memoized
publication of §11).

Caching (DESIGN.md §4), as the reference's: objects are immutable, so a
*known-oid set* answers ``put``/``has`` of an oid written or seen before
without an ``exists`` probe, and LRU caches of tree and commit payloads
(parsed afresh per hit, so callers may mutate what they get) and of blob
bytes spare repeated reads.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from collections import OrderedDict

from .files import write_atomic
from .fsio import FS
from .hashing import sha256_bytes
from .locks import LOCKS_DIR, FileLock
from .packs import PACK_DIR, PackManager

KINDS = ("blob", "tree", "commit")

DEFAULT_TREE_CACHE = 8192
DEFAULT_COMMIT_CACHE = 8192
DEFAULT_BLOB_CACHE_BYTES = 32 << 20  # bound by payload bytes, not entry count
KNOWN_OID_CAP = 1 << 20  # bound the probe-skip set of a long-lived process


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _frame(kind: str, payload: bytes) -> bytes:
    if kind not in KINDS:
        raise ValueError(f"unknown object kind {kind!r}")
    return kind.encode() + b" " + str(len(payload)).encode() + b"\0" + payload


class ObjectStore:
    def __init__(self, root: str, fs: FS):
        self.root = root  # .../objects
        self.fs = fs
        self.packs = PackManager(os.path.join(root, PACK_DIR), fs)
        self._lock = threading.Lock()
        self._repack_lock = threading.Lock()  # one repack at a time in this process
        self._repack_lock_path = os.path.join(os.path.dirname(root), LOCKS_DIR, "repack.lock")
        self._known: set[str] = set()
        # oid -> canonical payload; parsed per hit, so no dict is shared
        self._tree_cache: OrderedDict[str, bytes] = OrderedDict()
        self._commit_cache: OrderedDict[str, bytes] = OrderedDict()
        # oid -> blob payload; bytes are immutable, so hits are shared
        self._blob_cache: OrderedDict[str, bytes] = OrderedDict()
        self._blob_cache_used = 0

    def _path(self, oid: str) -> str:
        return os.path.join(self.root, oid[:2], oid[2:])

    # -- caches ------------------------------------------------------------
    def _is_known(self, oid: str) -> bool:
        with self._lock:
            return oid in self._known

    def _mark_known(self, oid: str) -> None:
        with self._lock:
            if len(self._known) >= KNOWN_OID_CAP:
                self._known.clear()  # the set only skips probes: reset, never wrong
            self._known.add(oid)

    def _cache_get(self, cache: OrderedDict, oid: str) -> bytes | None:
        with self._lock:
            payload = cache.get(oid)
            if payload is not None:
                cache.move_to_end(oid)
            return payload

    def _cache_put(self, cache: OrderedDict, oid: str, payload: bytes, size: int) -> None:
        with self._lock:
            cache[oid] = payload
            cache.move_to_end(oid)
            while len(cache) > size:
                cache.popitem(last=False)

    def _blob_cache_put(self, oid: str, data: bytes) -> None:
        with self._lock:
            if len(data) > DEFAULT_BLOB_CACHE_BYTES:
                return
            old = self._blob_cache.pop(oid, None)
            if old is not None:
                self._blob_cache_used -= len(old)
            self._blob_cache[oid] = data
            self._blob_cache_used += len(data)
            while self._blob_cache_used > DEFAULT_BLOB_CACHE_BYTES:
                _, evicted = self._blob_cache.popitem(last=False)
                self._blob_cache_used -= len(evicted)

    # -- core --------------------------------------------------------------
    @staticmethod
    def oid_for(kind: str, payload: bytes) -> str:
        """The oid ``put(kind, payload)`` would assign, without writing."""
        return sha256_bytes(_frame(kind, payload))

    def put(self, kind: str, payload: bytes) -> str:
        framed = _frame(kind, payload)
        oid = sha256_bytes(framed)
        if self._is_known(oid):
            return oid
        if not self.packs.has(oid):
            path = self._path(oid)
            if not self.fs.exists(path):
                # the temporary file lies outside the 2-hex shards, so a shard
                # listing (prefix search, the reference's repack) never sees it
                write_atomic(self.fs, path, zlib.compress(framed, 1), tmp_dir=self.root)
        self._mark_known(oid)
        return oid

    def has(self, oid: str) -> bool:
        if self._is_known(oid):
            return True
        if self.packs.has(oid) or self.fs.exists(self._path(oid)):
            self._mark_known(oid)
            return True
        return False

    def _read_compressed(self, oid: str) -> bytes:
        """The compressed frame from a pack or the loose file; on a miss the
        pack index is reloaded once (another process may have repacked)."""
        try:
            if self.packs.has(oid):
                return self.packs.read(oid)
            return self.fs.read_bytes(self._path(oid))
        except FileNotFoundError:
            self.packs.load(force=True)
            if self.packs.has(oid):
                return self.packs.read(oid)
            try:
                return self.fs.read_bytes(self._path(oid))
            except FileNotFoundError:
                raise FileNotFoundError(f"object {oid} is neither loose nor packed") from None

    def get(self, oid: str) -> tuple[str, bytes]:
        framed = zlib.decompress(self._read_compressed(oid))
        header, _, payload = framed.partition(b"\0")
        kind, _, length = header.decode().partition(" ")
        if int(length) != len(payload) or sha256_bytes(framed) != oid:
            raise IOError(f"corrupt object {oid}")
        self._mark_known(oid)
        return kind, payload

    def _get_kind(self, oid: str, want: str) -> bytes:
        kind, payload = self.get(oid)
        if kind != want:
            raise TypeError(f"{oid} is a {kind}, not a {want}")
        return payload

    def find_prefix(self, prefix: str) -> list[str]:
        """Every stored oid starting with ``prefix`` (at least 2 hex digits),
        packed and loose."""
        if len(prefix) < 2:
            raise ValueError(f"oid prefix too short: {prefix!r}")
        matches = self._find_prefix_once(prefix)
        if not matches and self.packs.maybe_reload():
            matches = self._find_prefix_once(prefix)
        return matches

    def _find_prefix_once(self, prefix: str) -> list[str]:
        matches = set(self.packs.oids_with_prefix(prefix))
        shard = os.path.join(self.root, prefix[:2])
        if self.fs.isdir(shard):
            matches.update(prefix[:2] + f for f in self.fs.listdir(shard) if (prefix[:2] + f).startswith(prefix))
        return sorted(matches)

    # -- typed helpers -------------------------------------------------------
    def put_blob(self, data: bytes) -> str:
        oid = self.put("blob", data)
        self._blob_cache_put(oid, data)
        return oid

    def put_tree(self, entries: dict) -> str:
        payload = canonical_json(entries)
        oid = self.put("tree", payload)
        self._cache_put(self._tree_cache, oid, payload, DEFAULT_TREE_CACHE)
        return oid

    def put_commit(self, commit: dict) -> str:
        payload = canonical_json(commit)
        oid = self.put("commit", payload)
        self._cache_put(self._commit_cache, oid, payload, DEFAULT_COMMIT_CACHE)
        return oid

    def put_commits_packed(self, commits: list[dict]) -> list[str]:
        """Write a batch of commits as ONE pack instead of N loose files (the
        memoized publication of §11): one data write and one index publish
        whatever N, and no loose-shard pressure. Commits already stored are
        skipped; the presence check is uncharged (the known-oid set and the
        pack index only): fresh commits are timestamp-unique, so a loose
        probe would be a metadata operation that always misses. Returns the
        oids in input order."""
        oids: list[str] = []
        frames: list[tuple[str, bytes]] = []
        seen: set[str] = set()
        for commit in commits:
            framed = _frame("commit", canonical_json(commit))
            oid = sha256_bytes(framed)
            oids.append(oid)
            if oid in seen:
                continue
            seen.add(oid)
            if not self._is_known(oid) and not self.packs.has(oid):
                frames.append((oid, zlib.compress(framed, 1)))
        if frames:
            self.packs.add_pack(iter(frames))
            for oid, _ in frames:
                self._mark_known(oid)
        return oids

    def get_blob(self, oid: str) -> bytes:
        with self._lock:
            cached = self._blob_cache.get(oid)
            if cached is not None:
                self._blob_cache.move_to_end(oid)
                return cached
        payload = self._get_kind(oid, "blob")
        self._blob_cache_put(oid, payload)
        return payload

    def get_tree(self, oid: str) -> dict:
        payload = self._cache_get(self._tree_cache, oid)
        if payload is None:
            payload = self._get_kind(oid, "tree")
            self._cache_put(self._tree_cache, oid, payload, DEFAULT_TREE_CACHE)
        return json.loads(payload)

    def get_commit(self, oid: str) -> dict:
        payload = self._cache_get(self._commit_cache, oid)
        if payload is None:
            payload = self._get_kind(oid, "commit")
            self._cache_put(self._commit_cache, oid, payload, DEFAULT_COMMIT_CACHE)
        return json.loads(payload)

    # -- compaction (DESIGN.md §8) -------------------------------------------
    def _shard_dirs(self) -> list[str]:
        """All 256 shard paths, also those that exist only as modelled entry
        counts (a seeded footprint)."""
        return [os.path.join(self.root, f"{i:02x}") for i in range(256)]

    def loose_pressure(self) -> int:
        """The largest modelled entry count of the 256 loose shards (free
        bookkeeping reads): what the auto-repack threshold is held against."""
        return max(self.fs.dir_entry_count(d) for d in self._shard_dirs())

    def repack(self, delete_loose: bool = True, max_packs: int | None = 48) -> dict:
        """Move every loose object into one new pack, publish it, then unlink
        the loose files and charge the unlinks of any seeded phantom entries
        (:meth:`~.fsio.FS.purge_phantom_entries`). Once
        there are ``max_packs`` packs, the smaller half (or more, as the
        bound needs) is folded into the new one and their files removed
        after it is live, so the pack directory stays near ``2 * max_packs``
        entries (``None``: never fold). Crash points ``repack:planned``,
        ``repack:pack-published`` and, after the first unlink,
        ``repack:mid-unlink``. ``delete_loose=False`` stops once the pack is
        published (a crash's state there: every object twice). Returns the
        stats."""
        with self._repack_lock, FileLock(self._repack_lock_path, fs=self.fs):
            return self._repack_locked(delete_loose, max_packs)

    def _repack_locked(self, delete_loose: bool, max_packs: int | None) -> dict:
        fs, packs = self.fs, self.packs
        swept = packs.sweep_garbage()  # crash leftovers count against the pack dir's bound
        to_pack: list[tuple[str, str]] = []  # (oid, loose path) not packed yet
        loose_paths: list[str] = []
        real_shards = set(fs.listdir(self.root)) if os.path.isdir(self.root) else set()
        for shard in self._shard_dirs():
            name = os.path.basename(shard)
            if name not in real_shards:
                continue
            for f in fs.listdir(shard):
                path = os.path.join(shard, f)
                if not packs.has(name + f):  # else a duplicate a crashed repack left
                    to_pack.append((name + f, path))
                loose_paths.append(path)
        consolidated: list[str] = []
        if max_packs is not None:
            ids = packs.pack_ids()
            if len(ids) >= max_packs:
                # fold the smaller half (or what the bound needs): big old
                # packs are not copied again on every fold
                n_fold = max(len(ids) + 1 - max_packs, (len(ids) + 1) // 2)

                def size_of(pid: str) -> int:
                    try:
                        return packs.pack_data_size(pid)
                    except OSError:
                        return 0  # another process dropped it: fold the ghost away
                consolidated = sorted(ids, key=size_of)[:n_fold]

        def frames():  # one loose file or one old pack in memory at a time
            for oid, path in to_pack:
                yield oid, fs.read_bytes(path)
            for pid in consolidated:
                yield from packs.read_pack_objects(pid)

        fs.crash_point("repack:planned")
        pack_id = packs.add_pack(frames()) if to_pack or consolidated else None
        # the pack is live: losing the loose and folded copies loses nothing now
        fs.crash_point("repack:pack-published")
        unlinked = phantoms = 0
        if delete_loose:
            for path in loose_paths:
                fs.unlink(path)
                unlinked += 1
                if unlinked == 1:
                    fs.crash_point("repack:mid-unlink")
            for shard in self._shard_dirs():
                phantoms += fs.purge_phantom_entries(shard)
            for pid in consolidated:
                if pid != pack_id:  # the same content packed again in place
                    packs.drop_pack_files(pid)
        return {
            "pack_id": pack_id,
            "objects_packed": len(to_pack),
            "packs_consolidated": len(consolidated),
            "garbage_swept": swept,
            "loose_unlinked": unlinked,
            "phantom_entries_purged": phantoms,
            "packed_total": packs.n_packed(),
        }
