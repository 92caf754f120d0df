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
reads ask the pack index first, then the loose file. Every operation goes
through the repository's :class:`~.fsio.FS`.

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
