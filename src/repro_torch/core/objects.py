"""Content-addressed object store: blobs, trees, commits (port of
``repro.core.objects``).

An object is ``<kind> <len>\\0<payload>``, named by the SHA-256 of that
frame and stored zlib-compressed (level 1) under ``objects/<2-hex>/<62-hex>``.
Trees and commits are canonical JSON (sorted keys, no whitespace).

Tree entries: ``{"t": "blob", "oid": ...}``, ``{"t": "tree", "oid": ...}``,
``{"t": "annex", "key": ..., ["chunked": true]}``. Commits: ``{"tree",
"parents", "author", "timestamp", "message", ["spec"]}``.

Writes land loose; reads ask the pack index first, then the loose file.
"""
from __future__ import annotations

import json
import os
import zlib

from .files import read_bytes, write_atomic
from .hashing import sha256_bytes
from .packs import PACK_DIR, PackManager

KINDS = ("blob", "tree", "commit")


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _frame(kind: str, payload: bytes) -> bytes:
    if kind not in KINDS:
        raise ValueError(f"unknown object kind {kind!r}")
    return kind.encode() + b" " + str(len(payload)).encode() + b"\0" + payload


class ObjectStore:
    def __init__(self, root: str, token: str | None = None):
        self.root = root  # .../objects
        self.token = token  # the writer's incarnation (tmp names)
        self.packs = PackManager(os.path.join(root, PACK_DIR))

    def _path(self, oid: str) -> str:
        return os.path.join(self.root, oid[:2], oid[2:])

    @staticmethod
    def oid_for(kind: str, payload: bytes) -> str:
        """The oid ``put(kind, payload)`` would assign, without writing."""
        return sha256_bytes(_frame(kind, payload))

    def put(self, kind: str, payload: bytes) -> str:
        framed = _frame(kind, payload)
        oid = sha256_bytes(framed)
        if not self.has(oid):
            # the temporary file lies outside the 2-hex shards, so a shard
            # listing (prefix search, the reference's repack) never sees it
            write_atomic(self._path(oid), zlib.compress(framed, 1), tmp_dir=self.root, token=self.token)
        return oid

    def has(self, oid: str) -> bool:
        return self.packs.has(oid) or os.path.exists(self._path(oid))

    def _read_compressed(self, oid: str) -> bytes:
        """The compressed frame from a pack or the loose file; on a miss the
        pack index is reloaded once (another process may have repacked)."""
        try:
            if self.packs.has(oid):
                return self.packs.read(oid)
            return read_bytes(self._path(oid))
        except FileNotFoundError:
            self.packs.load(force=True)
            if self.packs.has(oid):
                return self.packs.read(oid)
            try:
                return read_bytes(self._path(oid))
            except FileNotFoundError:
                raise FileNotFoundError(f"object {oid} is neither loose nor packed") from None

    def get(self, oid: str) -> tuple[str, bytes]:
        framed = zlib.decompress(self._read_compressed(oid))
        header, _, payload = framed.partition(b"\0")
        kind, _, length = header.decode().partition(" ")
        if int(length) != len(payload) or sha256_bytes(framed) != oid:
            raise IOError(f"corrupt object {oid}")
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
        if os.path.isdir(shard):
            matches.update(prefix[:2] + f for f in os.listdir(shard)
                           if (prefix[:2] + f).startswith(prefix))
        return sorted(matches)

    def put_blob(self, data: bytes) -> str:
        return self.put("blob", data)

    def put_tree(self, entries: dict) -> str:
        return self.put("tree", canonical_json(entries))

    def put_commit(self, commit: dict) -> str:
        return self.put("commit", canonical_json(commit))

    def get_blob(self, oid: str) -> bytes:
        return self._get_kind(oid, "blob")

    def get_tree(self, oid: str) -> dict:
        return json.loads(self._get_kind(oid, "tree"))

    def get_commit(self, oid: str) -> dict:
        return json.loads(self._get_kind(oid, "commit"))
