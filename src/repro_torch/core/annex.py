"""Annex: large-file content kept outside the object store (port of the
local-store part of ``repro.core.annex``).

A tree carries a pointer to the content, ``#%REPRO-ANNEX%# <key>\\n``
(v1), or ``#%REPRO-ANNEX%# <key> chunked\\n`` (v2) when the content is
stored chunked. The content lives under ``annex/objects/<3-hex>/<key>``.

Chunk tier (DESIGN.md §12): a chunked object is stored at its key path as a
manifest, ``#%REPRO-CHUNKS%#\\n{"chunks": [...], "cutter": {...}, "key":
..., "v": 1}``, which lists the content-defined chunks (``SHA256C-…`` keys,
cut by :mod:`.chunks`) whose concatenation is the content. Chunks are
published first, the manifest last, so an interrupted ingest leaves only
unreferenced chunks. ``read`` verifies every chunk and the whole content
against their keys.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections.abc import Iterable

from .chunks import ChunkParams, Cutter
from .files import file_blocks, read_bytes, tmp_name, write_atomic
from .hashing import (
    chunk_key_for_bytes,
    is_chunk_key,
    make_annex_key,
    parse_annex_key,
    verify_annex_key,
)

POINTER_PREFIX = b"#%REPRO-ANNEX%#"
POINTER_MAX = 256

CHUNK_MAGIC = b"#%REPRO-CHUNKS%#"
_CHUNK_FLUSH = 8 << 20  # chunk bytes held between two presence passes


def make_pointer(key: str, chunked: bool = False) -> bytes:
    parse_annex_key(key)  # validate
    flag = b" chunked" if chunked else b""
    return POINTER_PREFIX + b" " + key.encode() + flag + b"\n"


def parse_pointer_full(data: bytes) -> tuple[str, bool] | None:
    """``(key, chunked)`` if ``data`` is a pointer file (v1 or v2), else None."""
    if len(data) > POINTER_MAX or not data.startswith(POINTER_PREFIX):
        return None
    try:
        fields = data[len(POINTER_PREFIX):].split()
        if not fields:
            return None
        return fields[0].decode(), b"chunked" in fields[1:]
    except UnicodeDecodeError:
        return None


def encode_chunk_manifest(key: str, chunk_keys: list[str], params: ChunkParams | None) -> bytes:
    body = {
        "v": 1,
        "key": key,
        "chunks": list(chunk_keys),
        "cutter": params.to_json() if params is not None else None,
    }
    return CHUNK_MAGIC + b"\n" + json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def parse_chunk_manifest(data: bytes, key: str | None = None) -> dict | None:
    """The manifest's body; None if ``data`` is not a manifest, or is one for
    another key than ``key`` (then it is ordinary content)."""
    if not data.startswith(CHUNK_MAGIC + b"\n"):
        return None
    try:
        body = json.loads(data[len(CHUNK_MAGIC) + 1:])
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    if not isinstance(body, dict) or "key" not in body or "chunks" not in body:
        return None
    if key is not None and body["key"] != key:
        return None
    return body


class AnnexStore:
    """The local key/value store of annexed content."""

    def __init__(self, root: str, chunk_params: ChunkParams | None = None,
                 chunk_threshold: int | None = None):
        self.root = root
        self.chunk_params = chunk_params
        self.chunk_threshold = chunk_threshold

    def _path(self, key: str) -> str:
        _, hx = parse_annex_key(key)
        return os.path.join(self.root, hx[:3], key)

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def has_many(self, keys: Iterable[str]) -> set[str]:
        return {key for key in keys if self.has(key)}

    def keys(self) -> list[str]:
        """Every stored key (whole objects, manifests and chunks)."""
        if not os.path.isdir(self.root):
            return []
        return [name for shard in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, shard))
                for name in os.listdir(os.path.join(self.root, shard))]

    def _publish(self, key: str, data: bytes) -> None:
        write_atomic(self._path(key), data, tmp_dir=self.root)

    def put_bytes(self, key: str, data: bytes) -> None:
        """Store ``data`` under ``key`` (checked), chunked at or above the
        store's chunk threshold."""
        if not verify_annex_key(key, data):
            raise ValueError(f"content does not match key {key}")
        if self.has(key):
            return
        if (self.chunk_threshold is not None and self.chunk_params is not None
                and not is_chunk_key(key) and len(data) >= self.chunk_threshold):
            mv = memoryview(data)
            self._ingest_chunked(mv[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20))
            return
        self._publish(key, data)

    def put_stream(self, blocks: Iterable[bytes], chunked: bool = False) -> str:
        """Ingest an iterable of byte blocks, hashing while writing; returns
        the key. Content already stored is not written twice."""
        if chunked:
            return self._ingest_chunked(blocks)
        h = hashlib.sha256()
        os.makedirs(self.root, exist_ok=True)
        tmp = tmp_name(self.root)
        try:
            size = 0
            with open(tmp, "wb") as f:
                for b in blocks:
                    h.update(b)
                    f.write(b)
                    size += len(b)
            key = make_annex_key(h.hexdigest(), size)
            if self.has(key):
                os.unlink(tmp)
            else:
                os.makedirs(os.path.dirname(self._path(key)), exist_ok=True)
                os.replace(tmp, self._path(key))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return key

    def _ingest_chunked(self, blocks: Iterable[bytes]) -> str:
        """Cut, hash and publish in one pass: chunks the store lacks are
        written in batches, then the manifest on the whole content's key."""
        if self.chunk_params is None:
            raise ValueError("this store has no chunk parameters configured")
        cutter = Cutter(self.chunk_params)
        full = hashlib.sha256()
        total = 0
        chunk_keys: list[str] = []
        pending: list[tuple[str, bytes]] = []
        pending_bytes = 0

        def flush():
            nonlocal pending, pending_bytes
            present = self.has_many(k for k, _ in pending)
            for ck, data in pending:
                if ck not in present:
                    self._publish(ck, data)
                    present.add(ck)  # a chunk repeated within the batch
            pending, pending_bytes = [], 0

        def take(chunk: bytes):
            nonlocal pending_bytes
            ck = chunk_key_for_bytes(chunk)
            chunk_keys.append(ck)
            pending.append((ck, chunk))
            pending_bytes += len(chunk)
            if pending_bytes >= _CHUNK_FLUSH:
                flush()

        for block in blocks:
            if not block:
                continue
            full.update(block)
            total += len(block)
            for chunk in cutter.feed(block):
                take(chunk)
        for chunk in cutter.finish():
            take(chunk)
        flush()
        key = make_annex_key(full.hexdigest(), total)
        if not self.has(key):
            self._publish(key, encode_chunk_manifest(key, chunk_keys, self.chunk_params))
        return key

    def copy_to(self, key: str, dst: str, tmp_dir: str | None = None) -> None:
        """Publish ``key``'s content at ``dst`` (through a temporary file in
        ``tmp_dir``): a whole object streamed, a chunked one reassembled
        with every chunk verified."""
        path = self._path(key)
        with open(path, "rb") as f:
            head = f.read(len(CHUNK_MAGIC) + 1)
        if head == CHUNK_MAGIC + b"\n" and parse_chunk_manifest(read_bytes(path), key) is not None:
            write_atomic(dst, self.read(key), tmp_dir=tmp_dir)
        else:
            write_atomic(dst, file_blocks(path), tmp_dir=tmp_dir)

    def read(self, key: str) -> bytes:
        """The content of ``key``, reassembled if chunked; every chunk and
        the whole are verified against their keys."""
        data = read_bytes(self._path(key))
        mf = parse_chunk_manifest(data, key)
        if mf is not None:
            parts = []
            for ck in mf["chunks"]:
                cd = read_bytes(self._path(ck))
                if not verify_annex_key(ck, cd):
                    raise IOError(f"chunk corruption for {ck} (of {key})")
                parts.append(cd)
            data = b"".join(parts)
        if not verify_annex_key(key, data):
            raise IOError(f"annex corruption for {key}")
        return data
