"""Annex: large-file content kept outside the object store (port of
``repro.core.annex``).

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

Every operation goes through the store's :class:`~.fsio.FS` and is charged
as the reference's is: ``ingest_file`` hashes while it writes (one read
pass, one write pass), a *known-key set* answers ``put``/``has`` of a key
written or seen before without a probe, and ``has(key, fresh=True)`` asks
the filesystem (numcopies checks never trust the set). The transfer units
of the remote tier (:mod:`.remote`) are ``receive_file`` and ``fetch_into``.

Crash points (:mod:`.faults`): ``chunk:mid-publish`` after the first chunk a
chunked ingest publishes, ``chunk:before-manifest`` before its manifest.
Temporary files carry the writer's incarnation token; a killed writer's are
left for a sweep: opening a store with ``sweep_on_open`` (the remote sites)
or ``Repository.sweep_stale_tmps`` (``recover``).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from collections.abc import Iterable

from .chunks import ChunkParams, Cutter
from .faults import is_crash
from .files import stale_tmps, sweep_stale_tmps, tmp_name, write_atomic
from .fsio import FS
from .hashing import (
    chunk_key_for_bytes,
    is_chunk_key,
    make_annex_key,
    make_chunk_key,
    parse_annex_key,
    verify_annex_key,
)

POINTER_PREFIX = b"#%REPRO-ANNEX%#"
POINTER_MAX = 256

CHUNK_MAGIC = b"#%REPRO-CHUNKS%#"
_CHUNK_FLUSH = 8 << 20  # chunk bytes held between two presence passes
KNOWN_KEY_CAP = 1 << 20  # bound the probe-skip set of a long-lived process


def make_pointer(key: str, chunked: bool = False) -> bytes:
    parse_annex_key(key)  # validate
    flag = b" chunked" if chunked else b""
    return POINTER_PREFIX + b" " + key.encode() + flag + b"\n"


def parse_pointer(data: bytes) -> str | None:
    """The annex key if ``data`` is a pointer file, else None."""
    parsed = parse_pointer_full(data)
    return None if parsed is None else parsed[0]


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
    """One key/value store of annexed content: the repository's local
    annex, or (as :class:`~.remote.RemoteStore`) a remote site. Stores may
    live on filesystems with different cost profiles (paper §2.6)."""

    def __init__(self, root: str, fs: FS, name: str = "local", sweep_on_open: bool = True,
                 chunk_params: ChunkParams | None = None, chunk_threshold: int | None = None):
        self.root = root
        self.fs = fs
        self.name = name
        self.chunk_params = chunk_params
        self.chunk_threshold = chunk_threshold
        # arms the manifest probe of copy_to and the transfers: a store that
        # never chunks keeps the plain objects' charges
        self.chunk_aware = chunk_params is not None
        self._known_lock = threading.Lock()
        self._known: set[str] = set()
        if sweep_on_open and os.path.isdir(root):
            self.sweep_stale_tmps()

    def _path(self, key: str) -> str:
        _, hx = parse_annex_key(key)
        return os.path.join(self.root, hx[:3], key)

    def _tmp_path(self) -> str:
        return tmp_name(self.root, self.fs.token)

    # -- known-key set -----------------------------------------------------
    def _mark_known(self, key: str) -> None:
        with self._known_lock:
            if len(self._known) >= KNOWN_KEY_CAP:
                self._known.clear()  # the set only skips probes: reset, never wrong
            self._known.add(key)

    def _is_known(self, key: str) -> bool:
        with self._known_lock:
            return key in self._known

    def _forget(self, key: str) -> None:
        with self._known_lock:
            self._known.discard(key)

    def has(self, key: str, fresh: bool = False) -> bool:
        """Presence. ``fresh=True`` bypasses the known-key set and asks the
        filesystem, and a miss then drops the key from the set: a stale
        positive must never stand where a drop or a fetch depends on it."""
        if not fresh and self._is_known(key):
            return True
        if self.fs.exists(self._path(key)):
            self._mark_known(key)
            return True
        if fresh:
            self._forget(key)
        return False

    def has_many(self, keys: Iterable[str], fresh: bool = False) -> set[str]:
        """Presence of a batch by per-key probes (known-key set first), never
        a listing of every shard."""
        return {key for key in keys if self.has(key, fresh=fresh)}

    def keys(self) -> list[str]:
        """Every stored key (whole objects, manifests and chunks)."""
        out = []
        if not self.fs.isdir(self.root):
            return out
        for shard in self.fs.listdir(self.root):
            d = os.path.join(self.root, shard)
            if self.fs.isdir(d):
                out.extend(self.fs.listdir(d))
        return out

    # -- the crash sweep -----------------------------------------------------
    def count_stale_tmps(self, max_age_s: float | None = 3600.0) -> int:
        return len(stale_tmps(self.fs, self.root, max_age_s))

    def sweep_stale_tmps(self, max_age_s: float | None = 3600.0) -> int:
        """Unlink the tmp files of writers that are provably dead (or older
        than ``max_age_s``); returns the count swept."""
        return sweep_stale_tmps(self.fs, self.root, max_age_s)

    # -- writes ----------------------------------------------------------------
    def _commit(self, tmp: str, key: str) -> None:
        """Publish a fully written tmp as ``key``: a rename, idempotent when
        another writer published the same content first."""
        self.fs.rename(tmp, self._path(key))
        self._mark_known(key)

    def _discard(self, tmp: str, e: BaseException) -> None:
        """Cleanup after a failed write: a dead process runs none, so on a
        crash the tmp leaks."""
        if not is_crash(e):
            self.fs.unlink(tmp)

    def _publish_raw(self, key: str, data: bytes) -> None:
        """Write checked bytes (content, a chunk, a manifest) to a tmp and
        publish them as ``key``."""
        tmp = self._tmp_path()
        try:
            self.fs.write_bytes(tmp, data)
            self._commit(tmp, key)
        except BaseException as e:
            self._discard(tmp, e)
            raise

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
        self._publish_raw(key, data)

    def _publish_stream(self, blocks: Iterable[bytes], key: str | None = None,
                        what: str = "stream") -> str:
        """Hash ``blocks`` while writing them to a tmp, then publish the tmp
        as their key: refused when ``key`` is given and differs, discarded
        when the store holds the key already. Returns the key."""
        h = hashlib.sha256()

        def hashing():
            for b in blocks:
                h.update(b)
                yield b

        tmp = self._tmp_path()
        try:
            size = self.fs.write_chunks(tmp, hashing())
            got = (make_chunk_key if key is not None and is_chunk_key(key) else make_annex_key)(h.hexdigest(), size)
            if key is not None and got != key:
                raise IOError(f"content of {what} does not match key {key}")
            if key is None and self.has(got):
                self.fs.unlink(tmp)  # the content is stored already
            else:
                self._commit(tmp, got)
        except BaseException as e:
            self._discard(tmp, e)
            raise
        return got

    def put_file(self, key: str, src: str) -> None:
        """Copy the file ``src`` in as ``key``, hashing while copying; the
        tmp is published only if its content matches the key."""
        if self.has(key):
            return
        with self.fs.open_read(src) as chunks:
            self._publish_stream(chunks, key, src)

    def ingest_file(self, src: str, chunk_size: int = 1 << 20, chunked: bool = False) -> str:
        """Single-pass ingest of the file ``src``, read in blocks of
        ``chunk_size`` bytes (one charged read, one charged write); duplicate
        content is written once. Returns the key. ``chunked`` routes it
        through the chunk tier."""
        with self.fs.open_read(src, chunk_size) as chunks:
            return self._ingest_chunked(chunks) if chunked else self._publish_stream(chunks)

    def put_stream(self, blocks: Iterable[bytes], chunked: bool = False) -> str:
        """Ingest an iterable of byte blocks (process memory: only the write
        is charged), hashing while writing; returns the key."""
        return self._ingest_chunked(blocks) if chunked else self._publish_stream(blocks)

    def _ingest_chunked(self, blocks: Iterable[bytes]) -> str:
        """Cut, hash and publish in one pass: chunks the store lacks are
        written in batches, then the manifest on the whole content's key."""
        if self.chunk_params is None:
            raise ValueError(f"store {self.name} has no chunk params configured")
        cutter = Cutter(self.chunk_params)
        full = hashlib.sha256()
        total = 0
        chunk_keys: list[str] = []
        pending: list[tuple[str, bytes]] = []
        pending_bytes = 0
        published = 0

        def flush():
            nonlocal pending, pending_bytes, published
            if not pending:
                return
            present = self.has_many([k for k, _ in pending])
            for ck, data in pending:
                if ck not in present:
                    self._publish_raw(ck, data)
                    present.add(ck)  # a chunk repeated within the batch
                    published += 1
                    if published == 1:
                        self.fs.crash_point("chunk:mid-publish")
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
        self.fs.crash_point("chunk:before-manifest")
        if not self.has(key):
            self._publish_raw(key, encode_chunk_manifest(key, chunk_keys, self.chunk_params))
        return key

    def put_manifest(self, key: str, chunk_keys: list[str]) -> None:
        """Bind chunks this store holds to ``key`` with a manifest (the
        transfers move chunks one by one, then bind them)."""
        if self.has(key):
            return
        self._publish_raw(key, encode_chunk_manifest(key, chunk_keys, self.chunk_params))

    # -- transfers between stores --------------------------------------------
    def receive_file(self, key: str, src_fs: FS, src_path: str) -> bool:
        """Accept one object from another store's file (the push unit): on a
        shared filesystem ``put_file`` charges the read and the write here.
        Returns False when the key is here already."""
        del src_fs  # same filesystem: put_file reads on self.fs
        if self.has(key):
            return False
        self.put_file(key, src_path)
        return True

    def fetch_into(self, key: str, dst: "AnnexStore") -> bool:
        """Copy one object into ``dst`` (the fetch unit), charged on
        ``dst``'s filesystem. Returns False when ``dst`` holds it already."""
        if dst.has(key):
            return False
        dst.put_file(key, self._path(key))
        return True

    # -- reads and deletion -----------------------------------------------------
    def copy_to(self, key: str, dst: str, tmp_dir: str | None = None) -> None:
        """Publish ``key``'s content at ``dst`` (through a temporary file in
        ``tmp_dir``): a whole object streamed, a chunked one reassembled
        with every chunk verified."""
        chunks = self.manifest_of(key) if self.chunk_aware else None
        if chunks is None:
            with self.fs.open_read(self._path(key)) as blocks:
                write_atomic(self.fs, dst, blocks, tmp_dir=tmp_dir)
            return

        def gen():
            for ck in chunks:
                cd = self.fs.read_bytes(self._path(ck))
                if not verify_annex_key(ck, cd):
                    raise IOError(f"chunk corruption for {ck} (of {key}) in store {self.name}")
                yield cd

        write_atomic(self.fs, dst, gen(), tmp_dir=tmp_dir)

    def read(self, key: str) -> bytes:
        """The content of ``key``, reassembled if chunked; every chunk and
        the whole are verified against their keys."""
        data = self.fs.read_bytes(self._path(key))
        mf = parse_chunk_manifest(data, key)
        if mf is not None:
            parts = []
            for ck in mf["chunks"]:
                cd = self.fs.read_bytes(self._path(ck))
                if not verify_annex_key(ck, cd):
                    raise IOError(f"chunk corruption for {ck} (of {key}) in store {self.name}")
                parts.append(cd)
            data = b"".join(parts)
        if not verify_annex_key(key, data):
            raise IOError(f"annex corruption for {key} in store {self.name}")
        self._mark_known(key)
        return data

    def manifest_of(self, key: str) -> list[str] | None:
        """Chunk keys of ``key`` if it is stored chunked here, else None. A
        manifest is the one object whose stored size differs from the size
        its key embeds, so a plain object costs one stat."""
        if is_chunk_key(key):
            return None
        content_size, _ = parse_annex_key(key)
        path = self._path(key)
        if self.fs.stat_size(path) == content_size:
            return None
        mf = parse_chunk_manifest(self.fs.read_bytes(path), key)
        if mf is None:
            raise IOError(f"annex corruption for {key} in store {self.name}: stored size differs from key size "
                          "but content is not a chunk manifest")
        return list(mf["chunks"])

    def drop(self, key: str) -> None:
        """Remove ``key`` (a chunked key's manifest; its chunks stay)."""
        self._forget(key)
        self.fs.unlink(self._path(key))

    def sweep_orphan_chunks(self) -> int:
        """Drop the chunks no manifest in this store references: what a
        crashed chunked ingest (chunks publish before the manifest) or the
        drop of a chunked key leaves. A charged listing of every shard and
        one stat per whole-content key, so it runs in ``Session.gc()``,
        quiesced, never on the ingest path. Returns the count swept."""
        names = self.keys()
        chunk_keys = {k for k in names if is_chunk_key(k)}
        if not chunk_keys:
            return 0
        referenced: set[str] = set()
        for k in names:
            if is_chunk_key(k):
                continue
            try:
                referenced.update(self.manifest_of(k) or ())
            except (OSError, ValueError):
                continue  # a corrupt or foreign entry: verify()'s to report
        swept = 0
        for ck in chunk_keys - referenced:
            try:
                self.drop(ck)
                swept += 1
            except OSError:
                pass  # a racing sweeper got it first
        return swept
