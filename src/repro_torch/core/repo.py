"""Repository: working tree + object store + annex + branches (port of the
part of ``repro.core.repo`` that checkpoints go through).

``.repro/config.json`` holds the reference's keys in its order, ``HEAD``
names the current branch and ``refs/heads/<branch>`` holds its tip.
``save(paths)`` stages the named paths (pointer files pass through, files at
or above the annex threshold go to the annex, the rest become blobs) and
commits incrementally: only the dirty spine of the tree is rebuilt, and
unchanged subtrees keep their oid. Both packages give the same tree oids
for the same content.

``tree_of`` flattens a commit's tree and ``log`` walks the commit DAG, as
the reference's do. Not ported (ROADMAP.md §A item 2): remote annex tiers,
clone, checkout, merges, pack writing, gc, the filesystem cost model and
crash points.
"""
from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
import uuid

from .annex import POINTER_MAX, AnnexStore, parse_pointer_full
from .chunks import ChunkParams
from .files import read_bytes, write_atomic
from .hashing import annex_key_for_bytes
from .objects import ObjectStore

REPRO_DIR = ".repro"
DEFAULT_ANNEX_THRESHOLD = 64 * 1024  # bytes; files >= this are annexed
_BLOCK = 1 << 20


class ConflictError(Exception):
    pass


class Repository:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.repro_dir = os.path.join(self.root, REPRO_DIR)
        cfg_path = os.path.join(self.repro_dir, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"not a repro repository: {root}")
        # serialises a ref's read-modify-publish among threads of this process
        self.ref_lock = threading.RLock()
        self.config = json.loads(read_bytes(cfg_path))
        self.objects = ObjectStore(os.path.join(self.repro_dir, "objects"))
        cp = self.config.get("chunk_params")
        self._chunk_params = ChunkParams.from_json(cp) if cp else None
        self._chunk_threshold = self.config.get("chunk_threshold")
        self.annex = AnnexStore(os.path.join(self.repro_dir, "annex", "objects"),
                                chunk_params=self._chunk_params,
                                chunk_threshold=self._chunk_threshold)

    @classmethod
    def init(
        cls,
        root: str,
        annex_threshold: int = DEFAULT_ANNEX_THRESHOLD,
        chunk_threshold: int | None = None,
        chunk_params: ChunkParams | dict | None = None,
    ) -> "Repository":
        """A new repository at ``root``. ``chunk_threshold`` turns the chunk
        tier on for content of at least that many bytes (default cutter
        parameters unless ``chunk_params`` is given)."""
        root = os.path.abspath(root)
        repro_dir = os.path.join(root, REPRO_DIR)
        for sub in ("objects", os.path.join("refs", "heads"), os.path.join("annex", "objects")):
            os.makedirs(os.path.join(repro_dir, sub), exist_ok=True)
        if isinstance(chunk_params, dict):
            chunk_params = ChunkParams.from_json(chunk_params)
        if chunk_threshold is not None and chunk_params is None:
            chunk_params = ChunkParams()
        cfg = {
            "dsid": str(uuid.uuid4()),
            "annex_threshold": annex_threshold,
            "annex_patterns": [],
            "annex_remotes": [],
            "remotes": [],
            "numcopies": 1,
            "chunk_threshold": chunk_threshold,
            "chunk_params": chunk_params.to_json() if chunk_params else None,
        }
        write_atomic(os.path.join(repro_dir, "config.json"), json.dumps(cfg).encode())
        write_atomic(os.path.join(repro_dir, "HEAD"), b"main")
        return cls(root)

    @property
    def dsid(self) -> str:
        return self.config["dsid"]

    def write_file(self, relpath: str, data: bytes) -> None:
        """Publish a worktree file whole (its temporary file lies in
        ``.repro/``, where no staging sees it)."""
        write_atomic(os.path.join(self.root, relpath), data, tmp_dir=self.repro_dir)

    # -- refs ------------------------------------------------------------
    def _ref_path(self, branch: str) -> str:
        return os.path.join(self.repro_dir, "refs", "heads", branch)

    def current_branch(self) -> str:
        return read_bytes(os.path.join(self.repro_dir, "HEAD")).decode().strip()

    def branch_head(self, branch: str) -> str | None:
        p = self._ref_path(branch)
        if not os.path.exists(p):
            return None
        return read_bytes(p).decode().strip()

    def head_commit(self) -> str | None:
        return self.branch_head(self.current_branch())

    def set_branch(self, branch: str, oid: str) -> None:
        write_atomic(self._ref_path(branch), oid.encode(), tmp_dir=self.repro_dir)

    def resolve(self, commitish: str) -> str:
        """Branch name, full oid, or unique oid prefix (>= 4 hex) -> full oid."""
        if os.path.exists(self._ref_path(commitish)):
            return self.branch_head(commitish)  # type: ignore[return-value]
        if self.objects.has(commitish):
            return commitish
        matches = self.objects.find_prefix(commitish) if len(commitish) >= 4 else []
        if len(matches) == 1:
            return matches[0]
        raise ValueError(f"cannot resolve {commitish!r} ({len(matches)} matches)")

    # -- trees -----------------------------------------------------------
    def _tree_oid_of(self, commit_oid: str | None) -> str | None:
        if commit_oid is None:
            return None
        return self.objects.get_commit(commit_oid)["tree"] or None

    def tree_of(self, commit_oid: str) -> dict[str, dict]:
        """Flat {relpath: entry} map of a commit's tree (entries: blob|annex)."""
        commit = self.objects.get_commit(commit_oid)
        flat: dict[str, dict] = {}

        def walk(tree_oid: str, prefix: str) -> None:
            for name, entry in self.objects.get_tree(tree_oid).items():
                p = f"{prefix}{name}"
                if entry["t"] == "tree":
                    walk(entry["oid"], p + "/")
                else:
                    flat[p] = entry

        if commit["tree"]:
            walk(commit["tree"], "")
        return flat

    def entry_at(self, commit_oid: str, path: str) -> dict | None:
        """One path's tree entry in a commit, looked up along its spine."""
        tree_oid = self._tree_oid_of(commit_oid)
        parts = path.split("/")
        for part in parts[:-1]:
            if tree_oid is None:
                return None
            e = self.objects.get_tree(tree_oid).get(part)
            if e is None or e["t"] != "tree":
                return None
            tree_oid = e["oid"]
        if tree_oid is None:
            return None
        return self.objects.get_tree(tree_oid).get(parts[-1])

    def _update_tree(self, base_tree_oid: str | None, changes: dict[str, dict | None]) -> str | None:
        """Apply ``changes`` ({relpath: entry}, None = delete) on top of
        ``base_tree_oid``, writing only the trees along the changed paths.
        Returns the new tree oid (None for an empty tree)."""
        if not changes:
            return base_tree_oid
        entries = self.objects.get_tree(base_tree_oid) if base_tree_oid else {}
        direct: dict[str, dict | None] = {}
        groups: dict[str, dict[str, dict | None]] = {}
        for path, entry in changes.items():
            name, sep, rest = path.partition("/")
            if sep:
                groups.setdefault(name, {})[rest] = entry
            else:
                direct[name] = entry
        for name, sub in groups.items():
            if direct.get(name) is not None:
                if any(e is not None for e in sub.values()):
                    raise ConflictError(f"file/directory conflict at {name!r}")
                continue  # the file replaces the subtree
            existing = entries.get(name)
            sub_base = existing["oid"] if existing and existing["t"] == "tree" else None
            sub_oid = self._update_tree(sub_base, sub)
            if sub_oid is None:
                entries.pop(name, None)
            else:
                entries[name] = {"t": "tree", "oid": sub_oid}
        for name, entry in direct.items():
            if entry is None:
                if name not in groups:
                    entries.pop(name, None)
            else:
                entries[name] = entry
        if not entries:
            return None
        return self.objects.put_tree(entries)

    # -- staging ---------------------------------------------------------
    def _should_annex(self, relpath: str, size: int) -> bool:
        if size >= self.config["annex_threshold"]:
            return True
        # the port's init writes no patterns; a repository made by the reference may have some
        return any(fnmatch.fnmatch(relpath, pat) for pat in self.config.get("annex_patterns", ()))

    def _should_chunk(self, size: int) -> bool:
        return (self._chunk_threshold is not None and self._chunk_params is not None
                and size >= self._chunk_threshold)

    @staticmethod
    def _annex_entry(key: str, chunked: bool) -> dict:
        e = {"t": "annex", "key": key}
        if chunked:
            e["chunked"] = True
        return e

    def _entry_for_data(self, relpath: str, data: bytes) -> dict:
        """Tree entry for small content: a pointer passes through, content
        annexed by pattern goes to the annex, the rest is a blob."""
        parsed = parse_pointer_full(data)
        if parsed is not None:
            return self._annex_entry(*parsed)
        if self._should_annex(relpath, len(data)):
            key = annex_key_for_bytes(data)
            self.annex.put_bytes(key, data)
            return self._annex_entry(key, self._should_chunk(len(data)))
        return {"t": "blob", "oid": self.objects.put_blob(data)}

    def _hash_working_file(self, relpath: str) -> dict:
        """Stage one worktree file: annex-sized files stream into the annex,
        the rest are read whole."""
        abspath = os.path.join(self.root, relpath)
        size = os.path.getsize(abspath)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            chunked = self._should_chunk(size)

            def blocks():
                with open(abspath, "rb") as f:
                    while block := f.read(_BLOCK):
                        yield block

            return self._annex_entry(self.annex.put_stream(blocks(), chunked=chunked), chunked)
        return self._entry_for_data(relpath, read_bytes(abspath))

    def _expand_paths(self, paths) -> list[str]:
        out: list[str] = []
        for p in paths:
            rel = os.path.relpath(os.path.join(self.root, p), self.root)
            if rel.startswith(".."):
                raise ValueError(f"path escapes repository: {p}")
            abspath = os.path.join(self.root, rel)
            if os.path.isdir(abspath):
                for dirpath, dirnames, files in os.walk(abspath):
                    dirnames[:] = [d for d in dirnames if d != REPRO_DIR]
                    for f in sorted(files):
                        out.append(os.path.relpath(os.path.join(dirpath, f), self.root))
            elif os.path.exists(abspath):
                out.append(rel)
            else:
                raise FileNotFoundError(f"no such path: {p}")
        return [r for r in out if r != REPRO_DIR and not r.startswith(REPRO_DIR + "/")]

    def stage_paths(self, paths) -> dict[str, dict]:
        """{relpath: tree entry} for ``paths`` (files or directories),
        writing blob and annex content as needed."""
        return {rel: self._hash_working_file(rel) for rel in dict.fromkeys(self._expand_paths(paths))}

    # -- committing ------------------------------------------------------
    def commit_changes(
        self,
        changes: dict[str, dict | None],
        message: str = "",
        base_commit: str | None = None,
        base_tree: str | None = None,
        spec: dict | None = None,
    ) -> tuple[str, str | None]:
        """Apply ``changes`` on top of ``base_tree`` and write a commit whose
        parent is ``base_commit``; moves no ref. Returns ``(commit oid, tree
        oid)``, or the base commit when nothing changed. ``spec`` (a RunSpec
        JSON dict) becomes the commit's ``spec`` field."""
        tree_oid = self._update_tree(base_tree, changes)
        if tree_oid == base_tree and base_commit is not None:
            return base_commit, base_tree
        commit = {
            "tree": tree_oid or "",
            "parents": [base_commit] if base_commit else [],
            "author": "repro",
            "timestamp": time.time(),
            "message": message,
        }
        if spec is not None:
            commit["spec"] = spec
        return self.objects.put_commit(commit), tree_oid

    def save(self, paths, message: str = "", spec: dict | None = None) -> str:
        """Stage ``paths`` (files or directories) on top of the current
        branch's tree and commit; moves the branch. Returns the commit oid."""
        branch = self.current_branch()
        with self.ref_lock:
            base = self.branch_head(branch)
            oid, _ = self.commit_changes(
                self.stage_paths(paths), message=message, base_commit=base,
                base_tree=self._tree_oid_of(base), spec=spec,
            )
            if oid != base:
                self.set_branch(branch, oid)
            return oid

    # -- history ---------------------------------------------------------
    def log(self, start: str | None = None):
        """Yield (oid, commit) from ``start`` (default HEAD) over all parents,
        newest first by timestamp."""
        start = start or self.head_commit()
        if start is None:
            return
        seen: set[str] = set()
        frontier = [self.resolve(start)]
        commits = []
        while frontier:
            oid = frontier.pop()
            if oid in seen:
                continue
            seen.add(oid)
            c = self.objects.get_commit(oid)
            commits.append((oid, c))
            frontier.extend(c["parents"])
        commits.sort(key=lambda oc: -oc[1]["timestamp"])
        yield from commits

    # -- annex -----------------------------------------------------------
    def annex_fetch_key(self, key: str) -> AnnexStore:
        """The local store, which must hold ``key``: fetching from another
        store is not ported."""
        if self.annex.has(key):
            return self.annex
        raise FileNotFoundError(
            f"{key} is not in the local annex, and fetching from a remote store is not ported "
            f"(ROADMAP.md §A item 2)")
