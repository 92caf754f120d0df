"""Repository: working tree + object store + annex + branches (port of the
part of ``repro.core.repo`` that checkpoints and the Slurm protocol go
through).

``.repro/config.json`` holds the reference's keys in its order, ``HEAD``
names the current branch and ``refs/heads/<branch>`` holds its tip.
``save(paths)`` stages the named paths (pointer files pass through, files at
or above the annex threshold go to the annex, the rest become blobs) and
commits incrementally: only the dirty spine of the tree is rebuilt, and
unchanged subtrees keep their oid. Both packages give the same tree oids
for the same content.

``tree_of`` flattens a commit's tree and ``log`` walks the commit DAG, as
the reference's do. For the scheduler: per-job branches and the octopus
merge of paper §5.8, the read-only ``hash_path_entry`` that ``rerun`` and
the run cache compare with, ``ingest_external_file`` for ``--alt-dir``
outputs, ``annex_get`` and ``whereis_many`` over the local store,
``lock``/``unlock`` and the cross-process ``file_lock``. Not ported
(ROADMAP.md §A item 2): remote annex tiers, clone, checkout and switch,
pack writing, gc, the filesystem cost model and crash points.
"""
from __future__ import annotations

import errno
import fnmatch
import hashlib
import json
import os
import shutil
import threading
import time
import uuid

from .annex import POINTER_MAX, AnnexStore, make_pointer, parse_pointer_full
from .chunks import ChunkParams
from .files import file_blocks, read_bytes, write_atomic
from .hashing import annex_key_for_bytes, make_annex_key
from .locks import LOCKS_DIR, FileLock
from .objects import ObjectStore

REPRO_DIR = ".repro"
DEFAULT_ANNEX_THRESHOLD = 64 * 1024  # bytes; files >= this are annexed


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

    def file_lock(self, name: str, ttl_s: float = 600.0) -> FileLock:
        """Cross-process advisory lock ``.repro/locks/<name>.lock``; a stale
        (dead-owner) lock is broken on acquire."""
        return FileLock(os.path.join(self.repro_dir, LOCKS_DIR, f"{name}.lock"), ttl_s=ttl_s)

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

    def branches(self) -> list[str]:
        d = os.path.join(self.repro_dir, "refs", "heads")
        return sorted(os.path.relpath(os.path.join(dirpath, f), d)
                      for dirpath, _, files in os.walk(d) for f in files)

    def head_commit(self) -> str | None:
        return self.branch_head(self.current_branch())

    def set_branch(self, branch: str, oid: str) -> None:
        write_atomic(self._ref_path(branch), oid.encode(), tmp_dir=self.repro_dir)

    def create_branch(self, branch: str, at: str | None = None) -> None:
        at = at or self.head_commit()
        if at is None:
            raise ValueError("cannot branch from an empty repository")
        if os.path.exists(self._ref_path(branch)):
            raise ValueError(f"branch exists: {branch}")
        self.set_branch(branch, at)

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

    def _diff_trees(self, a_oid: str | None, b_oid: str | None, prefix: str = "") -> dict[str, dict | None]:
        """Flat changes turning tree ``a`` into tree ``b``: {path: entry} for
        adds and modifications, {path: None} for deletions. Subtrees with
        equal oids are skipped without reading them."""
        if a_oid == b_oid:
            return {}
        a = self.objects.get_tree(a_oid) if a_oid else {}
        b = self.objects.get_tree(b_oid) if b_oid else {}
        out: dict[str, dict | None] = {}
        for name, be in b.items():
            ae = a.get(name)
            if ae == be:
                continue
            p = prefix + name
            a_sub = ae["oid"] if ae is not None and ae["t"] == "tree" else None
            if be["t"] == "tree":
                out.update(self._diff_trees(a_sub, be["oid"], p + "/"))
            else:
                out[p] = be
        for name, ae in a.items():
            if name in b:
                continue
            p = prefix + name
            if ae["t"] == "tree":
                out.update(self._diff_trees(ae["oid"], None, p + "/"))
            else:
                out[p] = None
        return out

    # -- staging ---------------------------------------------------------
    @staticmethod
    def _is_ignored(relpath: str) -> bool:
        return relpath == REPRO_DIR or relpath.startswith(REPRO_DIR + "/")

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
            return self._annex_entry(self.annex.put_stream(file_blocks(abspath), chunked=chunked), chunked)
        return self._entry_for_data(relpath, read_bytes(abspath))

    def hash_path_entry(self, relpath: str) -> dict:
        """The tree entry staging ``relpath`` would produce, computed
        read-only: no blob, no annex object is written (``rerun``'s bitwise
        check and the run cache's input keys)."""
        abspath = os.path.join(self.root, relpath)
        size = os.path.getsize(abspath)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            h = hashlib.sha256()
            for block in file_blocks(abspath):
                h.update(block)
            return self._annex_entry(make_annex_key(h.hexdigest(), size), self._should_chunk(size))
        data = read_bytes(abspath)
        parsed = parse_pointer_full(data)
        if parsed is not None:
            return self._annex_entry(*parsed)
        if self._should_annex(relpath, len(data)):
            return self._annex_entry(annex_key_for_bytes(data), self._should_chunk(len(data)))
        return {"t": "blob", "oid": self.objects.oid_for("blob", data)}

    def ingest_external_file(self, src: str, relpath: str) -> dict:
        """Absorb a file the caller owns (an ``--alt-dir`` output) into the
        repository at ``relpath``: its content is staged from ``src``, then
        ``src`` itself is renamed into the worktree (copied and unlinked
        across devices). Returns the tree entry."""
        size = os.path.getsize(src)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            chunked = self._should_chunk(size)
            entry = self._annex_entry(self.annex.put_stream(file_blocks(src), chunked=chunked), chunked)
        else:
            entry = self._entry_for_data(relpath, read_bytes(src))
        dst = os.path.join(self.root, relpath)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except OSError as e:
            if e.errno != errno.EXDEV:  # only cross-device falls back
                raise
            shutil.copyfile(src, dst)
            os.unlink(src)
        return entry

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
                        r = os.path.relpath(os.path.join(dirpath, f), self.root)
                        if not self._is_ignored(r):
                            out.append(r)
            elif os.path.exists(abspath):
                if not self._is_ignored(rel):
                    out.append(rel)
            else:
                raise FileNotFoundError(f"no such path: {p}")
        return out

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
        allow_empty: bool = False,
    ) -> tuple[str, str | None]:
        """Apply ``changes`` on top of ``base_tree`` and write a commit whose
        parent is ``base_commit``; moves no ref. Returns ``(commit oid, tree
        oid)``, or the base commit when nothing changed and ``allow_empty``
        is false. ``spec`` (a RunSpec JSON dict) becomes the commit's
        ``spec`` field."""
        tree_oid = self._update_tree(base_tree, changes)
        if tree_oid == base_tree and base_commit is not None and not allow_empty:
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

    def save(self, paths=None, message: str = "", spec: dict | None = None) -> str:
        """Stage ``paths`` (files or directories; None = the whole worktree,
        which also records tracked files that are gone) on top of the
        current branch's tree and commit; moves the branch. Returns the
        commit oid."""
        branch = self.current_branch()
        with self.ref_lock:
            base = self.branch_head(branch)
            base_tree = self._tree_oid_of(base)
            if paths is None:
                flat = self.tree_of(base) if base else {}
                expanded = set(self._expand_paths(p for p in os.listdir(self.root) if not self._is_ignored(p)))
                # isfile: a tracked file whose path is now a directory is gone
                changes: dict[str, dict | None] = {
                    known: None for known in flat
                    if known not in expanded and not os.path.isfile(os.path.join(self.root, known))}
                for rel in sorted(expanded):
                    entry = self._hash_working_file(rel)
                    if flat.get(rel) != entry:
                        changes[rel] = entry
            else:
                changes = dict(self.stage_paths(paths))
            oid, _ = self.commit_changes(changes, message=message, base_commit=base, base_tree=base_tree, spec=spec)
            if oid != base:
                self.set_branch(branch, oid)
            return oid

    def merge_octopus(self, branches: list[str], message: str = "") -> str:
        """N-parent merge onto the current branch (paper §5.8): the union of
        each branch's changes against the branch's tip; a path two branches
        changed to different contents is a conflict (the scheduler's §5.5
        checks refuse such jobs before they run). The merged paths are
        written to the worktree."""
        with self.ref_lock:
            branch = self.current_branch()
            base_oid = self.head_commit()
            base_tree = self._tree_oid_of(base_oid)
            merged: dict[str, dict] = {}
            provenance: dict[str, str] = {}
            parent_oids = [base_oid] if base_oid else []
            for b in branches:
                b_oid = self.resolve(b)
                parent_oids.append(b_oid)
                for path, entry in self._diff_trees(base_tree, self._tree_oid_of(b_oid)).items():
                    if entry is None:
                        continue  # union semantics: a branch's deletions don't merge
                    if path in provenance and merged.get(path) != entry:
                        raise ConflictError(f"octopus conflict on {path!r} between {provenance[path]} and {b}")
                    merged[path] = entry
                    provenance[path] = b
            commit = {
                "tree": self._update_tree(base_tree, merged) or "",
                "parents": parent_oids,
                "author": "repro",
                "timestamp": time.time(),
                "message": message or f"octopus merge of {len(branches)} branches",
            }
            oid = self.objects.put_commit(commit)
            self.set_branch(branch, oid)
            for path, entry in sorted(merged.items()):
                self.materialize(path, entry)
            return oid

    def materialize(self, relpath: str, entry: dict) -> None:
        """Write one tree entry to the worktree: a blob's bytes, annexed
        content when the local store holds it, else its pointer file."""
        abspath = os.path.join(self.root, relpath)
        if entry["t"] == "blob":
            self.write_file(relpath, self.objects.get_blob(entry["oid"]))
        elif self.annex.has(entry["key"]):
            self.annex.copy_to(entry["key"], abspath, tmp_dir=self.repro_dir)
        else:
            self.write_file(relpath, make_pointer(entry["key"], chunked=entry.get("chunked", False)))

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
    def whereis_many(self, keys: list[str]) -> dict[str, list[str]]:
        """{key: names of the stores holding it}; the port has the local
        store (``"local"``) alone."""
        present = self.annex.has_many(keys)
        return {key: ["local"] if key in present else [] for key in keys}

    def annex_key_at(self, path: str, commitish: str | None = None) -> str:
        oid = self.resolve(commitish) if commitish else self.head_commit()
        if oid is None:
            raise KeyError("empty repository")
        entry = self.entry_at(oid, path)
        if entry is None or entry["t"] != "annex":
            raise KeyError(f"{path} is not an annexed file")
        return entry["key"]

    def annex_get(self, path: str) -> bool:
        """Give the worktree file at ``path`` its content if it is a pointer
        (datalad get), from the local store. Returns True if it was one."""
        parsed = parse_pointer_full(read_bytes(os.path.join(self.root, path)))
        if parsed is None:
            return False  # already content
        key, _ = parsed
        self.annex_fetch_key(key).copy_to(key, os.path.join(self.root, path), tmp_dir=self.repro_dir)
        return True

    def annex_fetch_key(self, key: str) -> AnnexStore:
        """The local store, which must hold ``key``: fetching from another
        store is not ported."""
        if self.annex.has(key):
            return self.annex
        raise FileNotFoundError(
            f"{key} is not in the local annex, and fetching from a remote store is not ported "
            f"(ROADMAP.md §A item 2)")

    # -- lock/unlock -----------------------------------------------------
    def unlock(self, path: str) -> None:
        abspath = os.path.join(self.root, path)
        if os.path.exists(abspath):
            os.chmod(abspath, 0o644)

    def lock(self, path: str) -> None:
        abspath = os.path.join(self.root, path)
        if os.path.exists(abspath):
            os.chmod(abspath, 0o444)
