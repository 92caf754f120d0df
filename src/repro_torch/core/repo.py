"""Repository: working tree + object store + annex + branches (port of
``repro.core.repo``).

``.repro/config.json`` holds the reference's keys in its order, ``HEAD``
names the current branch and ``refs/heads/<branch>`` holds its tip.
``save(paths)`` stages the named paths (pointer files pass through, files at
or above the annex threshold go to the annex, the rest become blobs) and
commits incrementally: only the dirty spine of the tree is rebuilt, and
unchanged subtrees keep their oid. Both packages give the same tree oids
for the same content.

``tree_of`` flattens a commit's tree and ``log`` walks the commit DAG, as
the reference's do. ``checkout(commitish, paths=None)`` writes a commit's
files (or those at and below ``paths``) to the worktree: annexed content
where the *local* annex holds it, else its pointer file; ``switch`` moves
HEAD to a branch and checks it out. ``Repository.clone`` copies the objects
(loose and packed), the refs and HEAD, registers the origin's annex as the
co-located store ``remote0``, carries ``numcopies`` and the remote sites
over and checks out HEAD; annexed content stays behind until ``annex_get``
(paper §2.3). For the scheduler: per-job branches and the octopus
merge of paper §5.8, the read-only ``hash_path_entry`` that ``rerun`` and
the run cache compare with, ``ingest_external_file`` for ``--alt-dir``
outputs, ``lock``/``unlock`` and the cross-process ``file_lock``.

Every filesystem operation goes through one :class:`~.fsio.FS` per
repository, so the parallel-filesystem cost model (``init(profile=,
clock=)``) charges the whole stack. The remote annex tier (DESIGN.md §13,
:mod:`.remote`): ``add_remote`` registers a site, persisted in
``config.json``'s ``remotes`` as ``{"name", "root", "net"}`` and rebuilt on
open; ``whereis_many``, ``verified_copies`` (fresh probes only),
``annex_drop`` under ``numcopies``, and ``annex_fetch_key``/``annex_get``,
which fetch a key that is not local from the first site that holds it and
fail over past a site that is down or errors past its retries (the
reference's ``annex_fetch_key`` raises there instead: ROADMAP.md §C7).

For recovery (:mod:`.recovery`): a repository is one incarnation of its
writer, with the ``token`` of its FS (:mod:`.faults`) stamped on its tmp
files and lock files, and an optional fault plan whose named crash points it
marks (``crash_point``); ``sweep_stale_tmps`` removes the tmp files a killed
incarnation left (opening the repository does not: a sweep never runs
beside the other package's writes in one process).

The port publishes every file it writes (a loose object, a ref, HEAD, the
config, a worktree file, each file a clone copies) through a tmp and a
rename: two metadata operations more per file than the reference's direct
write, which a crash can tear.
"""
from __future__ import annotations

import errno
import fnmatch
import json
import os
import threading
import time
import uuid

from .annex import POINTER_MAX, AnnexStore, make_pointer, parse_pointer_full
from .chunks import ChunkParams
from .conflicts import proper_prefixes
from .faults import InjectedNetworkError, RemoteUnavailable, is_crash
from .files import stale_tmps, sweep_stale_tmps, tmp_name, write_atomic
from .fsio import FS, NULL_FS, FSProfile, SimClock
from .hashing import annex_key_for_bytes, make_annex_key
from .locks import LOCKS_DIR, FileLock
from .objects import ObjectStore, canonical_json
from .remote import NetworkFaultModel, RemoteStore, coerce_net, fetch_one, net_retry

REPRO_DIR = ".repro"
DEFAULT_ANNEX_THRESHOLD = 64 * 1024  # bytes; files >= this are annexed


class ConflictError(Exception):
    pass


class Repository:
    def __init__(self, root: str, fs: FS | None = None, net_faults: NetworkFaultModel | None = None):
        """Open the repository at ``root`` on ``fs`` (default: an uncharged
        FS; a fault plan rides on the FS); ``net_faults`` is the network
        fault model of its remote sites."""
        self.root = os.path.abspath(root)
        self.repro_dir = os.path.join(self.root, REPRO_DIR)
        cfg_path = os.path.join(self.repro_dir, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"not a repro repository: {root}")
        self.fs = fs if fs is not None else FS(NULL_FS)
        # this incarnation: its FS's token stamps tmp and lock files, and
        # dies with it when the fault plan crashes
        self.faults = self.fs.faults
        self.token = self.fs.token
        self.net_faults = net_faults
        # serialises a ref's read-modify-publish among threads of this process
        self.ref_lock = threading.RLock()
        self.config = json.loads(self.fs.read_bytes(cfg_path))
        self.objects = ObjectStore(os.path.join(self.repro_dir, "objects"), self.fs)
        cp = self.config.get("chunk_params")
        self._chunk_params = ChunkParams.from_json(cp) if cp else None
        self._chunk_threshold = self.config.get("chunk_threshold")
        self.annex = AnnexStore(os.path.join(self.repro_dir, "annex", "objects"), self.fs, sweep_on_open=False,
                                **self._store_kw())
        # co-located stores (a reference clone's origin) and the network
        # sites, on their own charged links sharing this clock and plan;
        # opening a site sweeps the tmps a killed push left there
        self._remotes: list[AnnexStore] = [
            AnnexStore(p, self.fs, name=f"remote{i}", **self._store_kw())
            for i, p in enumerate(self.config.get("annex_remotes", []))]
        self._remotes.extend(self._site(r["root"], r["name"], r.get("net")) for r in self.config.get("remotes", []))

    def _store_kw(self) -> dict:
        return {"chunk_params": self._chunk_params, "chunk_threshold": self._chunk_threshold}

    def _site(self, root: str, name: str, net) -> RemoteStore:
        return RemoteStore(root, clock=self.fs.clock, name=name, net=net, fault_model=self.net_faults,
                           faults=self.faults, **self._store_kw())

    @classmethod
    def init(
        cls,
        root: str,
        profile: FSProfile = NULL_FS,
        clock: SimClock | None = None,
        annex_threshold: int = DEFAULT_ANNEX_THRESHOLD,
        annex_patterns: tuple[str, ...] = (),
        dsid: str | None = None,
        faults=None,
        chunk_threshold: int | None = None,
        chunk_params: ChunkParams | dict | None = None,
        numcopies: int = 1,
        net_faults: NetworkFaultModel | None = None,
    ) -> "Repository":
        """A new repository at ``root`` on an FS of ``profile`` charging
        ``clock``. ``chunk_threshold`` turns the chunk tier on for content of
        at least that many bytes (default cutter parameters unless
        ``chunk_params`` is given); ``annex_patterns`` are globs of paths
        annexed whatever their size; ``dsid`` names the dataset (default a
        new uuid); ``numcopies`` is how many verified copies elsewhere a
        drop needs. ``faults`` is the returned incarnation's fault plan,
        ``net_faults`` its sites' network faults."""
        fs = FS(profile, clock, faults=faults)
        root = os.path.abspath(root)
        repro_dir = os.path.join(root, REPRO_DIR)
        for sub in ("objects", os.path.join("refs", "heads"), os.path.join("annex", "objects")):
            os.makedirs(os.path.join(repro_dir, sub), exist_ok=True)
        if isinstance(chunk_params, dict):
            chunk_params = ChunkParams.from_json(chunk_params)
        if chunk_threshold is not None and chunk_params is None:
            chunk_params = ChunkParams()
        cfg = {
            "dsid": dsid or str(uuid.uuid4()),
            "annex_threshold": annex_threshold,
            "annex_patterns": list(annex_patterns),
            "annex_remotes": [],
            "remotes": [],
            "numcopies": numcopies,
            "chunk_threshold": chunk_threshold,
            "chunk_params": chunk_params.to_json() if chunk_params else None,
        }
        write_atomic(fs, os.path.join(repro_dir, "config.json"), json.dumps(cfg).encode())
        write_atomic(fs, os.path.join(repro_dir, "HEAD"), b"main")
        return cls(root, fs, net_faults=net_faults)

    @classmethod
    def clone(cls, src: "Repository", dst_root: str, fs: FS | None = None) -> "Repository":
        """A clone of ``src`` at ``dst_root`` on ``fs`` (default: uncharged):
        the objects, loose and packed, the refs and HEAD; the origin's annex
        registered as ``remote0``, ``numcopies`` and the remote sites
        carried over; HEAD checked out. Annexed content stays behind: its
        files are pointers until ``annex_get`` (paper §2.3). Setting up the
        new repository is uncharged; every copy after it is charged on
        ``fs``, as the reference's clone is."""
        repo = cls.init(dst_root, annex_threshold=src.config["annex_threshold"],
                        annex_patterns=tuple(src.config.get("annex_patterns", ())), dsid=src.config["dsid"],
                        chunk_threshold=src.config.get("chunk_threshold"),
                        chunk_params=src.config.get("chunk_params"))
        if fs is not None:
            repo._rebind(fs)
        # every file through a tmp outside the shards and refs, where no
        # listing of objects or branches sees it
        for dirpath, _, files in os.walk(src.objects.root):
            rel = os.path.relpath(dirpath, src.objects.root)
            for f in files:
                repo._copy_in(os.path.join(dirpath, f), os.path.join(repo.objects.root, rel, f),
                              repo.objects.root)
        refs_src = os.path.join(src.repro_dir, "refs", "heads")
        for dirpath, _, files in os.walk(refs_src):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), refs_src)
                repo._copy_in(os.path.join(dirpath, f), repo._ref_path(rel), repo.repro_dir)
        repo._copy_in(os.path.join(src.repro_dir, "HEAD"), os.path.join(repo.repro_dir, "HEAD"), repo.repro_dir)
        repo.add_annex_remote(src.annex.root)
        repo.config["numcopies"] = src.config.get("numcopies", 1)
        repo._save_config()
        for r in src.config.get("remotes", []):
            repo.add_remote(r["root"], name=r["name"], net=r.get("net"))
        head = repo.head_commit()
        if head:
            repo.checkout(head)
        return repo

    def _rebind(self, fs: FS) -> None:
        """Move a new repository (no remote yet) and its stores onto ``fs``:
        a clone is set up uncharged and charged from then on."""
        self.fs, self.faults, self.token = fs, fs.faults, fs.token
        self.objects.fs = self.objects.packs.fs = self.annex.fs = fs

    def _copy_in(self, src: str, dst: str, tmp_dir: str) -> None:
        """Copy ``src`` to ``dst`` through a tmp in ``tmp_dir`` and a rename."""
        tmp = tmp_name(tmp_dir, self.fs.token)
        try:
            self.fs.copy_file(src, tmp)
            self.fs.rename(tmp, dst)
        except BaseException as e:
            if not is_crash(e):
                self.fs.unlink(tmp)
            raise

    @property
    def dsid(self) -> str:
        return self.config["dsid"]

    def write_file(self, relpath: str, data: bytes) -> None:
        """Publish a worktree file whole (its temporary file lies in
        ``.repro/``, where no staging sees it)."""
        write_atomic(self.fs, os.path.join(self.root, relpath), data, tmp_dir=self.repro_dir)

    def _save_config(self) -> None:
        write_atomic(self.fs, os.path.join(self.repro_dir, "config.json"), json.dumps(self.config).encode())

    def add_annex_remote(self, store_root: str) -> None:
        """Register a co-located annex store (a clone's origin) as
        ``remote<i>``, persisted in the config's ``annex_remotes``."""
        store_root = os.path.abspath(store_root)
        if store_root not in self.config["annex_remotes"]:
            self.config["annex_remotes"].append(store_root)
            self._save_config()
            self._remotes.append(AnnexStore(store_root, self.fs, name=f"remote{len(self._remotes)}",
                                            **self._store_kw()))

    def file_lock(self, name: str, ttl_s: float = 600.0) -> FileLock:
        """Cross-process advisory lock ``.repro/locks/<name>.lock``; a stale
        (dead-owner) lock is broken on acquire."""
        return FileLock(os.path.join(self.repro_dir, LOCKS_DIR, f"{name}.lock"), ttl_s=ttl_s, fs=self.fs)

    # -- crash points and the crash sweep ----------------------------------
    def crash_point(self, name: str) -> None:
        """A named phase boundary of the fault plan (no-op without one)."""
        self.fs.crash_point(name)

    def _tmp_dirs(self) -> list[str]:
        """Where this package's writers put tmp files: the annex store, the
        object store, ``.repro/`` (worktree files and refs) and the journal
        and lock directories."""
        return [self.annex.root, self.objects.root, self.repro_dir,
                os.path.join(self.repro_dir, "journal"), os.path.join(self.repro_dir, LOCKS_DIR)]

    def count_stale_tmps(self) -> int:
        return sum(len(stale_tmps(self.fs, d)) for d in self._tmp_dirs())

    def sweep_stale_tmps(self, max_age_s: float | None = 3600.0) -> int:
        """Unlink the tmp files of dead writers (dead pid or incarnation),
        or older than ``max_age_s``; returns the count swept."""
        return sum(sweep_stale_tmps(self.fs, d, max_age_s) for d in self._tmp_dirs())

    # -- refs ------------------------------------------------------------
    def _ref_path(self, branch: str) -> str:
        return os.path.join(self.repro_dir, "refs", "heads", branch)

    def current_branch(self) -> str:
        return self.fs.read_bytes(os.path.join(self.repro_dir, "HEAD")).decode().strip()

    def branch_head(self, branch: str) -> str | None:
        p = self._ref_path(branch)
        if not self.fs.exists(p):
            return None
        return self.fs.read_bytes(p).decode().strip()

    def branches(self) -> list[str]:
        d = os.path.join(self.repro_dir, "refs", "heads")
        return sorted(os.path.relpath(os.path.join(dirpath, f), d)
                      for dirpath, _, files in os.walk(d) for f in files)

    def head_commit(self) -> str | None:
        return self.branch_head(self.current_branch())

    def set_branch(self, branch: str, oid: str) -> None:
        write_atomic(self.fs, self._ref_path(branch), oid.encode(), tmp_dir=self.repro_dir)

    def create_branch(self, branch: str, at: str | None = None) -> None:
        at = at or self.head_commit()
        if at is None:
            raise ValueError("cannot branch from an empty repository")
        if self.fs.exists(self._ref_path(branch)):
            raise ValueError(f"branch exists: {branch}")
        self.set_branch(branch, at)

    def switch(self, branch: str, checkout: bool = True) -> None:
        """Make ``branch`` the current one and, with ``checkout``, write its
        tip to the worktree."""
        if not self.fs.exists(self._ref_path(branch)):
            raise ValueError(f"no such branch: {branch}")
        write_atomic(self.fs, os.path.join(self.repro_dir, "HEAD"), branch.encode())
        head = self.head_commit() if checkout else None
        if head:
            self.checkout(head)

    def resolve(self, commitish: str) -> str:
        """Branch name, full oid, or unique oid prefix (>= 4 hex) -> full oid."""
        if self.fs.exists(self._ref_path(commitish)):
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

    def _hash_working_file(self, relpath: str, single_pass: bool = True) -> dict:
        """Stage one worktree file: one stat decides; annex-sized files are
        ingested in one pass (hashed while written), the rest read whole.
        ``single_pass=False`` is the seed-era protocol: the whole file read
        into memory, then written (``finish(data_plane="legacy")``)."""
        abspath = os.path.join(self.root, relpath)
        if not single_pass:
            return self._entry_for_data(relpath, self.fs.read_bytes(abspath))
        size = self.fs.stat_size(abspath)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            chunked = self._should_chunk(size)
            return self._annex_entry(self.annex.ingest_file(abspath, chunked=chunked), chunked)
        return self._entry_for_data(relpath, self.fs.read_bytes(abspath))

    def hash_path_entry(self, relpath: str) -> dict:
        """The tree entry staging ``relpath`` would produce, computed
        read-only: no blob, no annex object is written (``rerun``'s bitwise
        check and the run cache's input keys)."""
        abspath = os.path.join(self.root, relpath)
        size = self.fs.stat_size(abspath)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            hx, sz = self.fs.hash_file(abspath)
            return self._annex_entry(make_annex_key(hx, sz), self._should_chunk(sz))
        data = self.fs.read_bytes(abspath)
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
        size = self.fs.stat_size(src)
        if size > POINTER_MAX and self._should_annex(relpath, size):
            chunked = self._should_chunk(size)
            entry = self._annex_entry(self.annex.ingest_file(src, chunked=chunked), chunked)
        else:
            entry = self._entry_for_data(relpath, self.fs.read_bytes(src))
        dst = os.path.join(self.root, relpath)
        try:
            self.fs.rename(src, dst)
        except OSError as e:
            if e.errno != errno.EXDEV:  # only cross-device falls back
                raise
            self.fs.copy_file(src, dst)
            self.fs.unlink(src)
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

    def stage_paths(self, paths, single_pass: bool = True) -> dict[str, dict]:
        """{relpath: tree entry} for ``paths`` (files or directories),
        writing blob and annex content as needed; ``single_pass=False``
        stages each file by the seed-era read-whole-then-write protocol."""
        return {rel: self._hash_working_file(rel, single_pass=single_pass)
                for rel in dict.fromkeys(self._expand_paths(paths))}

    # -- committing ------------------------------------------------------
    def commit_changes(
        self,
        changes: dict[str, dict | None],
        message: str = "",
        parents: list[str] | None = None,
        author: str = "repro",
        allow_empty: bool = False,
        base_commit: str | None = None,
        base_tree: str | None = None,
        spec: dict | None = None,
        defer: list | None = None,
    ) -> tuple[str, str | None]:
        """Apply ``changes`` on top of ``base_tree`` and write a commit whose
        parents are ``parents`` (default: ``base_commit``) and whose author
        line is ``author``; moves no ref. Returns ``(commit oid, tree
        oid)``, or the base commit when nothing changed and ``allow_empty``
        is false. ``spec`` (a RunSpec JSON dict) becomes the commit's
        ``spec`` field. With ``defer`` the commit is appended there instead
        of written: the caller writes the batch with
        ``objects.put_commits_packed`` before any ref names it."""
        tree_oid = self._update_tree(base_tree, changes)
        if tree_oid == base_tree and base_commit is not None and not allow_empty:
            return base_commit, base_tree
        commit = {
            "tree": tree_oid or "",
            "parents": parents if parents is not None else ([base_commit] if base_commit else []),
            "author": author,
            "timestamp": time.time(),
            "message": message,
        }
        if spec is not None:
            commit["spec"] = spec
        if defer is not None:
            defer.append(commit)
            return self.objects.oid_for("commit", canonical_json(commit)), tree_oid
        return self.objects.put_commit(commit), tree_oid

    def save(self, paths=None, message: str = "", parents: list[str] | None = None, author: str = "repro",
             allow_empty: bool = False, branch: str | None = None, engine: str = "incremental",
             spec: dict | None = None) -> str:
        """Stage ``paths`` (files or directories; None = the whole worktree,
        which also records tracked files that are gone) on top of the tip of
        ``branch`` (default: the current branch) and commit; moves that
        branch. Returns the commit oid. ``parents`` (default: the tip) and
        ``author`` go into the commit; with ``allow_empty`` a save that
        changes nothing still commits.

        ``engine="incremental"`` rebuilds only the dirty spine of the tree;
        ``engine="full"`` is the seed-era rebuild (``_save_full``). Both give
        the same tree oid for the same content."""
        if engine not in ("incremental", "full"):
            raise ValueError(f"unknown save engine: {engine!r}")
        branch = branch or self.current_branch()
        with self.ref_lock:
            base = self.branch_head(branch)
            if engine == "full":
                return self._save_full(paths, message, parents, author, allow_empty, branch, base, spec)
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
            oid, _ = self.commit_changes(changes, message=message, parents=parents, author=author,
                                         allow_empty=allow_empty, base_commit=base, base_tree=base_tree, spec=spec)
            if oid != base:
                self.set_branch(branch, oid)
            return oid

    def _save_full(self, paths, message: str, parents: list[str] | None, author: str, allow_empty: bool,
                   branch: str, base: str | None, spec: dict | None) -> str:
        """The seed-era save: read the whole base tree, apply the staged
        paths to its flat map, and write every tree object again
        (O(repository files)); moves ``branch`` when the tree changed."""
        flat = self.tree_of(base) if base else {}
        before = dict(flat)
        if paths is None:
            expanded = set(self._expand_paths(p for p in os.listdir(self.root) if not self._is_ignored(p)))
            for known in list(flat):
                if known not in expanded and not os.path.isfile(os.path.join(self.root, known)):
                    del flat[known]
            for rel in sorted(expanded):
                flat[rel] = self._hash_working_file(rel)
        else:
            for rel in self._expand_paths(paths):
                # a staged path shadows stale entries: an ancestor that was a
                # file, and whatever lay below a path that is a file now
                for pre in proper_prefixes(rel):
                    flat.pop(pre, None)
                for stale in [k for k in flat if k.startswith(rel + "/")]:
                    del flat[stale]
                flat[rel] = self._hash_working_file(rel)
        if flat == before and base is not None and not allow_empty:
            return base  # nothing changed: no commit
        commit = {
            "tree": self._write_nested(flat) or "",
            "parents": parents if parents is not None else ([base] if base else []),
            "author": author,
            "timestamp": time.time(),
            "message": message,
        }
        if spec is not None:
            commit["spec"] = spec
        oid = self.objects.put_commit(commit)
        self.set_branch(branch, oid)
        return oid

    def _write_nested(self, flat: dict[str, dict]) -> str | None:
        """Write the tree objects of a flat {relpath: entry} map, every
        level of them; returns the root tree's oid (None when empty)."""
        if not flat:
            return None
        root: dict = {}
        for path, entry in flat.items():
            parts = path.split("/")
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
                if "_entry" in node:
                    raise ConflictError(f"file/directory conflict at {part} in {path}")
            node[parts[-1]] = {"_entry": entry}

        def emit(node: dict) -> str:
            return self.objects.put_tree({name: child["_entry"] if "_entry" in child
                                          else {"t": "tree", "oid": emit(child)}
                                          for name, child in sorted(node.items())})

        return emit(root)

    def merge_octopus(self, branches: list[str], message: str = "", author: str = "repro") -> str:
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
                "author": author,
                "timestamp": time.time(),
                "message": message or f"octopus merge of {len(branches)} branches",
            }
            oid = self.objects.put_commit(commit)
            self.set_branch(branch, oid)
            if merged:
                self.checkout(oid, paths=sorted(merged))
            return oid

    # -- checkout --------------------------------------------------------
    def _collect_tree_paths(self, tree_oid: str, prefix: str, targets: list[str], out: dict[str, dict]) -> None:
        """Collect ``{relpath: entry}`` of every file at or below one of
        ``targets``, descending only into directories on a target's spine
        (targets grouped by their first component at each level)."""
        whole: set[str] = set()  # names whose whole subtree is targeted
        groups: dict[str, list[str]] = {}  # name -> the deeper targets within it
        for t in targets:
            name, sep, rest = t.partition("/")
            if sep:
                groups.setdefault(name, []).append(rest)
            else:
                whole.add(name)
        collect_all = "" in whole  # this whole subtree is targeted
        for name, entry in self.objects.get_tree(tree_oid).items():
            p = prefix + name
            if entry["t"] == "tree":
                if collect_all or name in whole:
                    self._collect_tree_paths(entry["oid"], p + "/", [""], out)
                elif name in groups:
                    self._collect_tree_paths(entry["oid"], p + "/", groups[name], out)
            elif collect_all or name in whole:
                out[p] = entry

    def checkout(self, commitish: str, paths: list[str] | None = None) -> None:
        """Write a commit's files (or those at and below ``paths``) to the
        worktree: blobs, annexed content where the local annex holds it,
        else pointer files (content on a remote needs ``annex_get``)."""
        oid = self.resolve(commitish)
        if paths is None:
            targets = self.tree_of(oid)
        else:
            targets = {}
            tree_oid = self._tree_oid_of(oid)
            if tree_oid:
                self._collect_tree_paths(tree_oid, "", [t.rstrip("/") for t in paths], targets)
        for relpath, entry in targets.items():
            self.materialize(relpath, entry)

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
    def annex_key_at(self, path: str, commitish: str | None = None) -> str:
        oid = self.resolve(commitish) if commitish else self.head_commit()
        if oid is None:
            raise KeyError("empty repository")
        entry = self.entry_at(oid, path)
        if entry is None or entry["t"] != "annex":
            raise KeyError(f"{path} is not an annexed file")
        return entry["key"]

    def whereis(self, key: str) -> list[str]:
        """Names of the stores holding ``key`` (the local store first), by
        each store's own probe; a site marked unavailable is skipped."""
        return [s.name for s in [self.annex, *self._remotes] if getattr(s, "available", True) and s.has(key)]

    def whereis_many(self, keys: list[str], fresh: bool = False) -> dict[str, list[str]]:
        """{key: names of the stores holding it}: one ``has_many`` per store
        (the known-key sets first, unless ``fresh``), never a listing. A
        site marked unavailable is skipped: it can neither confirm nor deny
        a copy."""
        stores = [s for s in [self.annex, *self._remotes] if getattr(s, "available", True)]
        present = {s.name: s.has_many(keys, fresh=fresh) for s in stores}
        return {key: [s.name for s in stores if key in present[s.name]] for key in keys}

    def annex_fetch_key(self, key: str, chunked: bool = False) -> AnnexStore:
        """The local store, after fetching ``key`` into it if it is not
        there (a fresh probe: a key dropped behind this store's back is
        fetched, not read from a stale cache). A chunked object moves as a
        delta: only the chunks the local store lacks; ``chunked`` asks even
        a store that is not chunk-aware for the key's manifest. The sites
        are asked in order; one that is down or errors past its retries is
        marked unavailable and the next is asked (ROADMAP.md §C7: the
        reference raises there). Raises when no site can serve the key."""
        if self.annex.has(key, fresh=True):
            return self.annex
        report = {"retries": 0, "failovers": 0, "chunks_fetched": 0}
        if fetch_one(self, key, self._remotes, report, chunked=chunked) is None:
            raise FileNotFoundError(f"no store has {key}")
        return self.annex

    def annex_get(self, path: str) -> bool:
        """Give the worktree file at ``path`` its content if it is a pointer
        (datalad get), fetching the key from a site if it is not local.
        Returns True if it was a pointer."""
        parsed = parse_pointer_full(self.fs.read_bytes(os.path.join(self.root, path)))
        if parsed is None:
            return False  # already content
        key, chunked = parsed
        self.annex_fetch_key(key, chunked=chunked)
        self.annex.copy_to(key, os.path.join(self.root, path), tmp_dir=self.repro_dir)
        return True

    # -- remote sites (DESIGN.md §13) -------------------------------------
    def add_remote(self, store_root: str, name: str | None = None, net=None) -> RemoteStore:
        """Register a remote site: an annex store at ``store_root`` reached
        over a link (``"lan"``, ``"wan"``, a :class:`~.remote.NetProfile` or
        its dict). Persisted in the config, so every later session rebuilds
        the same list of sites."""
        store_root = os.path.abspath(store_root)
        net = coerce_net(net)
        existing = {r["name"] for r in self.config.setdefault("remotes", [])}
        if name is None:
            i = len(existing)
            while f"site{i}" in existing:
                i += 1
            name = f"site{i}"
        elif name in existing:
            raise ValueError(f"remote {name!r} already configured")
        self.config["remotes"].append({"name": name, "root": store_root, "net": net.to_json()})
        self._save_config()
        store = self._site(store_root, name, net)
        self._remotes.append(store)
        return store

    def remote_by_name(self, name: str) -> AnnexStore:
        for s in self._remotes:
            if s.name == name:
                return s
        raise KeyError(f"no remote named {name!r}")

    @property
    def remote_stores(self) -> list[RemoteStore]:
        """The network sites (not the co-located stores, which never fault)."""
        return [s for s in self._remotes if isinstance(s, RemoteStore)]

    @property
    def numcopies(self) -> int:
        """How many verified copies elsewhere a drop of the local copy needs."""
        return int(self.config.get("numcopies", 1))

    def verified_copies(self, key: str) -> list[str]:
        """The sites holding ``key`` by a fresh probe now (one batched round
        trip each, never the known-key set: a cached positive can be stale).
        A site that is unavailable or errors past its retries confirms
        nothing."""
        confirmed = []
        for s in self._remotes:
            if isinstance(s, RemoteStore) and not s.available:
                continue
            try:
                if key in net_retry(s, lambda s=s: s.has_many([key], fresh=True)):
                    confirmed.append(s.name)
            except (InjectedNetworkError, RemoteUnavailable):
                continue
        return confirmed

    def annex_drop(self, path: str, force: bool = False) -> None:
        """Replace the worktree file at ``path`` by its pointer and drop the
        local copy; refused unless ``numcopies`` sites hold it by
        :meth:`verified_copies` (or ``force``)."""
        abspath = os.path.join(self.root, path)
        data = self.fs.read_bytes(abspath)
        parsed = parse_pointer_full(data)
        key = parsed[0] if parsed is not None else annex_key_for_bytes(data)
        need = self.numcopies
        others = self.verified_copies(key)
        if len(others) < need and not force:
            raise RuntimeError(
                f"refusing to drop {path} ({key}): {len(others)} verified "
                f"cop{'y' if len(others) == 1 else 'ies'} elsewhere "
                f"({', '.join(others) or 'none'}), numcopies={need}; use force=True")
        chunked = False
        if self.annex.chunk_aware and self.annex.has(key):
            chunked = self.annex.manifest_of(key) is not None
        self.write_file(path, make_pointer(key, chunked=chunked))
        if self.annex.has(key):
            # a chunked drop removes the manifest; its chunks stay (gc)
            self.annex.drop(key)

    def annex_push(self, store: AnnexStore, keys: list[str] | None = None) -> int:
        """Copy local annex content to ``store`` (datalad push): ``keys``
        (default: every local key) that the local store holds and ``store``
        lacks, by one ``has_many`` on each side; a chunked object moves only
        the chunks ``store`` lacks, then its manifest. Not journaled (the
        journaled, resumable push to a site is ``Session.push``). Returns
        the number of keys copied."""
        if keys is None:
            keys = self.annex.keys()
        local = self.annex.has_many(keys)
        remote = store.has_many(keys)
        n = 0
        for key in keys:
            if key not in local or key in remote:
                continue
            chunks = self.annex.manifest_of(key) if self.annex.chunk_aware else None
            if chunks is not None:
                remote_chunks = store.has_many(chunks)
                for ck in chunks:
                    if ck not in remote_chunks:
                        store.receive_file(ck, self.annex.fs, self.annex._path(ck))
                        remote_chunks.add(ck)
                store.put_manifest(key, chunks)
            else:
                store.receive_file(key, self.annex.fs, self.annex._path(key))
            n += 1
        return n

    # -- lock/unlock -----------------------------------------------------
    def unlock(self, path: str) -> None:
        abspath = os.path.join(self.root, path)
        if os.path.exists(abspath):
            self.fs.chmod_readonly(abspath, readonly=False)

    def lock(self, path: str) -> None:
        abspath = os.path.join(self.root, path)
        if os.path.exists(abspath):
            self.fs.chmod_readonly(abspath, readonly=True)
