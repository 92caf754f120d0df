"""Run cache: content-addressed memoization of RunSpec executions (§11; port
of ``repro.core.runcache``, the same execution keys and ``runcache`` rows).

An execution is a pure function of its content-addressed inputs:
``spec_id`` plus the tree entries of every resolved input, plus a
fingerprint of the environment the caller deems result-relevant
(``cache_env``: on an HPC machine the module stack or container digest; on
a GPU node also the card, its power limit, torch and CUDA), determine the
outputs. With no ``cache_env`` the fingerprint is the empty string, so the
key is the one a cache without environments derives. This module derives
that **execution key**; the jobdb ``runcache`` table maps it to the recorded
result: the output tree, the provenance commit, and the annex keys it
references. ``SlurmScheduler.submit_many`` consults the table before
sbatch; hits short-circuit into a memoized provenance commit while only
novel specs reach Slurm. A row is written once per finished job by the
batched finish.

Deriving a key reads each input file once (``Repository.hash_path_entry``);
a per-process stat memo reuses the entry while the file's ``(size,
mtime_ns)`` is unchanged, so a sweep over a shared input set hashes each
input once, not once per spec.
"""
from __future__ import annotations

import json
import os

from .hashing import sha256_bytes
from .repo import REPRO_DIR
from .spec import RunSpec


def env_fingerprint(cache_env: dict | None) -> str:
    """The reference's fingerprint of ``cache_env``: sha256 of its canonical
    JSON (keys and values as strings, sorted, no spaces); ``""`` for None or
    an empty dict, which leaves execution keys as they are without one."""
    if not cache_env:
        return ""
    canon = json.dumps({str(k): str(v) for k, v in cache_env.items()}, sort_keys=True, separators=(",", ":"))
    return sha256_bytes(canon.encode())


class RunCache:
    """Execution-key derivation for the jobdb ``runcache`` table."""

    def __init__(self, repo, cache_env: dict | None = None):
        self.repo = repo
        self.env_fp = env_fingerprint(cache_env)
        # rel -> ((st_size, st_mtime_ns), tree entry)
        self._entry_memo: dict[str, tuple[tuple[int, int], dict]] = {}

    # ------------------------------------------------------ key derivation
    def execution_key(self, spec: RunSpec) -> str | None:
        """The execution key for submitting ``spec`` now, or ``None`` when
        an input cannot be resolved (missing literal, unreadable file) —
        unresolvable specs are simply uncacheable and submit as novel."""
        entries = self.input_entries(spec)
        if entries is None:
            return None
        return spec.execution_key(entries, self.env_fp)

    def execution_keys(self, specs: list[RunSpec]) -> list[str | None]:
        return [self.execution_key(s) for s in specs]

    def input_entries(self, spec: RunSpec) -> list[tuple[str, dict]] | None:
        """Resolved ``(relpath, tree entry)`` pairs for every input file of
        ``spec`` (directories walk to their files), or ``None`` if any
        input is unresolvable."""
        try:
            rels = spec.expand_inputs(self.repo.root)
        except (FileNotFoundError, OSError):
            return None
        out: list[tuple[str, dict]] = []
        for rel in dict.fromkeys(rels):
            files = self._files_under(rel)
            if files is None:
                return None
            for f in files:
                entry = self._entry(f)
                if entry is None:
                    return None
                out.append((f, entry))
        return out

    def _files_under(self, rel: str) -> list[str] | None:
        abspath = os.path.join(self.repo.root, rel)
        if os.path.isdir(abspath):
            found: list[str] = []
            for dirpath, dirnames, files in os.walk(abspath):
                dirnames[:] = sorted(d for d in dirnames if d != REPRO_DIR)
                for f in sorted(files):
                    found.append(
                        os.path.relpath(os.path.join(dirpath, f), self.repo.root)
                    )
            return found
        if os.path.isfile(abspath):
            return [rel]
        return None

    def _entry(self, rel: str) -> dict | None:
        abspath = os.path.join(self.repo.root, rel)
        try:
            st = os.stat(abspath)
        except OSError:
            return None
        sig = (st.st_size, st.st_mtime_ns)
        memo = self._entry_memo.get(rel)
        if memo is not None and memo[0] == sig:
            return memo[1]
        try:
            entry = self.repo.hash_path_entry(rel)
        except (OSError, ValueError):
            return None
        self._entry_memo[rel] = (sig, entry)
        return entry

    # ------------------------------------------------------------- fsck
    def check(self, db) -> list[tuple[dict, str]]:
        """Fsck the job database ``db``'s index without changing it: each
        row's commit must exist in the object store and each of its annex
        keys must be located. Returns ``(row, reason)`` per broken row."""
        rows = db.cache_rows()
        if not rows:
            return []
        union = sorted({k for r in rows for k in r["annex_keys"]})
        located = self.repo.whereis_many(union) if union else {}
        broken: list[tuple[dict, str]] = []
        for r in rows:
            if not self.repo.objects.has(r["commit_oid"]):
                broken.append((r, f"missing commit {r['commit_oid'][:12]}"))
                continue
            lost = [k for k in r["annex_keys"] if not located.get(k)]
            if lost:
                broken.append((r, f"missing annex objects: {lost}"))
        return broken

    def evict_missing(self, db) -> list[str]:
        """Drop ``db``'s rows whose recorded commit or annex objects no longer
        exist (``Session.gc``), so the cache never serves a hit it cannot
        materialise. Returns the evicted keys."""
        bad = [r["exec_key"] for r, _ in self.check(db)]
        db.cache_evict(bad)
        return bad
