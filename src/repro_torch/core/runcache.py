"""Run cache: content-addressed memoization of RunSpec executions (§11; port
of ``repro.core.runcache``, the same execution keys and ``runcache`` rows).

An execution is a pure function of its content-addressed inputs:
``spec_id`` plus the tree entries of every resolved input determine the
outputs. The key's environment fingerprint is the reference's default, the
empty string: the port keys no environment. This module derives that
**execution key**; the jobdb ``runcache`` table maps it to the recorded
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

import os

from .repo import REPRO_DIR
from .spec import RunSpec


class RunCache:
    """Execution-key derivation for the jobdb ``runcache`` table."""

    def __init__(self, repo):
        self.repo = repo
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
        return spec.execution_key(entries)

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
