"""Output-conflict detection: protected names N and prefixes P (paper §5.5;
port of ``repro.core.conflicts``).

A job's output specification (files or exclusive directories) is checked
against the outputs of all *currently scheduled* jobs. With the path
normalized relative to the repository root:

    (1) name ∈ N                      -> conflict (same output claimed twice)
    (2) name ∈ P                      -> conflict (claims a super-directory of
                                          another job's output)
    (3) any proper prefix of name ∈ N -> conflict (a super-directory is
                                          already claimed exclusively)

If no check fires, ``name`` joins N and all its proper prefixes join P.
This is O(depth) per output with hash sets — the feasibility answer to the
regex-intersection problem that rules out wildcards (§5.4, citing
Backurs & Indyk 2016).
"""
from __future__ import annotations

import posixpath

WILDCARD_CHARS = set("*?[]{}")


class OutputConflict(Exception):
    def __init__(self, name: str, reason: str, other_job: int | None = None):
        self.name = name
        self.reason = reason
        self.other_job = other_job
        job = f" (held by job {other_job})" if other_job is not None else ""
        super().__init__(f"output conflict on {name!r}: {reason}{job}")


class WildcardOutputError(ValueError):
    def __init__(self, name: str):
        super().__init__(
            f"wildcard patterns are not allowed in output specifications: {name!r} "
            "(paper §5.4: potential-conflict matching between regular expressions "
            "is infeasible)"
        )


def has_wildcard(name: str) -> bool:
    return any(c in WILDCARD_CHARS for c in name)


def normalize(name: str) -> str:
    """Normalize to a repo-root-relative posix path without '..' or trailing /."""
    name = name.replace("\\", "/")
    norm = posixpath.normpath(name)
    if norm.startswith("/"):
        norm = norm.lstrip("/")
    if norm.startswith("..") or norm in (".", ""):
        raise ValueError(f"output path escapes the repository or is empty: {name!r}")
    return norm


def proper_prefixes(name: str) -> list[str]:
    """All non-trivial super-directories, e.g. 'a/b/c' -> ['a/b', 'a']."""
    out = []
    parts = name.split("/")
    for i in range(len(parts) - 1, 0, -1):
        out.append("/".join(parts[:i]))
    return out


def check_intra_job(normed: list[str]) -> None:
    """Reject two outputs of the same job that are equal or nested (used by
    both the in-memory N/P sets and the job database's indexed checks).
    O(outputs x depth): each output's proper prefixes are probed against the
    full set, which catches nesting in either listing order."""
    seen = set(normed)
    if len(seen) != len(normed):
        dup = next(n for n in normed if normed.count(n) > 1)
        raise OutputConflict(dup, "listed twice in the same job")
    for n in normed:
        for pre in proper_prefixes(n):
            if pre in seen:
                raise OutputConflict(n, f"nested under sibling output {pre!r}")


class ProtectedOutputs:
    """In-memory N/P sets with the three §5.5 checks.

    ``owners`` maps a protected name (in N) to the owning job id so conflicts
    can report who holds the claim. The persistent counterpart lives in the
    job database (:mod:`.jobdb`); this class is also used standalone
    in tests and benchmarks.
    """

    def __init__(self) -> None:
        self.names: dict[str, int] = {}  # N: name -> owning job
        self.prefixes: dict[str, set[int]] = {}  # P: prefix -> jobs using it

    def check(self, name: str) -> None:
        """Raise OutputConflict if ``name`` conflicts; no mutation."""
        name = normalize(name)
        if has_wildcard(name):
            raise WildcardOutputError(name)
        if name in self.names:  # check (1)
            raise OutputConflict(name, "already protected", self.names[name])
        if name in self.prefixes:  # check (2)
            other = next(iter(self.prefixes[name]))
            raise OutputConflict(
                name, "is a super-directory of another job's output", other
            )
        for pre in proper_prefixes(name):  # check (3)
            if pre in self.names:
                raise OutputConflict(
                    name,
                    f"super-directory {pre!r} is claimed exclusively",
                    self.names[pre],
                )

    def add(self, name: str, job_id: int) -> None:
        name = normalize(name)
        self.names[name] = job_id
        for pre in proper_prefixes(name):
            self.prefixes.setdefault(pre, set()).add(job_id)

    def check_and_add_all(self, names: list[str], job_id: int) -> list[str]:
        """Atomically check every output, then protect all of them. Also
        rejects intra-job conflicts (two outputs of the same job nesting)."""
        normed = [normalize(n) for n in names]
        for n in normed:
            self.check(n)
        check_intra_job(normed)
        for n in normed:
            self.add(n, job_id)
        return normed

    def release(self, job_id: int) -> None:
        self.names = {n: j for n, j in self.names.items() if j != job_id}
        for pre in list(self.prefixes):
            self.prefixes[pre].discard(job_id)
            if not self.prefixes[pre]:
                del self.prefixes[pre]
